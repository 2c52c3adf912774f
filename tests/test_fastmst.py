"""FastMST/DPP path vs sequential oracle (exact label equality — same merge
semantics as the atomic path, different parallel schedule), plus hierarchy
and superpixel invariants."""

import numpy as np
import pytest

import jax.numpy as jnp

from gseg.config import SegmentationConfig
from gseg.models.atomic_boruvka import segment_atomic
from gseg.models.boruvka_cpu import segment_boruvka_np
from gseg.models.fastmst import segment_fastmst, segment_fastmst_hierarchy
from gseg.models.superpixel import (
    segment_superpixel,
    segment_superpixel_hierarchy,
)
from gseg.utils.labels import num_components
from gseg.utils.synthetic import blobs_image


CASES = [
    dict(h=24, w=32, k=100.0, min_size=8, seed=0),
    dict(h=33, w=17, k=300.0, min_size=20, seed=1),
    dict(h=16, w=16, k=50.0, min_size=1, seed=2),
]


@pytest.mark.parametrize("case", CASES)
def test_exact_match_vs_oracle(case):
    cfg = SegmentationConfig(k=case["k"], min_size=case["min_size"])
    img = blobs_image(case["h"], case["w"], 5, 6.0, case["seed"])
    expected = segment_boruvka_np(img, cfg)
    got = np.asarray(segment_fastmst(jnp.asarray(img), cfg))
    assert np.array_equal(expected, got)


def test_matches_atomic_path(small_image, small_cfg):
    a = np.asarray(segment_atomic(jnp.asarray(small_image), small_cfg))
    b = np.asarray(segment_fastmst(jnp.asarray(small_image), small_cfg))
    assert np.array_equal(a, b)


def test_hierarchy_levels_nest_and_finish(small_image, small_cfg):
    levels, final = segment_fastmst_hierarchy(
        jnp.asarray(small_image), small_cfg
    )
    levels = np.asarray(levels)
    counts = [np.unique(levels[i]).size for i in range(levels.shape[0])]
    # level 0 = singletons; counts never increase
    assert counts[0] == small_image.shape[0] * small_image.shape[1]
    assert all(a >= b for a, b in zip(counts, counts[1:]))
    expected = segment_boruvka_np(np.asarray(small_image), small_cfg)
    assert np.array_equal(expected, np.asarray(final))


def test_superpixel_hierarchy_collapses():
    img = blobs_image(24, 32, 4, 5.0, 0)
    cfg = SegmentationConfig(k=100.0, min_size=1, max_iters=16)
    levels, final = segment_superpixel_hierarchy(jnp.asarray(img), cfg)
    levels = np.asarray(levels)
    counts = [np.unique(levels[i]).size for i in range(levels.shape[0])]
    # pure-Boruvka rounds: strictly merging until a single superpixel
    assert counts[0] == 24 * 32
    assert all(a >= b for a, b in zip(counts, counts[1:]))
    assert counts[-1] == 1
    assert num_components(np.asarray(final)) == 1


def test_superpixel_level_selection():
    img = blobs_image(24, 32, 4, 5.0, 1)
    cfg = SegmentationConfig(k=100.0, min_size=1, hierarchy_levels=3,
                             max_iters=16)
    labels = np.asarray(segment_superpixel(jnp.asarray(img), cfg))
    levels, _ = segment_superpixel_hierarchy(jnp.asarray(img), cfg)
    assert np.array_equal(labels, np.asarray(levels)[3])


def test_runout_slice_matches_full_pool(monkeypatch):
    """The run-out rounds' live-count slice (GSEG_S2_SMALL) must produce
    byte-identical labels to the full-capacity branch and the oracle —
    the recompacted pool is front-compacted, so slicing is lossless once
    every live pair fits. Image sized so v/4 exceeds the 16384 floor and
    the cond is actually present."""
    import jax

    from gseg.models.fastmst import segment_fastmst_flagged

    img = blobs_image(260, 300, num_blobs=8, noise=8.0, seed=5)
    cfg = SegmentationConfig(k=150.0, min_size=20)
    outs = {}
    for sm in ("1", "0"):
        monkeypatch.setenv("GSEG_S2_SMALL", sm)
        jax.clear_caches()
        lab, fl = segment_fastmst_flagged(jnp.asarray(img), cfg)
        assert int(fl) == 0
        outs[sm] = np.asarray(lab)
    monkeypatch.undo()
    jax.clear_caches()
    expected = segment_boruvka_np(img, cfg)
    assert np.array_equal(outs["1"], outs["0"])
    assert np.array_equal(outs["1"], expected)
