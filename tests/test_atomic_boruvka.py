"""JAX atomic path vs sequential oracle: exact-equivalence differential tests
(the rebuild's formalization of the reference's cross-implementation
validation, SURVEY.md §4.2-4.3), plus determinism and hierarchy invariants."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gseg.config import SegmentationConfig
from gseg.models.atomic_boruvka import (
    segment_atomic,
    segment_atomic_hierarchy,
    segment_atomic_hostsync,
)
from gseg.models.boruvka_cpu import segment_boruvka_np
from gseg.utils.labels import num_components
from gseg.utils.synthetic import blobs_image, checkerboard_image, gradient_image


CASES = [
    dict(h=24, w=32, k=100.0, min_size=8, connectivity=8, seed=0),
    dict(h=33, w=17, k=300.0, min_size=20, connectivity=8, seed=1),
    dict(h=16, w=16, k=50.0, min_size=1, connectivity=4, seed=2),
    dict(h=1, w=37, k=100.0, min_size=5, connectivity=8, seed=3),
    dict(h=40, w=8, k=150.0, min_size=2, connectivity=8, seed=4),
]


@pytest.mark.parametrize("case", CASES)
def test_exact_match_vs_oracle(case):
    cfg = SegmentationConfig(
        k=case["k"], min_size=case["min_size"], connectivity=case["connectivity"]
    )
    img = blobs_image(case["h"], case["w"], 5, 6.0, case["seed"])
    expected = segment_boruvka_np(img, cfg)
    got = np.asarray(segment_atomic(jnp.asarray(img), cfg))
    assert np.array_equal(expected, got)


def test_quantized_weights_match_oracle(small_image):
    cfg = SegmentationConfig(k=100.0, min_size=8, quantize_weight_bits=12)
    expected = segment_boruvka_np(small_image, cfg)
    got = np.asarray(segment_atomic(jnp.asarray(small_image), cfg))
    assert np.array_equal(expected, got)


def test_hostsync_equals_device_loop(small_image, small_cfg):
    a = np.asarray(segment_atomic_hostsync(small_image, small_cfg))
    b = np.asarray(segment_atomic(jnp.asarray(small_image), small_cfg))
    assert np.array_equal(a, b)


def test_deterministic_across_runs(small_image, small_cfg):
    x = jnp.asarray(small_image)
    a = np.asarray(segment_atomic(x, small_cfg))
    b = np.asarray(segment_atomic(x, small_cfg))
    assert np.array_equal(a, b)


def test_vmap_matches_single(small_cfg):
    imgs = np.stack([blobs_image(24, 32, 5, 6.0, s) for s in range(3)])
    batched = jax.vmap(lambda im: segment_atomic(im, small_cfg))(
        jnp.asarray(imgs)
    )
    for i in range(3):
        single = segment_atomic(jnp.asarray(imgs[i]), small_cfg)
        assert np.array_equal(np.asarray(single), np.asarray(batched[i]))


def test_hierarchy_levels_nest(small_image, small_cfg):
    levels, final = segment_atomic_hierarchy(jnp.asarray(small_image), small_cfg)
    levels = np.asarray(levels)
    # each level is a coarsening of the previous: fine component -> exactly
    # one coarse component
    for i in range(levels.shape[0] - 1):
        fine = levels[i].ravel()
        coarse = levels[i + 1].ravel()
        # group coarse by fine root: all pixels sharing a fine label must
        # share a coarse label
        order = np.argsort(fine, kind="stable")
        f, c = fine[order], coarse[order]
        starts = np.r_[True, f[1:] != f[:-1]]
        grp = np.cumsum(starts) - 1
        first_c = c[starts][grp]
        assert np.array_equal(c, first_c)
    # final level of the felz phase matches oracle pre-min-size run count
    expected = segment_boruvka_np(np.asarray(small_image), small_cfg)
    assert np.array_equal(expected, np.asarray(final))


def test_trivial_images():
    cfg = SegmentationConfig(k=10.0, min_size=1)
    flat = np.full((8, 12, 3), 99, np.uint8)
    assert num_components(np.asarray(segment_atomic(jnp.asarray(flat), cfg))) == 1
    grad = gradient_image(12, 12)
    cfg2 = SegmentationConfig(k=2000.0, min_size=1)
    assert num_components(np.asarray(segment_atomic(jnp.asarray(grad), cfg2))) == 1


def test_checkerboard_edges_respected():
    img = checkerboard_image(24, 24, cell=6)
    cfg = SegmentationConfig(sigma=0.1, k=5.0, min_size=1)
    labels = np.asarray(segment_atomic(jnp.asarray(img), cfg))
    for y in range(0, 24, 6):
        for x in range(0, 24, 6):
            assert np.unique(labels[y : y + 6, x : x + 6]).size == 1
