"""NumPy DPP prototypes (P3-P5 rebuilds) vs the Boruvka oracle and the JAX
models — the prototypes are executable specifications, so every pair must
agree."""

import numpy as np
import jax.numpy as jnp

from gseg.config import SegmentationConfig
from gseg.models.boruvka_cpu import segment_boruvka_np
from gseg.models.fastmst import segment_fastmst
from gseg.models.fastmst_np import segment_fastmst_np, superpixel_hierarchy_np
from gseg.models.superpixel import segment_superpixel_hierarchy
from gseg.utils.labels import canonical_min_labels_np
from gseg.utils.synthetic import blobs_image


def test_fastmst_np_matches_oracle(small_image, small_cfg):
    a = segment_boruvka_np(small_image, small_cfg)
    b = segment_fastmst_np(small_image, small_cfg)
    assert np.array_equal(a, b)


def test_fastmst_np_matches_jax(small_image, small_cfg):
    a = np.asarray(segment_fastmst(jnp.asarray(small_image), small_cfg))
    b = segment_fastmst_np(small_image, small_cfg)
    assert np.array_equal(a, b)


def test_hierarchy_levels_match_jax():
    from gseg.models.fastmst import segment_fastmst_hierarchy

    cfg = SegmentationConfig(k=100.0, min_size=8, max_iters=16)
    img = blobs_image(24, 32, 4, 5.0, 2)
    np_levels, np_final = segment_fastmst_np(img, cfg, return_levels=True)
    jx_levels, jx_final = segment_fastmst_hierarchy(jnp.asarray(img), cfg)
    assert np.array_equal(np_final, np.asarray(jx_final))
    # prototype stores levels until its own convergence; the jax variant
    # pads to max_iters — compare the shared prefix.
    jx_levels = np.asarray(jx_levels)
    for i in range(np_levels.shape[0]):
        assert np.array_equal(np_levels[i], jx_levels[i])


def test_superpixel_np_partitions_match_jax():
    cfg = SegmentationConfig(k=100.0, min_size=1, max_iters=16)
    img = blobs_image(20, 24, 4, 5.0, 3)
    np_levels, _ = superpixel_hierarchy_np(img, cfg)
    jx_levels, _ = segment_superpixel_hierarchy(jnp.asarray(img), cfg)
    jx_levels = np.asarray(jx_levels)
    for i in range(min(np_levels.shape[0], jx_levels.shape[0])):
        assert np.array_equal(
            canonical_min_labels_np(np_levels[i]),
            canonical_min_labels_np(jx_levels[i]),
        )
