"""Primitive/op-layer tests: filters, implicit grid graph, scatter-min,
pointer doubling, compaction."""

import numpy as np
import jax.numpy as jnp
import scipy.ndimage

from gseg.ops import filters, grid_graph as gg
from gseg.ops.primitives import (
    INT32_MAX,
    compact_indices,
    component_min_edge,
    pointer_double,
    remove_mutual_hooks,
)


def test_gaussian_matches_scipy():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (20, 24)).astype(np.float32)
    ours = np.asarray(filters.gaussian_smooth(jnp.asarray(img), 1.2))
    ref = scipy.ndimage.gaussian_filter(
        img, 1.2, truncate=np.ceil(4 * 1.2) / 1.2, mode="nearest"
    )
    assert np.allclose(ours, ref, atol=1e-3)


def test_gaussian_preserves_mean_interior():
    img = np.full((16, 16), 50.0, np.float32)
    out = np.asarray(filters.gaussian_smooth(jnp.asarray(img), 0.8))
    assert np.allclose(out, 50.0, atol=1e-4)


def test_sobel_flat_is_zero():
    img = np.full((12, 12, 3), 80, np.uint8)
    out = np.asarray(filters.sobel_magnitude(jnp.asarray(img)))
    assert np.allclose(out[1:-1, 1:-1], 0.0, atol=1e-4)


def test_sobel_detects_vertical_edge():
    img = np.zeros((12, 12), np.float32)
    img[:, 6:] = 255.0
    out = np.asarray(filters.sobel_magnitude(jnp.asarray(img)))
    assert out[5, 5] > 100.0
    assert np.allclose(out[5, 1:4], 0.0, atol=1e-4)


def test_edge_weights_match_manual():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 255, (5, 7, 3)).astype(np.float32)
    w, valid = gg.edge_weight_planes(jnp.asarray(img))
    w, valid = np.asarray(w), np.asarray(valid)
    # E edge at (2,3): distance between (2,3) and (2,4)
    expected = np.sqrt(np.sum((img[2, 3] - img[2, 4]) ** 2))
    assert np.isclose(w[0, 2, 3], expected, rtol=1e-6)
    # NE edge at (1,0): neighbor (2,-1) out of bounds
    assert not valid[3, 1, 0] and np.isinf(w[3, 1, 0])
    # S edges in last row invalid
    assert not valid[1, 4].any()


def test_incident_views_symmetry():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (6, 6, 3)).astype(np.float32)
    w, _ = gg.edge_weight_planes(jnp.asarray(img))
    w8, eid8 = [np.asarray(x) for x in gg.incident_views(w)]
    # edge E at (3,2) seen from (3,2) dir 0 and from (3,3) dir 4 (reverse)
    assert w8[0, 3, 2] == w8[4, 3, 3]
    assert eid8[0, 3, 2] == eid8[4, 3, 3]
    vid = 3 * 6 + 2
    assert eid8[0, 3, 2] == vid * 4 + 0


def test_edge_list_eid_convention():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (4, 5, 3)).astype(np.float32)
    w, valid = gg.edge_weight_planes(jnp.asarray(img))
    src, dst, wt, va = [np.asarray(x) for x in gg.edge_list(w, valid)]
    offs = gg.flat_offsets(5)
    for eid in np.nonzero(va)[0]:
        assert src[eid] == eid // 4
        assert dst[eid] == src[eid] + offs[eid % 4]


def test_pointer_double_chain():
    # chain 0<-1<-2<-...<-9
    parent = jnp.asarray(np.r_[0, np.arange(9)], dtype=jnp.int32)
    flat = np.asarray(pointer_double(parent))
    assert np.array_equal(flat, np.zeros(10, dtype=np.int32))


def test_component_min_edge_ties_to_min_eid():
    roots = jnp.asarray([0, 0, 0, 3], dtype=jnp.int32)
    vminw = jnp.asarray([2.0, 1.0, 1.0, jnp.inf], dtype=jnp.float32)
    veid = jnp.asarray([10, 7, 5, INT32_MAX], dtype=jnp.int32)
    minw, eid = component_min_edge(roots, vminw, veid, 4)
    assert float(minw[0]) == 1.0 and int(eid[0]) == 5
    assert int(eid[3]) == INT32_MAX


def test_remove_mutual_hooks():
    succ = jnp.asarray([1, 0, 3, 2, 4], dtype=jnp.int32)
    out = np.asarray(remove_mutual_hooks(succ))
    assert np.array_equal(out, [0, 0, 2, 2, 4])


def test_compact_indices():
    mask = jnp.asarray([False, True, False, True, True], dtype=bool)
    idx, count = compact_indices(mask, capacity=5)
    assert int(count) == 3
    assert np.array_equal(np.asarray(idx)[:3], [1, 3, 4])
    assert np.all(np.asarray(idx)[3:] == INT32_MAX)
