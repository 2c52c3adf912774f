"""The GPU tile-pass wrapper (ops/tilepass.py) on the CPU.

The CUDA kernel has no CPU mode, so what surrounds it is tested here:
the tile and halo geometry, the pass semantics through a NumPy emulation
of the kernel (tests/fixpoint_ref.py) held to T global steps, the fixpoint
loop, plane packing and shapes, and the choice of implementation by
platform. One `gpu`-marked test compares the kernel with the XLA sweep on
the card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gseg.bench.fixpoints import fixpoints
from gseg.config import SegmentationConfig
from gseg.models import turbo
from gseg.models.boruvka_cpu import segment_boruvka_np
from gseg.ops import tilepass
from gseg.utils.labels import canonical_min_labels_np
from gseg.utils.synthetic import blobs_image
from tests.fixpoint_ref import RULES, fixpoint_np, tile_pass_np
from tests.test_fixpoints import _inputs, _sweep

RULE_NAMES = tuple(tilepass.RULES)
SIZES = ((1080, 1920), (2160, 3840), (1, 37))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("rule", RULE_NAMES)
def test_geometry_fits_shared_memory_and_covers(rule, size):
    h, w = size
    n_rw = tilepass.RULES[rule][1]
    g = tilepass.geometry(h, w, n_rw)
    assert g.smem_bytes <= tilepass.SMEM_BYTES
    loaded = (g.tile_h + 2 * tilepass.STEPS) * (g.tile_w + 2 * tilepass.STEPS)
    assert g.smem_bytes == 4 * (1 + 2 * n_rw) * loaded
    gx, gy = g.grid
    assert (gx - 1) * g.tile_w < w <= gx * g.tile_w
    assert (gy - 1) * g.tile_h < h <= gy * g.tile_h


def test_geometry_4_planes_fill_the_sms():
    g = tilepass.geometry(1080, 1920, 3)
    assert (g.tile_h, g.tile_w) == (48, 112)
    assert g.grid[0] * g.grid[1] >= 3 * 132


def test_geometry_rejects_halo_without_interior():
    with pytest.raises(ValueError):
        tilepass.geometry(64, 64, 3, steps=64)


@pytest.mark.parametrize("steps", [1, 3, 8])
@pytest.mark.parametrize("rule", RULE_NAMES)
def test_tile_pass_equals_global_steps(rule, steps, small_tiles):
    """A pass over 4 x 8 tiles equals `steps` global steps of the rule."""
    ro, planes, _ = _inputs(rule, "37x150")
    step = RULES[rule][0]
    ref = tuple(planes)
    for _ in range(steps):
        ref = step(ro, ref)
    changed, got = tile_pass_np(rule, ro, planes, steps)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g, r)
    assert changed == any(not np.array_equal(r, p)
                          for r, p in zip(ref, planes))


@pytest.mark.parametrize("rule", RULE_NAMES)
def test_tile_pass_fixpoint_reports_unchanged(rule, small_tiles):
    ro, planes, steps = _inputs(rule, "23x70")
    fixed, _ = fixpoint_np(rule, ro, planes, steps)
    changed, again = tile_pass_np(rule, ro, fixed)
    assert not changed
    for a, b in zip(again, fixed):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rule", RULE_NAMES)
def test_wrapper_fixpoint_matches_sweep(rule, emulated):
    """tilepass.<rule> (allow-bit packing, pass loop and its budget) over
    the emulated kernel gives the XLA sweep's planes and flag."""
    ro, planes, steps = _inputs(rule, "fuzz170x230")
    ref = _sweep(rule, ro, planes, steps)
    ro, planes = jnp.asarray(ro), [jnp.asarray(p) for p in planes]
    if rule == "compmin":
        got = tilepass.compmin(ro, *planes, steps)
    elif rule in ("label", "label_dist"):
        allow8 = jnp.stack([((ro >> d) & 1) > 0 for d in range(8)])
        fn = tilepass.label if rule == "label" else tilepass.label_dist
        got = fn(planes[0], allow8, *planes[1:], steps)
    elif rule == "value":
        got = tilepass.value_flood(ro, planes[0], steps)
    else:
        got = tilepass.subtree_sums(ro, planes[0], steps)
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


def test_compmin_idle_runs_no_pass(emulated):
    """idle=True returns the inputs untouched and converged."""
    ro, planes, steps = _inputs("compmin", "23x70")
    planes = [jnp.asarray(p) for p in planes]
    *out, unconv = tilepass.compmin(jnp.asarray(ro), *planes, steps,
                                    idle=jnp.bool_(True))
    assert not bool(unconv)
    for a, b in zip(out, planes):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pass_budget_flags_unconverged(emulated):
    """A flood longer than the pass budget reports unconverged, as the
    sweep does at its step budget."""
    ro, planes, _ = _inputs("label", "spiral33")
    ro, planes = jnp.asarray(ro), [jnp.asarray(p) for p in planes]
    allow8 = jnp.stack([((ro >> d) & 1) > 0 for d in range(8)])
    *_, unconv = tilepass.label(planes[0], allow8, planes[1], 16)
    *_, ref_unconv = turbo._label_gossip_nd(planes[0], allow8, planes[1], 16)
    assert bool(unconv) and bool(ref_unconv)


@pytest.mark.parametrize("wb", [0, 16])
def test_turbo_through_tile_passes_matches_oracle(wb, emulated):
    """The whole turbo pipeline with its fixpoints routed through the
    tile-pass wrapper (kernel emulated) keeps the oracle's partition."""
    cfg = SegmentationConfig(k=100.0, min_size=8, weight_buckets=wb)
    img = blobs_image(24, 32, 5, 6.0, 0)
    with fixpoints(tilepass):
        labels, flags = jax.jit(
            lambda im: turbo.segment_turbo_impl(im, cfg, 2))(
                jnp.asarray(img))
    assert int(flags) == 0
    expected = canonical_min_labels_np(segment_boruvka_np(img, cfg))
    assert np.array_equal(expected, np.asarray(labels))


@pytest.mark.parametrize("rule", RULE_NAMES)
def test_tile_pass_output_shapes(rule, monkeypatch):
    monkeypatch.setattr(tilepass, "_register", lambda: None)
    n_rw = tilepass.RULES[rule][1]
    ro = jax.ShapeDtypeStruct((37, 150), jnp.int32)
    rw = [jax.ShapeDtypeStruct((37, 150), jnp.float32 if k == 1
                               else jnp.int32) for k in range(n_rw)]
    changed, out = jax.eval_shape(
        lambda ro, *rw: tilepass.tile_pass(rule, ro, rw), ro, *rw)
    assert changed.shape == () and changed.dtype == jnp.bool_
    assert [(o.shape, o.dtype) for o in out] == [(x.shape, x.dtype)
                                                 for x in rw]


def test_tile_pass_rejects_bad_planes(monkeypatch):
    monkeypatch.setattr(tilepass, "_register", lambda: None)
    a = jnp.zeros((8, 8), jnp.int32)
    with pytest.raises(ValueError):
        tilepass.tile_pass("value", a, (a, a))  # one read-write plane
    with pytest.raises(ValueError):
        tilepass.tile_pass("value", a, (jnp.zeros((8, 9), jnp.int32),))
    with pytest.raises(ValueError):
        tilepass.tile_pass("value", a, (jnp.zeros((8, 8), jnp.int16),))


def test_pack_allow_bits():
    rng = np.random.default_rng(0)
    allow = rng.integers(0, 2, (8, 5, 7)).astype(bool)
    bits = np.asarray(tilepass.pack_allow_bits(jnp.asarray(allow)))
    for d in range(8):
        assert np.array_equal((bits >> d) & 1, allow[d].astype(np.int32))


@pytest.mark.parametrize("platform,kernels",
                         [("gpu", True), ("cpu", False), ("metal", None)])
def test_use_kernels_by_platform(platform, kernels):
    if kernels is None:
        with pytest.raises(NotImplementedError):
            tilepass.use_kernels(platform)
    else:
        assert tilepass.use_kernels(platform) is kernels


def test_fixpoints_dispatch(monkeypatch):
    assert turbo._fixpoints() is None  # CPU: the XLA sweeps
    with fixpoints(tilepass):
        assert turbo._fixpoints() is tilepass
    monkeypatch.setattr(tilepass, "use_kernels", lambda platform: True)
    assert turbo._fixpoints() is tilepass
    assert turbo._fixpoints(turbo._DENSE_COMM) is tilepass
    spatial = turbo._DENSE_COMM._replace(dense=False)
    assert turbo._fixpoints(spatial) is None


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("the tile-pass kernel runs only on a CUDA GPU")


@pytest.mark.gpu
@pytest.mark.parametrize("rule", RULE_NAMES)
def test_kernel_matches_sweep_on_gpu(rule, gpu):
    ro, planes, steps = _inputs(rule, "fuzz170x230")
    ref = _sweep(rule, ro, planes, steps)
    changed, got = tilepass.tile_pass(
        rule, jnp.asarray(ro), [jnp.asarray(p) for p in planes])
    _, emu = tile_pass_np(rule, ro, planes)
    for e, g in zip(emu, got):
        np.testing.assert_array_equal(np.asarray(g), e)
    got = tilepass.fixpoint(rule, jnp.asarray(ro),
                            [jnp.asarray(p) for p in planes], steps)[0]
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
