"""Test env: the CPU backend with 8 virtual devices, set BEFORE jax import.

Mirrors the reference's single-machine validation (SURVEY.md §4.5): jax's
CPU backend is the "fake backend" — every jitted program (and the shard_map
multi-device paths, over the 8 virtual devices) runs without a GPU. Tests
marked `gpu` need the card: run them there with
`JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gseg.config import SegmentationConfig
from gseg.ops import tilepass
from gseg.utils.synthetic import blobs_image
from tests import fixpoint_ref


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Work around a deterministic XLA:CPU compiler segfault.

    The full suite crashed 4x in round 4 (+2 reproductions in round 5)
    inside `backend_compile_and_load` while compiling
    `segment_turbo_hierarchy`, always at the same test — but only with
    the WHOLE suite in one process: the same test passes in isolation
    (warm or cold persistent cache), tests/test_turbo.py alone passes,
    the tail modules (parallel+turbo) pass, and the full suite
    MINUS test_parallel passes. The trigger
    is cumulative in-process compiler/executable state (the 8-virtual-
    device mesh executables of test_parallel plus everything else), not
    any single program. Raising the stack rlimit (256 MB) did not help,
    so it is not stack exhaustion. Dropping the accumulated executables
    between modules removes the trigger state; compile-time cost is
    minor because modules share few jitted programs.
    """
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def small_image():
    return blobs_image(24, 32, num_blobs=5, noise=6.0, seed=0)


@pytest.fixture(scope="session")
def small_cfg():
    return SegmentationConfig(sigma=0.8, k=100.0, min_size=8, max_iters=32)


@pytest.fixture
def small_tiles(monkeypatch):
    """Tiles of 4 x 8 interior cells at the default 8-step halo, so test
    images span many tiles."""
    monkeypatch.setattr(tilepass, "TILE_COLS", 24)
    monkeypatch.setattr(tilepass, "MAX_TILE_ROWS", 20)


@pytest.fixture
def emulated(monkeypatch, small_tiles):
    """Route tilepass.tile_pass through the NumPy kernel emulation."""

    def tile_pass(rule, ro, rw, steps=tilepass.STEPS):
        def host(ro, *rw):
            changed, out = fixpoint_ref.tile_pass_np(rule, ro, rw, steps)
            return (np.int32(changed),) + tuple(out)

        out = jax.pure_callback(
            host, (jax.ShapeDtypeStruct((), jnp.int32),)
            + tuple(jax.ShapeDtypeStruct(x.shape, x.dtype) for x in rw),
            ro, *rw)
        return out[0] != 0, tuple(out[1:])

    monkeypatch.setattr(tilepass, "tile_pass", tile_pass)
