"""Dense 8-neighbour fixpoints as T-step tile passes on the GPU.

Turbo's gossip rounds and final map run five fixpoints over the pixel grid
(models/turbo.py): the component lexmin, the label flood with and without
the riding BFS dist, the min-value flood and the subtree sums. As XLA
sweeps each step is one `lax.while_loop` iteration: it streams 2-4 full
planes through HBM and ends in a predicate the host reads before the next
step can start. `native/tilepass.cu` fuses T steps into one launch: a block
loads a tile plus a T-cell halo into shared memory, steps it T times there
and writes the interior back with one changed flag. A `lax.while_loop`
drives passes until the flag is clear, so HBM passes and host syncs both
drop by about T.

The XLA sweeps stay the specification: a pass equals T sweep steps exactly
(same rules, direction order and out-of-image fills), so the fixpoints are
bit-equal. `use_kernels` picks by platform: the kernels on the GPU, the XLA
sweeps on the CPU, which is the test backend and the reference.

The library builds from `native/tilepass.cu` at first use
(`make -C gseg/native tilepass`, needs nvcc) into `native/build/`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# rule -> (FFI target, number of read-write planes)
RULES = {
    "compmin": ("GsegTilePassCompmin", 3),
    "label_dist": ("GsegTilePassLabelDist", 3),
    "label": ("GsegTilePassLabel", 2),
    "value": ("GsegTilePassValue", 1),
    "subsum": ("GsegTilePassSubsum", 1),
}

STEPS = 8               # sweep steps per pass (the halo width)
TILE_COLS = 128         # loaded tile width in words: 4 passes of a warp row
MAX_TILE_ROWS = 128
SMEM_BYTES = 227 * 1024  # shared memory one block may use on Hopper

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
LIB_PATH = os.path.join(_NATIVE, "build", "libgsegtilepass.so")
_registered = False


def use_kernels(platform: str) -> bool:
    """True on the GPU (tile-pass kernels), False on the CPU (XLA sweeps).
    Any other platform has neither and is an error."""
    if platform == "gpu":
        return True
    if platform == "cpu":
        return False
    raise NotImplementedError(
        f"no dense fixpoint implementation for platform {platform!r}: "
        "the tile-pass kernels need a CUDA GPU, the XLA sweeps run on CPU")


class Geometry(NamedTuple):
    tile_h: int   # interior rows per block
    tile_w: int   # interior columns per block
    grid: tuple   # (blocks along W, blocks along H)
    smem_bytes: int


def geometry(h: int, w: int, n_rw: int, steps: int = STEPS) -> Geometry:
    """Tile shape for a rule with `n_rw` read-write planes.

    Shared memory holds the read-only plane once and every read-write
    plane twice (double buffer), 4 bytes a cell. The loaded tile is
    TILE_COLS wide and as tall as 227 KB allows (capped at MAX_TILE_ROWS);
    the interior is the tile less a `steps`-cell halo on every side. At
    4 planes that is 48 x 112 interior cells: 414 blocks at 1080p and 1575
    at 4K, several waves over the 132 SMs."""
    words = 1 + 2 * n_rw
    rows = min(SMEM_BYTES // (4 * words * TILE_COLS), MAX_TILE_ROWS)
    tile_h = rows - 2 * steps
    tile_w = TILE_COLS - 2 * steps
    if tile_h < 1 or tile_w < 1:
        raise ValueError(f"halo of {steps} steps leaves no interior")
    grid = (-(-w // tile_w), -(-h // tile_h))
    return Geometry(tile_h, tile_w, grid, 4 * words * rows * TILE_COLS)


def _register() -> None:
    global _registered
    if _registered:
        return
    if not os.path.exists(LIB_PATH):
        subprocess.run(
            ["make", "-C", _NATIVE, "-s", "tilepass",
             f"PYTHON={sys.executable}"],
            check=True,
        )
    lib = ctypes.cdll.LoadLibrary(LIB_PATH)
    for target, _ in RULES.values():
        jax.ffi.register_ffi_target(
            target, jax.ffi.pycapsule(getattr(lib, target)), platform="CUDA")
    _registered = True


def tile_pass(rule: str, ro, rw, steps: int = STEPS):
    """One pass: `steps` sweep steps of `rule` over the whole plane.
    Returns (changed () bool, tuple of updated read-write planes)."""
    target, n_rw = RULES[rule]
    if len(rw) != n_rw:
        raise ValueError(f"{rule} takes {n_rw} read-write planes")
    for x in (ro, *rw):
        if x.shape != ro.shape or x.ndim != 2 or x.dtype.itemsize != 4:
            raise ValueError("tile passes take equal 2-D 32-bit planes")
    _register()
    g = geometry(ro.shape[0], ro.shape[1], n_rw, steps)
    out = jax.ffi.ffi_call(
        target,
        (jax.ShapeDtypeStruct((), jnp.int32),)
        + tuple(jax.ShapeDtypeStruct(x.shape, x.dtype) for x in rw),
        vmap_method="sequential",
    )(ro, *rw, steps=np.int32(steps), tile_h=np.int32(g.tile_h),
      tile_w=np.int32(g.tile_w))
    return out[0] != 0, tuple(out[1:])


def fixpoint(rule: str, ro, rw, max_sweeps: int, go=None,
             steps: int = STEPS):
    """Passes until one changes nothing, at most ceil(max_sweeps / steps).
    go: optional traced () bool; False skips the loop (the inputs are the
    fixpoint by construction). Returns (planes, unconverged)."""
    max_passes = -(-max_sweeps // steps)

    def body(st):
        planes, _, i = st
        changed, planes = tile_pass(rule, ro, planes, steps)
        return planes, changed, i + jnp.int32(1)

    go = jnp.bool_(True) if go is None else go
    planes, unconv, _ = jax.lax.while_loop(
        lambda st: st[1] & (st[2] < max_passes), body,
        (tuple(rw), go, jnp.int32(0)))
    return planes, unconv


def pack_allow_bits(allow8) -> jnp.ndarray:
    """8 (H, W) bool planes in DIRS8 order -> int32 plane, bit d = plane d."""
    bits = jnp.zeros(allow8[0].shape, jnp.int32)
    for d in range(8):
        bits = bits | (allow8[d].astype(jnp.int32) << d)
    return bits


# Drop-ins for the XLA sweeps of models/turbo.py (same returns).


def compmin(L, bw, be, sz, max_sweeps, idle=None):
    go = None if idle is None else jnp.logical_not(idle)
    (bw, be, sz), unconv = fixpoint("compmin", L, (bw, be, sz), max_sweeps,
                                    go=go)
    return bw, be, sz, unconv


def label_dist(L, allow8, idf, dist, max_sweeps):
    (L, idf, dist), unconv = fixpoint(
        "label_dist", pack_allow_bits(allow8), (L, idf, dist), max_sweeps)
    return L, idf, dist, unconv


def label(L, allow8, idf, max_sweeps):
    (L, idf), unconv = fixpoint("label", pack_allow_bits(allow8), (L, idf),
                                max_sweeps)
    return L, idf, unconv


def value_flood(L, val, max_sweeps):
    (val,), unconv = fixpoint("value", L, (val,), max_sweeps)
    return val, unconv


def subtree_sums(pdir, s, max_sweeps):
    (s,), unconv = fixpoint("subsum", pdir, (s,), max_sweeps)
    return s, unconv
