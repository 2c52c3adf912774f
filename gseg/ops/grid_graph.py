"""Implicit 8-connected grid graph over an image.

JAX replacement for the reference's "Fast Graph Creation" stage
(Report.pdf p.3 §3.2.1): the CUDA code launches outer/inner border kernels in
separate streams to build a compressed adjacency list in HBM. Here the grid
graph never needs to be materialized as an adjacency list at all: the four
canonical undirected edge planes (E, S, SE, NE) are dense (H, W) arrays
produced by shifted subtractions, and the 8-neighbor incident view of any
per-vertex quantity is eight static shifts. This replaces component N3
(SURVEY.md §2.1) with a handful of fused elementwise ops and removes the reference's
stream-level concurrency machinery entirely (SURVEY.md §2.4 S6).

Edge weight = L2 distance of (smoothed) RGB values (Report.pdf p.2 §2.1).

Conventions used throughout the package:
  - Canonical directions, index d in [0, 4):
        0: E  (dy, dx) = (0, 1)     flat offset +1
        1: S  (dy, dx) = (1, 0)     flat offset +W
        2: SE (dy, dx) = (1, 1)     flat offset +W+1
        3: NE (dy, dx) = (1, -1)    flat offset +W-1
    All canonical flat offsets are positive, so for edge id
        eid = anchor_vertex * 4 + d
    the second endpoint is always anchor + offset(d). eid is a dense,
    deterministic tie-breaking key (the analog of the reference's packed
    26+26+12-bit edge keys, Report.pdf p.4 — but with full-precision float
    weights kept in a separate array, removing the 2^26-pixel capacity cap).
  - The 8-direction incident view at a vertex lists the 4 canonical
    directions first, then their reverses (W, N, NW, SW).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

# (dy, dx) per canonical direction.
DIRS4: Tuple[Tuple[int, int], ...] = ((0, 1), (1, 0), (1, 1), (1, -1))
# 8-direction incident order: canonical then reversed.
DIRS8: Tuple[Tuple[int, int], ...] = DIRS4 + tuple((-dy, -dx) for dy, dx in DIRS4)

INT32_MAX = jnp.iinfo(jnp.int32).max


def flat_offsets(width: int) -> Tuple[int, int, int, int]:
    """Flat-index offset of the second endpoint per canonical direction."""
    return tuple(dy * width + dx for dy, dx in DIRS4)


def shift_plane(x: jnp.ndarray, dy: int, dx: int, fill) -> jnp.ndarray:
    """out[y, x] = x[y+dy, x+dx] where in-bounds, else `fill`.

    Pure pad+slice: no gather, fuses into elementwise code.
    """
    h, w = x.shape[0], x.shape[1]
    py0, py1 = max(dy, 0), max(-dy, 0)
    px0, px1 = max(dx, 0), max(-dx, 0)
    padded = jnp.pad(
        x,
        [(py1, py0), (px1, px0)] + [(0, 0)] * (x.ndim - 2),
        mode="constant",
        constant_values=fill,
    )
    return padded[py1 + dy : py1 + dy + h, px1 + dx : px1 + dx + w]


def valid_plane(h: int, w: int, dy: int, dx: int) -> jnp.ndarray:
    """Bool (h, w): True where the neighbor at (dy, dx) is in-bounds."""
    ones = jnp.ones((h, w), dtype=jnp.bool_)
    return shift_plane(ones, dy, dx, False)


def edge_weight_planes(
    img: jnp.ndarray,
    connectivity: int = 8,
    quantize_bits: int = 0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Canonical edge-weight planes of the implicit grid graph.

    img: (H, W, C) float32 (already smoothed).
    Returns (weights, valid): weights (4, H, W) float32 with +inf on invalid
    slots, valid (4, H, W) bool. With connectivity=4 the diagonal planes are
    all-invalid (shapes stay static).

    quantize_bits > 0 reproduces the reference's quantized edge weights
    (Report.pdf p.4: 12-bit weights inside packed 64-bit sort keys) for
    bit-for-bit validation runs; 0 keeps full float32 precision.
    """
    img = img.astype(jnp.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w = img.shape[0], img.shape[1]
    planes = []
    valids = []
    ndirs = 4 if connectivity == 8 else 2
    for d, (dy, dx) in enumerate(DIRS4):
        if d < ndirs:
            nb = shift_plane(img, dy, dx, 0.0)
            diff = img - nb
            wt = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
            va = valid_plane(h, w, dy, dx)
        else:
            wt = jnp.zeros((h, w), dtype=jnp.float32)
            va = jnp.zeros((h, w), dtype=jnp.bool_)
        planes.append(wt)
        valids.append(va)
    weights = jnp.stack(planes)
    valid = jnp.stack(valids)
    if quantize_bits:
        # Max possible L2 RGB distance for 8-bit inputs is sqrt(3)*255.
        scale = (2**quantize_bits - 1) / (jnp.sqrt(3.0) * 255.0)
        weights = jnp.round(weights * scale) / scale
    weights = jnp.where(valid, weights, jnp.inf)
    return weights, valid


def incident_views(weights: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """8-direction incident edge view per vertex.

    weights: (4, H, W) canonical planes (+inf invalid).
    Returns (w8, eid8):
      w8   (8, H, W) float32 — weight of the incident edge in each direction
                               (+inf where absent),
      eid8 (8, H, W) int32   — canonical edge id (anchor*4 + d), INT32_MAX
                               where absent.
    For d < 4 the vertex itself is the anchor; for the reversed direction
    d+4 the neighbor at (-dy, -dx) is the anchor, so the plane is the
    canonical plane shifted by (-dy, -dx).
    """
    _, h, w = weights.shape
    vid = jnp.arange(h * w, dtype=jnp.int32).reshape(h, w)
    w8 = []
    eid8 = []
    for d, (dy, dx) in enumerate(DIRS4):
        w8.append(weights[d])
        eid_fwd = jnp.where(jnp.isfinite(weights[d]), vid * 4 + d, INT32_MAX)
        eid8.append(eid_fwd)
    for d, (dy, dx) in enumerate(DIRS4):
        wt = shift_plane(weights[d], -dy, -dx, jnp.inf)
        anchor = shift_plane(vid, -dy, -dx, 0)
        eid = jnp.where(jnp.isfinite(wt), anchor * 4 + d, INT32_MAX)
        w8.append(wt)
        eid8.append(eid)
    return jnp.stack(w8), jnp.stack(eid8)


def edge_endpoints(eid: jnp.ndarray, width: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Decode canonical edge ids into (endpoint_a, endpoint_b) flat indices.

    Invalid ids (INT32_MAX) decode to harmless in-range dummies; callers must
    mask on validity themselves.
    """
    offs = jnp.asarray(flat_offsets(width), dtype=jnp.int32)
    safe = jnp.where(eid == INT32_MAX, 0, eid)
    a = safe // 4
    d = safe % 4
    b = a + offs[d]
    return a, b


def edge_list(
    weights: jnp.ndarray, valid: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Materialize the static-size edge list (for the DPP/FastMST path).

    Returns (src, dst, w, valid_flat), each (4*H*W,), edge i has canonical id
    i itself (src*4 + d ordering matches `incident_views`). Invalid slots get
    w=+inf and src=dst=0.
    """
    _, h, w_ = weights.shape
    v = h * w_
    vid = jnp.arange(v, dtype=jnp.int32).reshape(h, w_)
    offs = flat_offsets(w_)
    srcs, dsts, ws, vals = [], [], [], []
    for d in range(4):
        va = valid[d]
        srcs.append(jnp.where(va, vid, 0))
        dsts.append(jnp.where(va, vid + offs[d], 0))
        ws.append(weights[d])
        vals.append(va)
    # Interleave so that flat index == eid == vid*4 + d.
    src = jnp.stack(srcs, axis=-1).reshape(-1)
    dst = jnp.stack(dsts, axis=-1).reshape(-1)
    wt = jnp.stack(ws, axis=-1).reshape(-1)
    va = jnp.stack(vals, axis=-1).reshape(-1)
    return src, dst, wt, va
