"""Data-parallel primitives: the JAX analog of the reference's L1 layer.

The reference builds on Thrust sort/scan/scan_by_key, a custom segmented-min
scan, and CUDA atomicMin/atomicAdd patterns (Report.pdf p.3 §3.2.2; SURVEY.md
§2.4 S3-S5). Each maps here to a deterministic XLA-friendly primitive:

  atomicMin on packed (weight,id)  -> two-phase scatter-min (`component_min_edge`)
  atomicAdd compaction             -> masked writes / prefix-sum compaction
  pointer jumping / tree flatten   -> `pointer_double` (log-round while_loop)
  thrust sort / sort_by_key        -> `jax.lax.sort` multi-operand sort
  scan / scan_by_key               -> `lax.cumsum` / segment boundaries

All primitives are deterministic (scatter-min/max with total-order keys), so
the reference's atomics nondeterminism is removed by construction (SURVEY.md
§5 race detection).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

INT32_MAX = jnp.iinfo(jnp.int32).max


def pointer_double(parent: jnp.ndarray, max_rounds: int | None = None) -> jnp.ndarray:
    """Flatten a parent forest: out[v] = root of v.

    JAX replacement for both the reference's atomics-based tree
    flatten (Report.pdf Appendix A Alg. 6) and FastMST pointer jumping
    (Report.pdf p.3 §3.2.2): parent = parent[parent] doubling inside a
    lax.while_loop with an on-device convergence reduction, so it exits after
    ceil(log2(max chain)) rounds instead of a worst-case static count.
    """
    n = parent.shape[0]
    if max_rounds is None:
        max_rounds = max(int(n - 1).bit_length(), 1) + 1

    def cond(state):
        _, changed, i = state
        return jnp.logical_and(changed, i < max_rounds)

    def body(state):
        p, _, i = state
        p2 = p[p]
        return p2, jnp.any(p2 != p), i + jnp.int32(1)

    p, _, _ = jax.lax.while_loop(cond, body, (parent, jnp.bool_(True), jnp.int32(0)))
    return p


def component_min_edge(
    roots: jnp.ndarray,
    vert_minw: jnp.ndarray,
    vert_eid: jnp.ndarray,
    num_slots: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-component minimum outgoing edge via two-phase scatter-min.

    Replaces the reference's atomicMin-reduce over packed (weight|id) 64-bit
    values (Report.pdf p.2-3 §3.1 step 2, Appendix A Alg. 2) without any bit
    packing: phase 1 scatter-mins the float32 weight per component, phase 2
    scatter-mins the canonical edge id among the weight-tying candidates.
    Deterministic: ties resolve to the smallest edge id.

    roots:     (V,) int32 component id (root vertex index) per vertex.
    vert_minw: (V,) float32 best outgoing weight per vertex (+inf if none).
    vert_eid:  (V,) int32 canonical edge id of that edge (INT32_MAX if none).
    Returns (comp_minw, comp_eid), each (num_slots,), +inf / INT32_MAX where
    a component has no outgoing edge (and at non-root slots).
    """
    comp_minw = jnp.full((num_slots,), jnp.inf, dtype=vert_minw.dtype)
    comp_minw = comp_minw.at[roots].min(vert_minw, mode="drop")
    is_best = vert_minw == comp_minw[roots]
    cand = jnp.where(is_best, vert_eid, INT32_MAX)
    comp_eid = jnp.full((num_slots,), INT32_MAX, dtype=jnp.int32)
    comp_eid = comp_eid.at[roots].min(cand, mode="drop")
    return comp_minw, comp_eid


def remove_mutual_hooks(succ: jnp.ndarray) -> jnp.ndarray:
    """Break 2-cycles in a successor array: of each mutual pair, the smaller
    id becomes a root. Reference: "remove circular merges" kernel
    (Report.pdf p.3 §3.1 step 4, Appendix A Alg. 4)."""
    idx = jnp.arange(succ.shape[0], dtype=succ.dtype)
    mutual = jnp.logical_and(succ[succ] == idx, succ != idx)
    return jnp.where(jnp.logical_and(mutual, idx < succ), idx, succ)


def segment_sum(values: jnp.ndarray, seg: jnp.ndarray, num_slots: int) -> jnp.ndarray:
    out = jnp.zeros((num_slots,), dtype=values.dtype)
    return out.at[seg].add(values, mode="drop")


def segment_max(
    values: jnp.ndarray, seg: jnp.ndarray, num_slots: int, fill=0.0
) -> jnp.ndarray:
    out = jnp.full((num_slots,), fill, dtype=values.dtype)
    return out.at[seg].max(values, mode="drop")


def block_compact(mask, arrays, out_elems: int, block: int = 64):
    """Stream compaction at `block`-lane granularity.

    Compaction is done per 64-lane window: windows containing any live
    element are moved wholesale via one row-gather;
    dead lanes stay masked. This replaces the reference's atomicAdd stream
    compaction (Report.pdf Appendix A Alg. 3) with O(N/64) scatter lanes +
    O(out) row-gather traffic.

    mask: (N,) bool. arrays: list of (N,) payloads. out_elems: output
    capacity in elements (multiple of `block`).
    Returns (out_mask (out_elems,), outs [same dtypes], overflow ()bool).
    Live windows beyond capacity are dropped and flagged via `overflow`.
    """
    n = mask.shape[0]
    pad = (-n) % block
    if pad:
        mask = jnp.concatenate([mask, jnp.zeros((pad,), jnp.bool_)])
        arrays = [
            jnp.concatenate([a, jnp.zeros((pad,), a.dtype)]) for a in arrays
        ]
    nb = (n + pad) // block
    out_rows = out_elems // block
    m2 = mask.reshape(nb, block)
    win = jnp.any(m2, axis=1)
    pos = jnp.cumsum(win.astype(jnp.int32)) - 1
    slot = jnp.where(win, pos, out_rows)
    widx = jnp.full((out_rows,), nb, dtype=jnp.int32)
    widx = widx.at[slot].set(
        jnp.arange(nb, dtype=jnp.int32), mode="drop"
    )
    overflow = jnp.sum(win.astype(jnp.int32)) > out_rows
    outs = []
    for a in arrays:
        a2 = jnp.concatenate(
            [a.reshape(nb, block), jnp.zeros((1, block), a.dtype)]
        )
        outs.append(a2[widx].reshape(-1))
    m3 = jnp.concatenate([m2, jnp.zeros((1, block), jnp.bool_)])[widx]
    return m3.reshape(-1), outs, overflow


def sparse_select(mask, arrays, cap: int):
    """Compact a SPARSE mask's elements to the front of `cap`-sized buffers.

    cumsum + vectorized binary search (jnp.searchsorted over the running
    count) + per-hit element gathers: O(N) dense work + O(cap * log N)
    gather lanes. Beats a full N-element sort when cap << N (e.g. selecting
    ~50k pair heads out of 8M edge slots). Stable (preserves input order).

    Returns (out_mask (cap,), outs, overflow).
    """
    n = mask.shape[0]
    counts = jnp.cumsum(mask.astype(jnp.int32))
    total = counts[-1]
    ranks = jnp.arange(1, cap + 1, dtype=jnp.int32)
    pos = jnp.searchsorted(counts, ranks, side="left").astype(jnp.int32)
    valid = ranks <= total
    pos_safe = jnp.where(valid, pos, 0)
    outs = [jnp.where(valid, a[pos_safe], 0).astype(a.dtype) for a in arrays]
    return valid, outs, total > cap


def compact_indices(mask: jnp.ndarray, capacity: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Stable compaction: indices of True entries, padded to `capacity`.

    The XLA-static analog of the reference's atomicAdd offset compaction
    (Report.pdf Appendix A Alg. 3): an exclusive prefix sum assigns each live
    element its output slot; masked scatter writes it there.
    Returns (indices (capacity,), count ()). Slots beyond count hold
    INT32_MAX.
    """
    n = mask.shape[0]
    pos = jnp.cumsum(mask.astype(jnp.int32)) - mask.astype(jnp.int32)
    count = jnp.sum(mask.astype(jnp.int32))
    out = jnp.full((capacity,), INT32_MAX, dtype=jnp.int32)
    idx = jnp.arange(n, dtype=jnp.int32)
    slot = jnp.where(mask, pos, capacity)  # dropped when == capacity
    out = out.at[slot].set(idx, mode="drop")
    return out, count
