"""Atomic-path Boruvka-Felzenszwalb segmentation in JAX.

Rebuild of the reference's fastest variant, the "Atomic Felzenszwalb"
CUDA implementation (branch cuda-mst-naive; Report.pdf p.2-3 §3.1 and
Appendix A Algs 1-6). The reference runs an 8-step kernel loop per Boruvka
round: per-vertex min-edge scan, atomicMin per-component reduce of packed
(weight|id), atomicAdd compaction, cycle removal, merge-predicate check,
host-synced convergence flag (or device-side orchestration via dynamic
parallelism), parent update, and atomics tree-flatten.

Redesign (not a translation):
  - The grid graph is implicit; the per-vertex min-edge scan is eight static
    (H, W) shifts + a min-reduce — no adjacency list, no
    compaction (SURVEY.md §7 key representation choices).
  - atomicMin reduce      -> deterministic two-phase scatter-min
    (`ops.primitives.component_min_edge`), float32 weights, no bit packing.
  - atomicAdd compaction  -> unnecessary: component arrays are statically
    V-sized, indexed by root vertex id.
  - tree flatten          -> pointer doubling (log rounds, on-device exit).
  - the whole Boruvka loop runs inside `lax.while_loop` with an on-device
    convergence reduction. This is the JAX analog of the reference's
    *dynamic parallelism* mode (zero host crossings; Report.pdf p.3 §3.1
    "ab dynamic"); `segment_atomic_hostsync` mirrors the *conventional* mode
    (4-byte flag copy per iteration, Report.pdf p.5 Fig. 3) for benchmark
    parity.

Predicate semantics follow Felzenszwalb-Huttenlocher: components Ca, Cb merge
along their minimum outgoing edge of weight w iff
    w <= min(Int(Ca) + k/|Ca|, Int(Cb) + k/|Cb|),
with Int updated as the max over constituent Ints and the merge-edge weights
(Boruvka formulation; matches the sequential oracle in models/boruvka_cpu.py
exactly, including tie-breaking by canonical edge id).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SegmentationConfig
from ..ops import grid_graph as gg
from ..ops import filters
from ..ops.primitives import (
    INT32_MAX,
    component_min_edge,
    pointer_double,
    remove_mutual_hooks,
    segment_max,
    segment_sum,
)


class BoruvkaState(NamedTuple):
    parent: jnp.ndarray    # (V,) int32, always flattened (parent[v] == root)
    size: jnp.ndarray      # (V,) int32, valid at root slots
    intdiff: jnp.ndarray   # (V,) float32, valid at root slots
    merged: jnp.ndarray    # () bool — did the last round merge anything
    it: jnp.ndarray        # () int32


def _vertex_min_edge(w8, eid8, roots2d):
    """Per-vertex minimum outgoing edge (reference step 1, Appendix A Alg. 1).

    w8/eid8: (8, H, W) incident views. roots2d: (H, W) int32.
    Returns (vminw (V,), veid (V,)): +inf / INT32_MAX when the vertex has no
    outgoing edge (all neighbors in the same component). Ties break to the
    smallest canonical edge id, deterministically.
    """
    nbr_roots = jnp.stack(
        [gg.shift_plane(roots2d, dy, dx, -1) for dy, dx in gg.DIRS8]
    )
    outgoing = jnp.where(nbr_roots != roots2d[None], w8, jnp.inf)
    vminw = jnp.min(outgoing, axis=0)
    cand = jnp.where(outgoing == vminw[None], eid8, INT32_MAX)
    veid = jnp.min(cand, axis=0)
    veid = jnp.where(jnp.isfinite(vminw), veid, INT32_MAX)
    return vminw.reshape(-1), veid.reshape(-1)


def _round(state: BoruvkaState, w8, eid8, shape, k, min_size, mode):
    """One Boruvka round. mode: 'felz' (predicate-gated) or 'minsize'."""
    h, w = shape
    v = h * w
    parent, size, intdiff = state.parent, state.size, state.intdiff
    arange = jnp.arange(v, dtype=jnp.int32)

    vminw, veid = _vertex_min_edge(w8, eid8, parent.reshape(h, w))
    comp_minw, comp_eid = component_min_edge(parent, vminw, veid, v)
    has = comp_eid != INT32_MAX

    a, b = gg.edge_endpoints(comp_eid, w)
    ra, rb = parent[a], parent[b]
    other = jnp.where(ra == arange, rb, ra)

    if mode == "felz":
        # Multiply-form predicate (w - Int)*|C| <= k — division-free so
        # decisions are bit-identical across backends (an accelerator's f32
        # divide need not be IEEE-exact; see models/boruvka_cpu.py). Invalid lanes
        # (comp_minw=inf, or size=0 stale slots -> nan) are masked by
        # `has` below.
        kf = jnp.float32(k)
        lhs_self = (comp_minw - intdiff) * size.astype(jnp.float32)
        lhs_other = ((comp_minw - intdiff[other])
                     * size[other].astype(jnp.float32))
        ok = jnp.logical_and(lhs_self <= kf, lhs_other <= kf)
    elif mode == "minsize":
        ok = size < min_size
    else:  # pragma: no cover
        raise ValueError(mode)
    hook = jnp.logical_and(has, ok)

    succ = jnp.where(hook, other, arange)
    succ = remove_mutual_hooks(succ)
    used = succ != arange

    new_root_of = pointer_double(succ)
    parent_new = new_root_of[parent]

    is_root = parent == arange
    size_new = segment_sum(jnp.where(is_root, size, 0), parent_new, v)
    intdiff_new = segment_max(
        jnp.where(is_root, intdiff, 0.0), parent_new, v, fill=0.0
    )
    intdiff_new = intdiff_new.at[parent_new].max(
        jnp.where(used, comp_minw, 0.0), mode="drop"
    )

    return BoruvkaState(
        parent=parent_new,
        size=size_new,
        intdiff=intdiff_new,
        merged=jnp.any(used),
        it=state.it + jnp.int32(1),
    )


def _init_state(v: int) -> BoruvkaState:
    return BoruvkaState(
        parent=jnp.arange(v, dtype=jnp.int32),
        size=jnp.ones((v,), dtype=jnp.int32),
        intdiff=jnp.zeros((v,), dtype=jnp.float32),
        merged=jnp.bool_(True),
        it=jnp.int32(0),
    )


def _run_phase(state, w8, eid8, shape, k, min_size, mode, max_iters):
    """Run rounds until convergence inside lax.while_loop (on-device;
    the analog of the reference's dynamic-parallelism orchestration)."""
    def cond(s):
        return jnp.logical_and(s.merged, s.it < max_iters)

    def body(s):
        return _round(s, w8, eid8, shape, k, min_size, mode)

    state = state._replace(merged=jnp.bool_(True), it=jnp.int32(0))
    return jax.lax.while_loop(cond, body, state)


def prepare_graph(image: jnp.ndarray, cfg: SegmentationConfig):
    """Smoothing + implicit-graph incident views (reference stages
    'pre-filtering' + 'fast graph creation', Report.pdf p.3 §3.2-3.2.1)."""
    smoothed = filters.gaussian_smooth(image, cfg.sigma)
    weights, _ = gg.edge_weight_planes(
        smoothed, cfg.connectivity, cfg.quantize_weight_bits
    )
    return gg.incident_views(weights)


def segment_atomic_impl(image: jnp.ndarray, cfg: SegmentationConfig) -> jnp.ndarray:
    """Un-jitted pipeline body (for composition under vmap/pjit/shard_map).

    Full pipeline: smooth -> implicit graph -> Boruvka-Felzenszwalb ->
    min-size merge. Returns (H, W) int32 labels (root vertex ids; use
    utils.labels.compact_labels_np for consecutive ids).
    """
    h, w = image.shape[0], image.shape[1]
    w8, eid8 = prepare_graph(image, cfg)
    state = _init_state(h * w)
    state = _run_phase(
        state, w8, eid8, (h, w), cfg.k, cfg.min_size, "felz", cfg.max_iters
    )
    if cfg.min_size > 1:
        state = _run_phase(
            state, w8, eid8, (h, w), cfg.k, cfg.min_size, "minsize", cfg.max_iters
        )
    return state.parent.reshape(h, w)


segment_atomic = jax.jit(segment_atomic_impl, static_argnames=("cfg",))

# Module-level jit (not per-call) so repeated hostsync invocations reuse the
# trace cache instead of re-tracing prepare_graph every call.
_prepare_graph_jit = jax.jit(prepare_graph, static_argnames=("cfg",))


@functools.partial(jax.jit, static_argnames=("cfg", "mode", "shape"))
def _one_round_jit(state, w8, eid8, shape, cfg: SegmentationConfig, mode: str):
    return _round(state, w8, eid8, shape, cfg.k, cfg.min_size, mode)


def segment_atomic_hostsync(image, cfg: SegmentationConfig):
    """Host-synced variant: one jitted Boruvka round per Python-loop step with
    the convergence flag copied to host each iteration — mirrors the
    reference's *conventional* mode (4-byte device->host copy per round,
    Report.pdf p.5 Fig. 3 / report-extract 505-517). Exists for benchmark
    parity; `segment_atomic` keeps the loop on the device.
    """
    image = jnp.asarray(image)
    h, w = image.shape[0], image.shape[1]
    w8, eid8 = _prepare_graph_jit(image, cfg)
    state = _init_state(h * w)
    for mode in ("felz", "minsize") if cfg.min_size > 1 else ("felz",):
        state = state._replace(merged=jnp.bool_(True), it=jnp.int32(0))
        for _ in range(cfg.max_iters):
            state = _one_round_jit(state, w8, eid8, (h, w), cfg, mode)
            if not bool(state.merged):  # the 4-byte host crossing
                break
    return state.parent.reshape(h, w)


@functools.partial(jax.jit, static_argnames=("cfg",))
def segment_atomic_hierarchy(image, cfg: SegmentationConfig):
    """Atomic path with per-round label capture.

    Returns (levels, labels): levels (max_iters+1, H, W) int32 label map per
    Boruvka round (rows past convergence repeat the final map) — the analog
    of the reference's per-iteration supervertex-id maps feeding Fast
    Hierarchy Creation (Report.pdf p.4 §3.2.3) — plus the final labels after
    the min-size pass.
    """
    h, w = image.shape[0], image.shape[1]
    v = h * w
    w8, eid8 = prepare_graph(image, cfg)
    state = _init_state(v)
    levels0 = jnp.zeros((cfg.max_iters + 1, v), dtype=jnp.int32)
    levels0 = levels0.at[0].set(state.parent)

    def body(i, carry):
        state, levels = carry
        state = jax.lax.cond(
            state.merged,
            lambda s: _round(s, w8, eid8, (h, w), cfg.k, cfg.min_size, "felz"),
            lambda s: s,
            state,
        )
        levels = levels.at[i + 1].set(state.parent)
        return state, levels

    state, levels = jax.lax.fori_loop(0, cfg.max_iters, body, (state, levels0))
    if cfg.min_size > 1:
        state = _run_phase(
            state, w8, eid8, (h, w), cfg.k, cfg.min_size, "minsize", cfg.max_iters
        )
    return levels.reshape(cfg.max_iters + 1, h, w), state.parent.reshape(h, w)
