"""Turbo path: staged gossip + compact-graph Boruvka-Felzenszwalb.

Produces the same segmentation *partition* as the sequential oracle and the
atomic/fastmst paths (tests verify this), with a schedule of its own rather
than a translation of the reference's CUDA rounds (Report.pdf p.2-3 §3.1):
while components are small every per-component reduction is a dense
8-neighbour fixpoint over the pixel grid, and once they are few the rounds
move to a compact list of boundary edges.

  STAGE G — gossip rounds while components are small. All per-component
  reductions are dense 8-neighbor propagations over the pixel grid
  (ops/tilepass.py: T-step tile-pass kernels on the GPU, the XLA sweeps
  below on the CPU) or compact-pool reductions:
    - component min edge: lexmin (w, eid) gossip,
    - merged-cluster labels (canonical min-vertex-id): min-label gossip
      over same-component + passing-hook adjacency, with Int(C) riding as
      a max,
    - |C|: exact counting, diameter-independent — the first two (peeled)
      rounds size by the BFS-dist convergecast (or one flat counting
      scatter-add keyed by label, `_component_sizes`), later rounds group
      the compact old-root list by new label (`_rlist_sizes`; a new
      component is a disjoint union of old ones).
  The number of components drops ~4x per round, so the compact pools
  shrink as stage G runs.

  STAGE 2 — compact rounds once the boundary-edge set is small. Live
  boundary edges are extracted by a chunked sort and *deduplicated to the
  minimum edge per component pair* — lossless for Boruvka: only a pair's
  min edge can ever be selected, and after any merge the min over a merged
  pair-set is the min of pair minima. Rounds sort the deduped edge list by
  (component, w, eid) (the DPP schedule, cheap at this size), evaluate the
  predicate on run heads, hook/flatten on a compacted component list, and
  relabel. Capacities shrink geometrically across sub-stages. The min-size
  post-pass runs in the same representation.

  FINAL — each component's final root is scattered onto its root pixel and
  value-flooded to the rest of the component.

Component ids are canonical min-vertex labels throughout; the partition is
representative-independent (tie-breaks use canonical edge ids; the predicate
uses size/Int only), which is what makes gossip/compact/atomic/oracle all
partition-equal.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SegmentationConfig
from ..ops import filters
from ..ops import grid_graph as gg
from ..ops import tilepass
from ..ops.primitives import INT32_MAX

# Host int, deliberately NOT jnp.int32: a module-level eager jnp scalar
# lives on the default device and every jit lowering that closes over it
# pays a device->host fetch.
BIGDIST = 1 << 30


def _gate_div_q() -> int:
    """Quality-mode gossip->stage-2 handoff density (default V/32). The
    bucket ramp makes quality gossip run >= nb rounds; stage 2 implements
    the same ramp natively on live-priced pools. GSEG_GATE_DIV_Q
    overrides."""
    return int(os.environ.get("GSEG_GATE_DIV_Q", "32"))


def _gate_div() -> int:
    """Speed-mode stage-G -> stage-2 handoff density: gossip rounds run
    until C <= V/div. An earlier handoff trades late gossip floods for
    compact rounds at a denser boundary; GSEG_GATE_DIV overrides, and
    capacities downstream scale with it."""
    return int(os.environ.get("GSEG_GATE_DIV", "128"))


def _peel_sizes() -> str:
    """Sizes scheme for the speed-mode peel rounds (rounds 1-2):

    - "subsum": BFS-dist rides the flood (3 rw fields) + parent-tree
      convergecast (its own fixpoint).
    - "count":  dist-free flood (2 rw fields) + one flat counting
      scatter-add.

    GSEG_PEEL_SIZES overrides."""
    sizes = os.environ.get("GSEG_PEEL_SIZES", "subsum")
    if sizes not in ("subsum", "count"):
        raise ValueError(f"GSEG_PEEL_SIZES={sizes!r}: expected subsum|count")
    return sizes


def _fixpoints(comm=None):
    """Tile-pass kernels for the dense fixpoints, or None for the XLA
    sweeps. By platform: the kernels on the GPU, the sweeps on the CPU
    (the test backend and the reference), an error elsewhere. The spatial
    path (comm.dense False) keeps the sweeps, which carry its halo
    exchange."""
    if comm is not None and not comm.dense:
        return None
    return tilepass if tilepass.use_kernels(jax.default_backend()) else None


def _shift(x, dy, dx, fill):
    return gg.shift_plane(x, dy, dx, fill)


def _shifts8(x, fill):
    return [_shift(x, dy, dx, fill) for dy, dx in gg.DIRS8]


class Comm(NamedTuple):
    """Communication hooks for the XLA sweep helpers.

    The dense default runs everything on one device. parallel/turbo_spatial
    substitutes halo-exchange shifts (`lax.ppermute` row halos across a
    row-sharded mesh) and `psum` reductions, turning the same sweep code
    into the explicit-collectives multi-chip path (SURVEY.md §7 Layer F).
    `dense` gates the Pallas kernels (single-device layout only).
    """
    shift: object       # (x, dy, dx, fill) -> plane
    shifts8: object     # (x, fill) -> list of 8 planes (DIRS8 order)
    reduce_any: object  # () bool local -> () bool global
    reduce_sum: object  # () int local -> () int global
    dense: bool


_DENSE_COMM = Comm(
    shift=_shift, shifts8=_shifts8,
    reduce_any=lambda x: x, reduce_sum=lambda x: x, dense=True,
)


# ---------------------------------------------------------------------------
# Stage G: gossip rounds
# ---------------------------------------------------------------------------


# Overflow / unconvergence flag bits (returned next to the labels; the
# public wrapper raises or falls back on nonzero — silent truncation is
# never allowed to corrupt a result).
FLAG_GOSSIP_UNCONVERGED = 1   # a stage-G sweep fixpoint hit its sweep cap
FLAG_PAIR_OVERFLOW = 2        # extracted pair count exceeded pair_cap
FLAG_COMP_OVERFLOW = 4        # live component heads exceeded comp_cap
FLAG_RECOMPACT_OVERFLOW = 8   # deduped pairs exceeded the recompact cap
FLAG_ITERS_EXHAUSTED = 16     # stage-2 exited its round budget unconverged


class GossipState(NamedTuple):
    L: jnp.ndarray       # (H, W) int32 canonical labels (min vertex id)
    S: jnp.ndarray       # (H, W) int32 component size at the root pixel
    #                      (other pixels: any value <= the root's — the
    #                      next compmin max-ride replicates the root value)
    ID: jnp.ndarray      # (H, W) float32 Int(C), replicated
    merged: jnp.ndarray  # () bool
    it: jnp.ndarray      # () int32
    bucket: jnp.ndarray  # () int32 weight-bucket index (quality mode)
    flags: jnp.ndarray   # () int32 FLAG_* bits accumulated so far


def bucket_thresholds(weights: jnp.ndarray, num_buckets: int) -> jnp.ndarray:
    """jnp mirror of models.boruvka_cpu.bucket_thresholds_np (same sample,
    same ordering arithmetic, so bucketed runs stay oracle-comparable)."""
    flat = jnp.stack([weights[d] for d in range(4)], axis=-1).reshape(-1)
    stride = max(flat.shape[0] // 65536, 1)
    sample = flat[::stride][:65536]
    sample = jnp.where(jnp.isfinite(sample), sample, jnp.inf)
    sample = jnp.sort(sample)
    n = sample.shape[0]
    n_fin = jnp.sum(jnp.isfinite(sample).astype(jnp.int32))
    bs = jnp.arange(num_buckets, dtype=jnp.int32)
    idx = jnp.clip(((bs + 1) * n_fin) // num_buckets - 1, 0,
                   jnp.maximum(n_fin - 1, 0))
    out = sample[jnp.clip(idx, 0, n - 1)]
    return out.at[num_buckets - 1].set(jnp.inf)


def _vertex_min_outgoing(L, w8, eid8, tau=jnp.inf, comm=_DENSE_COMM):
    nbrL = jnp.stack(comm.shifts8(L, -1))
    outgoing = jnp.logical_and(nbrL != L[None], w8 <= tau)
    w = jnp.where(outgoing, w8, jnp.inf)
    vminw = jnp.min(w, axis=0)
    cand = jnp.where(w == vminw[None], eid8, INT32_MAX)
    veid = jnp.min(cand, axis=0)
    veid = jnp.where(jnp.isfinite(vminw), veid, INT32_MAX)
    return vminw, veid, nbrL


def _compmin_gossip(L, bw, be, sz, max_sweeps, comm=_DENSE_COMM, idle=None):
    """Lexmin (bw, be) + max (sz) propagation among same-L neighbors.

    idle: optional traced () bool — True when the inputs are the fixpoint
    by construction (round 1: all-singleton L has no same-label edges), so
    the sweep loop is skipped entirely."""
    def sweep(st):
        bw, be, sz, _, i = st
        nL = comm.shifts8(L, -1)
        nbw = comm.shifts8(bw, jnp.inf)
        nbe = comm.shifts8(be, INT32_MAX)
        nsz = comm.shifts8(sz, 0)
        bw0, be0, sz0 = bw, be, sz
        for d in range(8):
            same = nL[d] == L
            take = same & ((nbw[d] < bw) | ((nbw[d] == bw) & (nbe[d] < be)))
            bw = jnp.where(take, nbw[d], bw)
            be = jnp.where(take, nbe[d], be)
            sz = jnp.where(same & (nsz[d] > sz), nsz[d], sz)
        changed = comm.reduce_any(
            jnp.any((bw0 != bw) | (be0 != be) | (sz0 != sz))
        )
        return bw, be, sz, changed, i + jnp.int32(1)

    go = jnp.bool_(True) if idle is None else jnp.logical_not(idle)
    st = (bw, be, sz, go, jnp.int32(0))
    st = jax.lax.while_loop(lambda s: s[3] & (s[4] < max_sweeps), sweep, st)
    # st[3] still True at exit <=> the sweep cap ended the loop unconverged.
    return st[0], st[1], st[2], st[3]


def _label_gossip(L, allow8, idf, dist, max_sweeps, comm=_DENSE_COMM):
    """Min-label flood over allowed adjacency; Int max-gossip and BFS dist
    ride along in the same fixpoint.

    dist semantics: adopting a strictly smaller label overwrites dist with
    the source neighbor's dist+1; equal labels relax (min). Staleness
    argument for exactness at the fixpoint: labels only decrease, so if a
    pixel's final label came from neighbor n, n's label never dropped below
    it afterwards (else the pixel would have adopted again) — n's dist at
    the fixpoint under-bounds the stored dist, and the relax rule closes the
    gap, so dist converges to the exact BFS level from the new cluster root
    over the flood adjacency."""
    def sweep(st):
        Lc, idf, dist, _, i = st
        nL = comm.shifts8(Lc, INT32_MAX)
        nid = comm.shifts8(idf, 0.0)
        nds = comm.shifts8(dist, BIGDIST)
        L0, id0, d0 = Lc, idf, dist
        for d in range(8):
            cand = jnp.where(nds[d] >= BIGDIST, BIGDIST, nds[d] + 1)
            adopt = allow8[d] & (nL[d] < Lc)
            relax = allow8[d] & (nL[d] == Lc) & (cand < dist)
            dist = jnp.where(adopt | relax, cand, dist)
            Lc = jnp.where(adopt, nL[d], Lc)
            idf = jnp.where(allow8[d] & (nid[d] > idf), nid[d], idf)
        changed = comm.reduce_any(
            jnp.any((L0 != Lc) | (id0 != idf) | (d0 != dist))
        )
        return Lc, idf, dist, changed, i + jnp.int32(1)

    st = (L, idf, dist, jnp.bool_(True), jnp.int32(0))
    st = jax.lax.while_loop(lambda s: s[3] & (s[4] < max_sweeps), sweep, st)
    return st[0], st[1], st[2], st[3]


def _label_gossip_nd(L, allow8, idf, max_sweeps, comm=_DENSE_COMM):
    """Dist-free min-label flood (+ Int max ride). Used by the dense rounds
    that size components via the root list instead of the BFS convergecast
    — one read-write field fewer per step."""
    def sweep(st):
        Lc, idf, _, i = st
        nL = comm.shifts8(Lc, INT32_MAX)
        nid = comm.shifts8(idf, 0.0)
        L0, id0 = Lc, idf
        for d in range(8):
            adopt = allow8[d] & (nL[d] < Lc)
            Lc = jnp.where(adopt, nL[d], Lc)
            idf = jnp.where(allow8[d] & (nid[d] > idf), nid[d], idf)
        changed = comm.reduce_any(jnp.any((L0 != Lc) | (id0 != idf)))
        return Lc, idf, changed, i + jnp.int32(1)

    st = (L, idf, jnp.bool_(True), jnp.int32(0))
    st = jax.lax.while_loop(lambda s: s[2] & (s[3] < max_sweeps), sweep, st)
    return st[0], st[1], st[2]


def _build_rlist(L, cap: int):
    """Compact list of root-pixel flat ids (canonical labels: a root is the
    pixel whose flat index equals its label). Returns ((cap,) ids with
    INT32_MAX dead slots, overflow)."""
    v = L.size
    flat = jnp.arange(v, dtype=jnp.int32)
    key = jnp.where(L.reshape(-1) == flat, flat, INT32_MAX)
    srt = jax.lax.sort((key,))[0]
    if cap >= v:
        pad = jnp.full((cap - v,), INT32_MAX, jnp.int32)
        return jnp.concatenate([srt, pad]), jnp.bool_(False)
    return srt[:cap], srt[cap] != INT32_MAX


def _sum_by_label(lab, val, h, w):
    """Sum `val` grouped by `lab` (labels are root-pixel flat ids;
    INT32_MAX = dead) -> ((H, W) plane with each group's total at its root
    pixel / 0 elsewhere, sorted-unique label list (INT32_MAX dead)).
    One pool-sized sort + segmented scan + pool-sized scatter."""
    v = h * w
    s_lab, s_sz = jax.lax.sort((lab, val), num_keys=1)
    head = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), s_lab[1:] != s_lab[:-1]]
    )
    tail = jnp.concatenate(
        [s_lab[1:] != s_lab[:-1], jnp.ones((1,), jnp.bool_)]
    )

    def comb(a, b):
        va, ha = a
        vb, hb = b
        return jnp.where(hb, vb, va + vb), ha | hb

    acc, _ = jax.lax.associative_scan(comb, (s_sz, head))
    live_tail = tail & (s_lab != INT32_MAX)
    S = jnp.zeros((v,), jnp.int32).at[
        jnp.where(live_tail, s_lab, v)
    ].set(acc, mode="drop").reshape(h, w)
    roots = jnp.where(head & (s_lab != INT32_MAX), s_lab, INT32_MAX)
    return S, roots


def _rlist_sizes(rlist, Lnew, S_old):
    """Exact new-component sizes from the old-root list.

    Each new component is a disjoint union of old components, so its size
    is the sum of the old roots' S values grouped by the old roots' NEW
    label — one (cap,)-sized sort + segmented scan, no per-pixel work and
    no diameter dependence. Returns (S plane: exact size at each new root
    pixel / 0 elsewhere, new rlist). The list only shrinks (a flood's
    cluster root is the min old label, itself an old root), so capacity is
    checked once at creation."""
    h, w = Lnew.shape
    alive = rlist != INT32_MAX
    safe = jnp.where(alive, rlist, 0)
    Lr = jnp.where(alive, Lnew.reshape(-1)[safe], INT32_MAX)
    Sr = jnp.where(alive, S_old.reshape(-1)[safe], 0)
    return _sum_by_label(Lr, Sr, h, w)


def _flood_pointer(L, id_init, pass8, nbrL, rlist):
    """Pool-level replacement for the dist-free label flood (rlist rounds).

    The flood computes, per pixel, the min OLD root label over the merge
    graph (same-old-label edges + passed hook edges) with a max id_init
    ride. Each component contributes at most its own min edge, so the
    cross-label merge graph is the functional hook graph {a -> S(a)} on
    roots — cycles are length-2 only (strictly decreasing (w, eid) around
    any longer cycle). That resolves at POOL scale in log-depth pool-sized
    gathers instead of tens of sponge-diameter wavefront passes:

      1. S(a): one dense scatter-min of the pass8 owners' partner labels
         (pass8 is ownership-directional — only a's own min-edge pixel
         scatters into slot a, so no cross-edge corruption);
      2. 2-cycle break to the min endpoint + pointer doubling on the
         rlist pool;
      3. min old root id per hook tree (pool scatter-min);
      4. pixels resolve with ONE V-gather each for Lnew and IDnew.

    Exactness: new label = min old root id of the merged set = the flood
    fixpoint; IDnew = max over merged set of per-old-component id_init
    max = the flood's max ride. Returns (Lnew, IDnew, unconverged).
    """
    h, w = L.shape
    v = h * w
    cap = rlist.shape[0]
    # 1. partner of each component's own min edge, dense -> root slots.
    partner = jnp.full((h, w), INT32_MAX, jnp.int32)
    for d in range(8):
        partner = jnp.where(pass8[d], jnp.minimum(partner, nbrL[d]),
                            partner)
    S0 = jnp.full((v,), INT32_MAX, jnp.int32).at[L.reshape(-1)].min(
        partner.reshape(-1), mode="drop")

    # 2. pool views. Every live root is an rlist entry (overflow was
    # flagged at build), and every S0 value is a live root id.
    alive = rlist != INT32_MAX
    self_id = jnp.where(alive, rlist, 0)
    inv = jnp.zeros((v,), jnp.int32).at[
        jnp.where(alive, rlist, v)
    ].set(jnp.arange(cap, dtype=jnp.int32), mode="drop")
    sp = S0[self_id]
    sp = jnp.where(alive & (sp != INT32_MAX), sp, self_id)  # self if none
    # 2-cycle break: mutual hooks keep the min endpoint as root.
    s2 = sp[inv[sp]]
    par = jnp.where(s2 == self_id, jnp.minimum(self_id, sp), sp)

    def dbl_cond(st):
        return st[1] & (st[2] < jnp.int32(24))

    def dbl_body(st):
        p, _, i = st
        pn = p[inv[p]]
        return pn, jnp.any(pn != p), i + jnp.int32(1)

    par, changed, _ = jax.lax.while_loop(
        dbl_cond, dbl_body, (par, jnp.bool_(True), jnp.int32(0))
    )
    unconv = changed  # 2^24 pool-pointer depth exceeded (never in practice)

    # 3. min old root id per hook tree, then per-slot new label.
    minid = jnp.full((v,), INT32_MAX, jnp.int32).at[
        jnp.where(alive, par, v)
    ].min(self_id, mode="drop")
    nl = minid[par]
    newlab_tab = jnp.zeros((v,), jnp.int32).at[
        jnp.where(alive, rlist, v)
    ].set(nl, mode="drop")

    # 4. pixel resolution + id ride.
    Lnew = newlab_tab[L.reshape(-1)].reshape(h, w)
    idtab = jnp.zeros((v,), jnp.float32).at[L.reshape(-1)].max(
        id_init.reshape(-1), mode="drop")
    idt2 = jnp.zeros((v,), jnp.float32).at[
        jnp.where(alive, nl, v)
    ].max(idtab[self_id], mode="drop")
    IDnew = idt2[Lnew.reshape(-1)].reshape(h, w)
    return Lnew, IDnew, unconv


def _component_sizes(L):
    """Exact per-component pixel counts for the peel rounds: one flat
    counting scatter-add keyed by label (diameter-independent, no
    capacity). The peel states have ~V/4 components, where any pool
    representation is pixel-scale anyway; rounds 3+ use the root-list
    grouping. Returns ((H, W) plane: size at root pixel / 0 elsewhere,
    overflow=False)."""
    h, w = L.shape
    v = h * w
    S = jnp.zeros((v,), jnp.int32).at[L.reshape(-1)].add(
        1, mode="drop"
    ).reshape(h, w)
    S = jnp.where(L == jnp.arange(v, dtype=jnp.int32).reshape(h, w), S, 0)
    return S, jnp.bool_(False)


def _value_flood(L, val, max_sweeps, comm=_DENSE_COMM):
    """Min-value broadcast within same-L regions (XLA sweeps).
    Returns (val, unconverged)."""
    def sweep(st):
        val, _, i = st
        nL = comm.shifts8(L, -1)
        nv = comm.shifts8(val, INT32_MAX)
        v0 = val
        for d in range(8):
            val = jnp.where((nL[d] == L) & (nv[d] < val), nv[d], val)
        return val, comm.reduce_any(jnp.any(v0 != val)), i + jnp.int32(1)

    val, unconv, _ = jax.lax.while_loop(
        lambda s: s[1] & (s[2] < max_sweeps), sweep,
        (val, jnp.bool_(True), jnp.int32(0)),
    )
    return val, unconv


def _flood_values(L, val, max_sweeps):
    """`_value_flood` on the platform's implementation (see _fixpoints)."""
    fp = _fixpoints()
    if fp is not None:
        return fp.value_flood(L, val, max_sweeps)
    return _value_flood(L, val, max_sweeps)


def _subtree_sizes(L, dist, max_sweeps, comm=_DENSE_COMM):
    """Exact component pixel-count at the canonical root pixel, given the
    converged BFS levels from the root (computed during the label flood).

    parent directions -> iterated subtree sums. s(root) converges to |C| in
    tree-depth sweeps; all dense. Returns (sizes, unconverged).
    """
    pdir = _parent_dirs(L, dist, comm)
    s0 = jnp.ones(L.shape, jnp.int32)
    fp = _fixpoints(comm)
    if fp is not None:
        return fp.subtree_sums(pdir, s0, max_sweeps)
    return _subtree_sweeps(pdir, s0, max_sweeps, comm)


def _parent_dirs(L, dist, comm=_DENSE_COMM):
    """Parent direction per pixel: the first dir whose same-L neighbor has
    dist == mine - 1; 8 = root / none."""
    nL = comm.shifts8(L, -1)
    nd = comm.shifts8(dist, BIGDIST)
    pdir = jnp.full(L.shape, jnp.int32(8))
    for d in range(7, -1, -1):
        ok = (nL[d] == L) & (nd[d] == dist - 1) & (dist > 0) & (dist < BIGDIST)
        pdir = jnp.where(ok, jnp.int32(d), pdir)
    return pdir


def _subtree_sweeps(pdir, s, max_sweeps, comm=_DENSE_COMM):
    """Iterated subtree sums s <- 1 + sum over children (XLA sweeps).
    Returns (sums, unconverged)."""
    rev = [4, 5, 6, 7, 0, 1, 2, 3]  # reverse direction index

    def ssweep(st):
        s, _, i = st
        ns = comm.shifts8(s, 0)
        npd = comm.shifts8(pdir, 8)
        total = jnp.ones_like(s)
        for d in range(8):
            child = npd[d] == rev[d]
            total = total + jnp.where(child, ns[d], 0)
        return (total, comm.reduce_any(jnp.any(total != s)),
                i + jnp.int32(1))

    s, sub_unconv, _ = jax.lax.while_loop(
        lambda st: st[1] & (st[2] < max_sweeps), ssweep,
        (s, jnp.bool_(True), jnp.int32(0)),
    )
    return s, sub_unconv


def _ground(state: GossipState, w8, eid8, vid, k, min_size, mode, max_sweeps,
            tau=jnp.inf, comm=_DENSE_COMM, rlist=None, sizes="subsum",
            idle_compmin=None):
    """One gossip Boruvka round. Sizes schemes:

    - sizes="subsum" (spatial comm mode): BFS-dist rides the flood, sizes
      via the parent-tree convergecast — works under halo exchange.
    - sizes="count" (dense peel rounds): dist-free flood; exact sizes by
      a flat counting scatter-add (`_component_sizes`, capacity-free).
    - sizes="rlist" (dense rounds 3+): dist-free flood; sizes by grouping
      the compact old-root list (`rlist`) — returns (state, new rlist).

    idle_compmin: optional traced () bool from callers whose round-1 entry
    state is all-singleton (every _stage_g-style loop: L=vid, S=1 at
    it==0). A singleton label map has no same-label edges, so the compmin
    fixpoint is the identity — the flag skips its full-image certificate
    pass.
    """
    L, S, ID = state.L, state.S, state.ID
    fp = _fixpoints(comm)

    vminw, veid, nbrL = _vertex_min_outgoing(L, w8, eid8, tau, comm)
    if fp is not None:
        cw, ce, SZ, unconv = fp.compmin(L, vminw, veid, S, max_sweeps,
                                        idle=idle_compmin)
    else:
        cw, ce, SZ, unconv = _compmin_gossip(
            L, vminw, veid, S, max_sweeps, comm, idle=idle_compmin
        )

    if mode == "felz":
        # Multiply-form predicate (w - Int)*|C| <= k — division-free so
        # every backend rounds identically (an accelerator's f32 divide need
        # not be IEEE-exact; see models/boruvka_cpu.py). Costs one extra
        # 8-shift plane sweep (Int
        # and size shift separately where the old form shifted one fused
        # thr plane); the 0.0 fills make boundary lanes vacuously true,
        # masked by owner8.
        kf = jnp.float32(k)
        SZf = SZ.astype(jnp.float32)
        my_ok = (cw - ID) * SZf <= kf
        ID8 = jnp.stack(comm.shifts8(ID, 0.0))
        SZ8 = jnp.stack(comm.shifts8(SZf, 0.0))
    else:  # minsize
        my_ok = SZ < min_size

    owner8 = (nbrL != L[None]) & (w8 == cw[None]) & (eid8 == ce[None])
    if mode == "felz":
        pass8 = owner8 & my_ok[None] & ((cw[None] - ID8) * SZ8 <= kf)
    else:
        pass8 = owner8 & my_ok[None]

    new_marks = []
    for dc, (dy, dx) in enumerate(gg.DIRS4):
        m = pass8[dc] | comm.shift(pass8[dc + 4], dy, dx, False)
        new_marks.append(m)
    new_mark4 = jnp.stack(new_marks)
    merged = comm.reduce_any(jnp.any(new_mark4))

    allow = []
    for d in range(8):
        if d < 4:
            am = new_mark4[d]
        else:
            dy, dx = gg.DIRS4[d - 4]
            am = comm.shift(new_mark4[d - 4], -dy, -dx, False)
        allow.append((nbrL[d] == L) | am)
    allow8 = jnp.stack(allow)

    hook8 = allow8 & (nbrL != L[None])
    used_w8 = jnp.where(hook8, jnp.where(jnp.isfinite(w8), w8, 0.0), 0.0)
    id_init = jnp.maximum(ID, jnp.max(used_w8, axis=0))

    if sizes in ("rlist", "count"):
        # dist-free flood (the dense schemes).
        if (sizes == "rlist" and comm.dense and rlist is not None
                and os.environ.get("GSEG_FLOOD_PTR", "0") == "1"):
            # pool pointer resolution instead of the wavefront flood
            # (diameter-independent; see _flood_pointer). Default-off
            # measurement knob.
            Lnew, IDnew, lab_unconv = _flood_pointer(
                L, id_init, pass8, nbrL, rlist)
        elif fp is not None:
            Lnew, IDnew, lab_unconv = fp.label(L, allow8, id_init,
                                               max_sweeps)
        else:
            Lnew, IDnew, lab_unconv = _label_gossip_nd(
                L, allow8, id_init, max_sweeps, comm
            )
        unconv = unconv | lab_unconv
        if sizes == "rlist":
            Snew, rlist_new = _rlist_sizes(rlist, Lnew, S)
            size_ovf = jnp.bool_(False)
        else:
            Snew, size_ovf = _component_sizes(Lnew)
            rlist_new = None
        flags = state.flags | jnp.where(
            unconv, jnp.int32(FLAG_GOSSIP_UNCONVERGED), jnp.int32(0)
        ) | jnp.where(
            size_ovf, jnp.int32(FLAG_COMP_OVERFLOW), jnp.int32(0)
        )
        out = GossipState(
            L=Lnew, S=Snew, ID=IDnew, merged=merged,
            it=state.it + jnp.int32(1), bucket=state.bucket, flags=flags,
        )
        return (out, rlist_new) if sizes == "rlist" else out

    # BFS dist rides the flood: seeded 0 at current roots; the new cluster
    # root (an old root that keeps its label) retains 0, absorbed roots get
    # overwritten on adoption.
    dist0 = jnp.where(L == vid, jnp.int32(0), BIGDIST)
    if fp is not None:
        Lnew, IDnew, dist, lab_unconv = fp.label_dist(
            L, allow8, id_init, dist0, max_sweeps)
    else:
        Lnew, IDnew, dist, lab_unconv = _label_gossip(
            L, allow8, id_init, dist0, max_sweeps, comm
        )

    Snew, size_unconv = _subtree_sizes(Lnew, dist, max_sweeps, comm)

    unconv = unconv | lab_unconv | size_unconv
    flags = state.flags | jnp.where(
        unconv, jnp.int32(FLAG_GOSSIP_UNCONVERGED), jnp.int32(0)
    )
    return GossipState(
        L=Lnew, S=Snew, ID=IDnew, merged=merged, it=state.it + jnp.int32(1),
        bucket=state.bucket, flags=flags,
    )


# ---------------------------------------------------------------------------
# Stage 2: compact rounds
# ---------------------------------------------------------------------------


class CompactState(NamedTuple):
    esrc: jnp.ndarray   # (E,) int32 current comp label of endpoint a
    edst: jnp.ndarray   # (E,) int32
    ew: jnp.ndarray     # (E,) float32 (+inf dead)
    eeid: jnp.ndarray   # (E,) int32 canonical edge id (global tie-break)
    SZf: jnp.ndarray    # (V,) int32 sizes at root slots
    IDf: jnp.ndarray    # (V,) float32 Int at root slots
    fin: jnp.ndarray    # (C,) int32 current root of each initial root
    merged: jnp.ndarray
    it: jnp.ndarray
    bucket: jnp.ndarray  # () int32 weight-bucket index (quality mode)
    phase: jnp.ndarray   # () int32: 0 = felz rounds, 1 = min-size rounds
    flags: jnp.ndarray   # () int32 FLAG_* bits accumulated so far


def _select_compact(mask, keys, cap):
    """Move masked entries to the front (stable) and slice to `cap`.

    Heads after a segmented sort sit ~one per run — too dense for block
    compaction — so compact with one more sort on (dead, position): sorts
    keep the order stable without a V-sized scatter.
    Returns (out_mask (cap,), [outs], overflow).
    """
    n = mask.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    dead = jnp.where(mask, jnp.int32(0), jnp.int32(1))
    out = jax.lax.sort((dead, pos) + tuple(keys), num_keys=2)
    live_total = jnp.sum(mask.astype(jnp.int32))
    outs = [o[:cap] for o in out[2:]]
    out_mask = out[0][:cap] == 0
    return out_mask, outs, live_total > cap


def _pair_dedup(esrc, edst, ew, eid, cap):
    """Keep only the min (w, eid) edge per directed (src, dst) pair.

    Lossless for Boruvka (see module docstring). Orders pairs by
    (src, dst, w, eid); pair-run heads survive. Returns arrays of size cap.
    """
    live = (esrc != edst) & jnp.isfinite(ew)
    k1 = jnp.where(live, esrc, INT32_MAX)
    k2 = jnp.where(live, edst, INT32_MAX)
    s1, s2, sw, se = jax.lax.sort((k1, k2, ew, eid), num_keys=4)
    head = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), (s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1])]
    ) & (s1 != INT32_MAX)
    m, (o1, o2, ow, oe), ovf = _select_compact(head, [s1, s2, sw, se], cap)
    o1 = jnp.where(m, o1, 0)
    o2 = jnp.where(m, o2, 0)
    ow = jnp.where(m, ow, jnp.inf)
    return o1, o2, ow, oe, ovf


def _s2_round(st: CompactState, v, comp_cap, k, min_size, is_felz,
              tau=jnp.inf, canonical: bool = True):
    """One compact round. is_felz: traced bool — predicate-gated felz round
    vs min-size round (one compiled body serves both phases).

    canonical (static): relabel each merged cluster to its minimum member
    root (turbo's canonical min-vertex labels) vs keep the hook-chain sink
    root (the atomic/oracle root-id convention — used by the fastmst DPP
    path so all three parallel schedules emit byte-identical labels)."""
    esrc, edst, ew = st.esrc, st.edst, st.ew
    tau_eff = jnp.where(is_felz, tau, jnp.inf)
    live = (esrc != edst) & jnp.isfinite(ew) & (ew <= tau_eff)
    k1 = jnp.where(live, esrc, INT32_MAX)
    kw = jnp.where(live, ew, jnp.inf)
    s_src, s_w, s_eid, s_dst = jax.lax.sort(
        (k1, kw, st.eeid, edst), num_keys=3
    )
    head = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), s_src[1:] != s_src[:-1]]
    ) & (s_src != INT32_MAX)

    hm, (hsrc, hw, hdst), head_ovf = _select_compact(
        head, [s_src, s_w, s_dst], comp_cap
    )

    # Multiply-form predicate (see models/boruvka_cpu.py): division-free,
    # bit-identical decisions across backends. Same gathers as before.
    kf = jnp.float32(k)
    lhs_s = (hw - st.IDf[hsrc]) * st.SZf[hsrc].astype(jnp.float32)
    lhs_d = (hw - st.IDf[hdst]) * st.SZf[hdst].astype(jnp.float32)
    ok = jnp.where(
        is_felz, (lhs_s <= kf) & (lhs_d <= kf), st.SZf[hsrc] < min_size
    )
    hook = hm & ok

    succ = jnp.where(hook, hdst, hsrc)
    hsrc_safe = jnp.where(hm, hsrc, v)
    iota = jnp.arange(v, dtype=jnp.int32)
    S = iota.at[hsrc_safe].set(succ, mode="drop")
    s2 = S[succ]
    mutual = (s2 == hsrc) & (succ != hsrc)
    succ = jnp.where(mutual & (hsrc < succ), hsrc, succ)

    # Resolve hook chains by pointer-doubling the successor map itself in
    # COMPACT index space (comp_cap-sized gathers per step, like the old
    # single-step walk, but covering depth 2^i after i steps — decreasing-
    # weight min-size chains can be thousands deep). Label -> head-slot via
    # one comp_cap-lane scatter; labels hooked to a non-head (only possible
    # under head overflow, which is flagged) resolve to themselves.
    cap = hsrc.shape[0]
    cidx = jnp.arange(cap, dtype=jnp.int32)
    hidx = jnp.full((v,), INT32_MAX, jnp.int32).at[hsrc_safe].set(
        cidx, mode="drop"
    )
    csucc_raw = hidx[jnp.where(hm, succ, 0)]
    csucc = jnp.where(
        hm & (succ != hsrc) & (csucc_raw != INT32_MAX), csucc_raw, cidx
    )
    max_doubles = max(int(cap).bit_length() + 1, 4)

    def dcond(c):
        return c[1] & (c[2] < max_doubles)

    def dbody(c):
        p, _, i = c
        p2 = p[p]
        return p2, jnp.any(p2 != p), i + jnp.int32(1)

    croot, _, _ = jax.lax.while_loop(
        dcond, dbody, (csucc, jnp.bool_(True), jnp.int32(0))
    )
    nr = hsrc[croot]

    if canonical:
        # canonical min-vertex representative: nr is the hook-chain sink;
        # relabel the cluster to its min member root: scatter-min member
        # ids keyed by sink.
        canon = jnp.full((v,), INT32_MAX, jnp.int32).at[
            jnp.where(hm, nr, v)
        ].min(jnp.where(hm, hsrc, INT32_MAX), mode="drop")
        nr_canon = jnp.where(hm, canon[nr], hsrc)
    else:
        nr_canon = nr  # hook-sink roots (atomic/oracle id convention)
    changed = hm & (nr_canon != hsrc)

    M = iota.at[hsrc_safe].set(nr_canon, mode="drop")

    tgt = jnp.where(changed, nr_canon, v)
    SZf = st.SZf.at[tgt].add(jnp.where(changed, st.SZf[hsrc], 0), mode="drop")
    IDf = st.IDf.at[tgt].max(jnp.where(changed, st.IDf[hsrc], 0.0), mode="drop")
    # used hook edges contribute their weight to the new root's Int.
    used = hm & (succ != hsrc)
    tgt_u = jnp.where(used, nr_canon, v)
    IDf = IDf.at[tgt_u].max(jnp.where(used, hw, 0.0), mode="drop")

    esrc = M[esrc]
    edst = M[edst]
    fin = M[st.fin]

    flags = st.flags | jnp.where(
        head_ovf, jnp.int32(FLAG_COMP_OVERFLOW), jnp.int32(0)
    )
    return CompactState(
        esrc=esrc, edst=edst, ew=st.ew, eeid=st.eeid, SZf=SZf, IDf=IDf,
        fin=fin, merged=jnp.any(changed), it=st.it + jnp.int32(1),
        bucket=st.bucket, phase=st.phase, flags=flags,
    )


def _s2_phase(st: CompactState, v, comp_cap, k, min_size, max_iters,
              thresholds, nb, with_minsize: bool,
              flag_exhaustion: bool = True, canonical: bool = True):
    """Felz rounds to convergence, then (optionally) min-size rounds, in ONE
    while_loop: st.phase flips 0 -> 1 when felz converges with all buckets
    open. One loop = one compiled round body for both phases.
    flag_exhaustion=False for deliberately round-capped warmup phases (the
    pre-recompaction pass), where hitting the cap is the design."""

    def cond(s):
        return s.merged & (s.it < max_iters)

    def body(s):
        is_felz = s.phase == 0
        tau = thresholds[s.bucket]
        s2 = _s2_round(s, v, comp_cap, k, min_size, is_felz, tau=tau,
                       canonical=canonical)
        # bucket ramp (felz only)
        more_buckets = is_felz & (s.bucket + 1 < nb)
        s2 = s2._replace(
            bucket=jnp.where(is_felz,
                             jnp.minimum(s.bucket + 1, nb - 1), s.bucket),
            merged=s2.merged | more_buckets,
        )
        if with_minsize:
            flip = is_felz & ~s2.merged
            s2 = s2._replace(
                phase=jnp.where(flip, jnp.int32(1), s.phase),
                merged=s2.merged | flip,
            )
        return s2

    st = st._replace(merged=jnp.bool_(True), it=jnp.int32(0))
    st = jax.lax.while_loop(cond, body, st)
    if not flag_exhaustion:
        return st
    # merged still True at exit <=> the round budget ended the loop early.
    return st._replace(
        flags=st.flags
        | jnp.where(st.merged, jnp.int32(FLAG_ITERS_EXHAUSTED), jnp.int32(0))
    )


def _recompact_edges(st: CompactState, cap):
    """Dedup + shrink the edge buffers to a smaller capacity."""
    o1, o2, ow, oe, ovf = _pair_dedup(st.esrc, st.edst, st.ew, st.eeid, cap)
    return st._replace(esrc=o1, edst=o2, ew=ow, eeid=oe), ovf


def _prune_dead(st: CompactState, v, k, min_size):
    """Kill edges that can never participate in another merge (lossless).

    A component whose min outgoing weight exceeds its own threshold
    Int(C) + k/|C| is FROZEN: no felz merge can involve it again — the
    predicate needs w <= min(thr_src, thr_dst), every outgoing w exceeds
    its thr, and its thr can only change by merging (which therefore never
    happens while felz rounds run). A directed edge is dead when both
    endpoints are frozen AND the source is not small: min-size rounds
    (which ignore thresholds) only hook FROM small components, and any
    component that is small at any later round is a union of currently-
    small ones (size only grows), whose outgoing edges are all kept by
    the small-source term. Mostly a no-op on blob content (~13 frozen
    @1080p) — the insurance is for textured/photo content where many
    final-size components freeze while still adjacent.

    Returns st with dead edges' weights set to +inf (a following
    _recompact_edges drops them)."""
    live = (st.esrc != st.edst) & jnp.isfinite(st.ew)
    key = jnp.where(live, st.esrc, INT32_MAX)
    kw = jnp.where(live, st.ew, jnp.inf)
    s_src, s_w = jax.lax.sort((key, kw), num_keys=2)
    head = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), s_src[1:] != s_src[:-1]]
    ) & (s_src != INT32_MAX)
    minw = jnp.full((v + 1,), jnp.inf, jnp.float32).at[
        jnp.where(head, s_src, v)
    ].min(s_w, mode="drop")[:v]
    # Frozen iff the predicate can never pass: NOT((minw - Int)*|C| <= k) —
    # multiply form keeps this consistent with _s2_round's hook predicate
    # across backends (see models/boruvka_cpu.py). minw=inf (no outgoing
    # edge) gives inf > k: frozen, as before.
    frozen = (minw - st.IDf) * jnp.maximum(
        st.SZf.astype(jnp.float32), 1.0
    ) > jnp.float32(k)
    small = st.SZf < min_size
    # Droppable iff BOTH endpoints frozen and NEITHER endpoint small. An
    # edge from an UNFROZEN src to a frozen dst must be kept even though
    # that hook can never fire: it may be the src's min outgoing edge, and
    # Boruvka components propose ONLY their min edge — dropping it would
    # promote the next-best edge into the proposal slot and merge earlier
    # than the oracle. A frozen src's proposals all fail regardless
    # (every outgoing w >= minw > thr_src), so its edges to other frozen
    # components are semantically inert — EXCEPT as min-size hook targets:
    # small[edst] keeps the REVERSE edge of every possible min-size hook,
    # so the hook's target still appears as a source of a live edge and
    # therefore still gets a head slot in _s2_round (a hook into a comp
    # with no head slot resolves to self and silently no-ops — found as a
    # 20-seed parity failure: a pruned-to-edgeless frozen component next
    # to a size-1 component left the size-1 comp unmerged, violating
    # min_size and diverging from the oracle; test_prune_keeps_minsize_
    # hook_targets). The rule is endpoint-symmetric, so the two-orientation
    # pool stays orientation-symmetric: src's min edge live => the reverse
    # edge live => every hook target is a head.
    keep = (~(frozen[st.esrc] & frozen[st.edst])
            | small[st.esrc] | small[st.edst])
    return st._replace(ew=jnp.where(live & ~keep, jnp.inf, st.ew))


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


_RLIST_FLOOR = 16384  # min sliced root-list capacity (tests shrink it)

# Min pool/recompact capacity. At bench scale the v-proportional terms
# dominate and this floor is irrelevant; below ~131k px it swallows every
# cap, which is exactly why toy-shape CI missed the round-4 spatial
# quality recompact overflow — bench-scale capacity behavior is NOT
# reproducible in miniature (small images have proportionally fatter
# boundary pools), so the bench-scale runs of chip_smoke.py (540p-4K,
# one GPU and --four) are the regression gate for this class.
# Kept as one named constant (tests may still shrink it to probe
# overflow flagging at toy shapes).
_CAP_FLOOR = 16384


def _rlist_loop(gcond, gbody, gst, rlist, vid, rcap2):
    """Run the rlist-sized gossip rounds as two while_loops: full root-list
    capacity while the live root count exceeds `rcap2`, then a one-time
    sort-recompact of the list and the remaining rounds on the `rcap2`
    slice. `_rlist_sizes` cost is CAPACITY-priced (pool gathers/scatter
    + a pool sort per round), while live roots decay ~4x per
    round — the split makes the later rounds' pool machinery track the
    actual component count. Round semantics are phase-invariant: slicing
    is lossless once every live root fits the slice, and the component
    count only decreases, so the two-loop sequence executes exactly the
    rounds the single loop would. GSEG_RLIST_SPLIT=0 disables.
    """
    caps = rcap2 if isinstance(rcap2, (list, tuple)) else [rcap2]
    if os.environ.get("GSEG_RLIST_SPLIT", "1") != "1":
        return jax.lax.while_loop(gcond, gbody, (gst, rlist))
    caps = [c for c in caps if c < rlist.shape[0]]
    for cap in caps:
        def cond1(c, cap=cap):
            cnt = jnp.sum((c[0].L == vid).astype(jnp.int32))
            return gcond(c) & (cnt > cap)

        gst, rlist = jax.lax.while_loop(cond1, gbody, (gst, rlist))
        # The list is sorted-unique but NOT front-compacted (dead slots
        # stay interleaved where merged roots used to sit): one pool sort
        # moves the INT32_MAX dead slots to the tail, then the slice holds
        # every live root (cond1's exit guarantees live <= cap whenever
        # another round will run; if gcond is already false, the next
        # loop never reads the slice).
        rlist = jax.lax.sort((rlist,))[0][:cap]
    return jax.lax.while_loop(gcond, gbody, (gst, rlist))


def _stage_g(image: jnp.ndarray, cfg: SegmentationConfig, gossip_rounds: int,
             weights_override=None):
    """Smoothing + implicit graph + gossip rounds; returns (state, weights).

    weights_override: optional (4, H, W) float32 planes that REPLACE the
    smoothing + edge-weight computation. Testing hook: hardware parity
    checks feed bit-identical weights to this path and the NumPy oracle so
    the comparison isolates partition logic from legitimate cross-backend
    float ULP drift in the filter chain (FMA contraction and reduction
    order can move the smoothed values by a few ULP, which flips near-tie
    merges on some synthetic seeds).
    """
    h, w = image.shape[0], image.shape[1]
    v = h * w
    max_sweeps = 4 * (h + w)

    if weights_override is not None:
        weights = weights_override
    else:
        smoothed = filters.gaussian_smooth(image, cfg.sigma)
        weights, _ = gg.edge_weight_planes(
            smoothed, cfg.connectivity, cfg.quantize_weight_bits
        )
    w8, eid8 = gg.incident_views(weights)
    vid = jnp.arange(v, dtype=jnp.int32).reshape(h, w)

    nb = max(cfg.weight_buckets, 1)
    thresholds = (
        bucket_thresholds(weights, nb) if cfg.weight_buckets > 0
        else jnp.array([jnp.inf], dtype=jnp.float32)
    )

    gst = GossipState(
        L=vid, S=jnp.ones((h, w), jnp.int32), ID=jnp.zeros((h, w), jnp.float32),
        merged=jnp.bool_(True), it=jnp.int32(0), bucket=jnp.int32(0),
        flags=jnp.int32(0),
    )

    def advance(s, s2):
        # quality mode: the cap advances one bucket per round; keep looping
        # while buckets remain even if this round merged nothing.
        more = s.bucket + 1 < nb
        return s2._replace(
            bucket=jnp.minimum(s.bucket + 1, nb - 1),
            merged=s2.merged | more,
        )

    if cfg.weight_buckets > 0:
        # QUALITY MODE: cheapest-first merging grows thin high-diameter
        # components from round 1, so gossip uses the diameter-independent
        # machinery: two peeled rounds with counting-scatter sizes, then
        # dist-free floods with root-list sizes, handing off early at v/32.
        gate_c = v // _gate_div_q()

        def pcond(s):
            return s.merged & (s.it < 2)

        def pbody(s):
            return advance(s, _ground(
                s, w8, eid8, vid, cfg.k, cfg.min_size, "felz", max_sweeps,
                tau=thresholds[s.bucket], sizes="count",
                idle_compmin=s.it == 0,
            ))

        # two peel rounds in ONE while_loop (a single traced _ground body
        # instead of two unrolled copies — compile cost).
        gst = jax.lax.while_loop(pcond, pbody, gst)
        # the bucket ramp merges slowly by design: after two rounds the
        # component count can still be ~0.8 V (measured overflowing the
        # old v/2 cap at 1080p bench config), so the root list gets FULL
        # pixel capacity at every size; the tiered sliced loops below keep
        # the per-round _rlist_sizes cost tracking the live count as the
        # ramp merges.
        rcap = v
        rlist, rovf = _build_rlist(gst.L, rcap)
        gst = gst._replace(
            flags=gst.flags
            | jnp.where(rovf, jnp.int32(FLAG_COMP_OVERFLOW), jnp.int32(0))
        )

        def gcond(c):
            s = c[0]
            cnt = jnp.sum((s.L == vid).astype(jnp.int32))
            return s.merged & ((s.it < gossip_rounds) | (cnt > gate_c))

        def gbody(c):
            s, rl = c
            s2, rl2 = _ground(s, w8, eid8, vid, cfg.k, cfg.min_size,
                              "felz", max_sweeps, tau=thresholds[s.bucket],
                              rlist=rl, sizes="rlist")
            return advance(s, s2), rl2

        # tier ladder: each extra tier cuts per-round root-list cost while
        # live counts sit between tiers, but instantiates another loop's
        # round body (compile cost — default lean).
        tiers = [max(v // int(d), _RLIST_FLOOR)
                 for d in os.environ.get(
                     "GSEG_RLIST_TIERS_Q", "16").split(",")]
        gst, _ = _rlist_loop(gcond, gbody, gst, rlist, vid, tiers)
        return gst, weights, thresholds

    # PLAIN MODE. Diameters grow ~geometrically per round, and with them
    # the cost of the riding-BFS-dist + subtree-sum convergecast: rounds
    # 1-2 keep the convergecast (near-free at tiny diameters, no pool
    # machinery), rounds 3+ switch to the dist-free flood with exact sizes
    # grouped over the compact old-root list — the same scheme quality mode
    # uses, minus its bucket ramp. The V/128 gate keeps extraction away from
    # sponge-shaped components, whose boundary edges stay ~V at denser
    # handoffs.
    gate_c = v // _gate_div()

    def pcond(s):
        return s.merged & (s.it < 2)

    peel_sizes = _peel_sizes()

    def pbody(s):
        return advance(s, _ground(
            s, w8, eid8, vid, cfg.k, cfg.min_size, "felz", max_sweeps,
            tau=thresholds[s.bucket], sizes=peel_sizes,
            idle_compmin=s.it == 0,
        ))

    gst = jax.lax.while_loop(pcond, pbody, gst)
    # C after 2 speed rounds is ~V/13 on blob content (4x decay/round) but
    # content-dependent; V/4 bounds it with margin for noise-heavy inputs
    # (the rlist only shrinks after creation, and overflow is flagged).
    rcap = max(v // 4, _CAP_FLOOR)
    rlist, rovf = _build_rlist(gst.L, rcap)
    gst = gst._replace(
        flags=gst.flags
        | jnp.where(rovf, jnp.int32(FLAG_COMP_OVERFLOW), jnp.int32(0))
    )

    def gcond2(c):
        s = c[0]
        cnt = jnp.sum((s.L == vid).astype(jnp.int32))
        return s.merged & ((s.it < gossip_rounds) | (cnt > gate_c))

    def gbody2(c):
        s, rl = c
        s2, rl2 = _ground(s, w8, eid8, vid, cfg.k, cfg.min_size, "felz",
                          max_sweeps, tau=thresholds[s.bucket], rlist=rl,
                          sizes="rlist")
        return advance(s, s2), rl2

    gst, _ = _rlist_loop(gcond2, gbody2, gst, rlist, vid,
                         max(v // 32, _RLIST_FLOOR))
    return gst, weights, thresholds


def _chunked_pair_extract(lo, hi, w4, eid4, pair_cap, chunk=131072):
    """Extract + per-pair dedup the live boundary edges.

    One flat sort of all 4V slots costs ~2x what independent chunk sorts do
    (measured: 33M x 4 operands = 199 ms flat vs 77 ms as (256, 131k) rows),
    so: sort each chunk by (lo, hi, w, eid), mark within-chunk pair heads,
    then a second batched sort moves heads to each chunk's front, and an
    output-space scan + element gathers concatenate the chunk fronts.
    A pair whose edges span several chunks survives once PER CHUNK —
    duplicates are harmless (stage 2 treats the edge list as a multigraph
    and the pair's global-min edge survives in whichever chunk holds it;
    selection still finds the exact lexmin), they only cost capacity
    headroom.

    Returns (mask, lo, hi, w, eid, overflow); arrays are size pair_cap.
    """
    n = lo.shape[0]
    nch = max(n // chunk, 1)
    npad = nch * chunk if n % chunk == 0 else (n // chunk + 1) * chunk
    nch = npad // chunk
    pad = npad - n
    if pad:
        lo = jnp.concatenate([lo, jnp.full((pad,), INT32_MAX, lo.dtype)])
        hi = jnp.concatenate([hi, jnp.full((pad,), INT32_MAX, hi.dtype)])
        w4 = jnp.concatenate([w4, jnp.full((pad,), jnp.inf, w4.dtype)])
        eid4 = jnp.concatenate([eid4, jnp.zeros((pad,), eid4.dtype)])
    lo2, hi2, w2, e2 = (x.reshape(nch, chunk) for x in (lo, hi, w4, eid4))
    s_lo, s_hi, s_w, s_e = jax.lax.sort(
        (lo2, hi2, w2, e2), dimension=1, num_keys=4
    )
    head = jnp.concatenate(
        [jnp.ones((nch, 1), jnp.bool_),
         (s_lo[:, 1:] != s_lo[:, :-1]) | (s_hi[:, 1:] != s_hi[:, :-1])],
        axis=1,
    ) & (s_lo != INT32_MAX)
    # second batched sort: heads to each chunk's front, stable order.
    pos = jax.lax.broadcasted_iota(jnp.int32, (nch, chunk), 1)
    key2 = jnp.where(head, pos, INT32_MAX)
    k2, f_lo, f_hi, f_w, f_e = jax.lax.sort(
        (key2, s_lo, s_hi, s_w, s_e), dimension=1, num_keys=1
    )
    counts = jnp.sum(head.astype(jnp.int32), axis=1)
    offsets = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1]]
    )
    total = jnp.sum(counts)
    # output-space scan: which chunk owns output slot j.
    marks = jnp.zeros((pair_cap,), jnp.int32).at[
        jnp.clip(offsets, 0, pair_cap - 1)
    ].max(jnp.arange(nch, dtype=jnp.int32), mode="drop")
    chunk_of = jax.lax.associative_scan(jnp.maximum, marks)
    j = jnp.arange(pair_cap, dtype=jnp.int32)
    within = j - offsets[chunk_of]
    src = jnp.clip(chunk_of * chunk + within, 0, npad - 1)
    valid = j < total
    flat = lambda x: x.reshape(-1)[src]
    # total > pair_cap corrupts chunk_of (clipped offset scatter) — the
    # caller must treat the output as invalid when overflow is set.
    return (valid, flat(f_lo), flat(f_hi), flat(f_w), flat(f_e),
            total > pair_cap)


def _extract_stage(gst: GossipState, weights, cfg: SegmentationConfig):
    """Gossip -> compact handoff: live boundary edges + initial-root list.

    Returns (st: CompactState, rm, r0): the deduped directed edge list with
    component stats, plus the initial-root slots feeding the final map.
    """
    h, w = gst.L.shape
    v = h * w
    gd = _gate_div()
    # headroom for cross-chunk duplicate pairs (see _chunked_pair_extract).
    # Earlier gates (smaller gd) mean denser boundaries at handoff: scale
    # the pair pool with the gate (gd=128 keeps the measured v/24).
    gdq = _gate_div_q()
    pair_cap = max(v // min(6, max(gdq // 5, 2)) if cfg.weight_buckets > 0
                   else v // min(24, max(gd // 4, 3)), _CAP_FLOOR)
    # Live canonical edges from dense shifted planes; flattening in
    # (vertex, dir) interleave keeps position == canonical eid. One chunked
    # sort by (min-label, max-label, w, eid) both extracts the live boundary
    # edges and deduplicates each unordered component pair down to its
    # minimum edge — lossless for Boruvka.
    ew4 = jnp.stack([weights[d] for d in range(4)], axis=-1).reshape(-1)
    la = jnp.stack([gst.L] * 4, axis=-1).reshape(-1)
    lb = jnp.stack(
        [_shift(gst.L, dy, dx, -1) for dy, dx in gg.DIRS4], axis=-1
    ).reshape(-1)
    eid4 = jnp.arange(4 * v, dtype=jnp.int32)
    live4 = jnp.isfinite(ew4) & (la != lb) & (lb >= 0)
    lo = jnp.where(live4, jnp.minimum(la, lb), INT32_MAX)
    hi = jnp.where(live4, jnp.maximum(la, lb), INT32_MAX)
    pm, plo, phi, pw, pe, pair_ovf = _chunked_pair_extract(
        lo, hi, ew4, eid4, pair_cap
    )
    return _pools_to_state(pm, plo, phi, pw, pe, pair_ovf, v, cfg,
                           gst.S.reshape(-1), gst.ID.reshape(-1),
                           gst.bucket, gst.flags)


def _pools_to_state(pm, plo, phi, pw, pe, pair_ovf, v, cfg,
                    SZf, IDf, bucket, base_flags):
    """Deduped pair pool -> two-orientation edge pool + stage-2 entry state.

    Shared tail of dense extraction (_extract_stage) and the spatial
    path's gathered-pool extraction (parallel/turbo_spatial.py): the
    stage-2 entry state — INCLUDING the bucket-ramp position — must be
    built identically on both paths, or their stage-2 schedules drift
    (round-4 bug: the spatial path reset bucket to 0, replaying the ramp
    and overflowing the recompact cap at bench scale)."""
    gd = _gate_div()
    gdq = _gate_div_q()
    plo = jnp.where(pm, plo, 0)
    phi = jnp.where(pm, phi, 0)
    pw = jnp.where(pm, pw, jnp.inf)
    # both orientations (each component must see its outgoing edges).
    esrc = jnp.concatenate([plo, phi])
    edst = jnp.concatenate([phi, plo])
    ew = jnp.concatenate([pw, pw])
    eeid = jnp.concatenate([pe, pe])

    # ---- initial-root list for the final map: every component with at
    # least one live edge (components without live edges can never merge in
    # stage 2, so identity entries in the final map are correct for them).
    comp_cap = max(v // min(24, max(gdq * 3 // 4, 2))
                   if cfg.weight_buckets > 0
                   else v // min(96, max(gd * 3 // 4, 2)), _CAP_FLOOR)
    srt_src = jax.lax.sort((jnp.where(jnp.isfinite(ew), esrc, INT32_MAX),))[0]
    rhead = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), srt_src[1:] != srt_src[:-1]]
    ) & (srt_src != INT32_MAX)
    rm, (r0_arr,), root_ovf = _select_compact(rhead, [srt_src], comp_cap)
    r0 = jnp.where(rm, r0_arr, v)  # v = dummy (dropped in scatters)

    flags0 = (
        base_flags
        | jnp.where(pair_ovf, jnp.int32(FLAG_PAIR_OVERFLOW), jnp.int32(0))
        | jnp.where(root_ovf, jnp.int32(FLAG_COMP_OVERFLOW), jnp.int32(0))
    )
    st = CompactState(
        esrc=esrc, edst=edst, ew=ew, eeid=eeid,
        SZf=SZf, IDf=IDf,
        fin=jnp.where(rm, r0_arr, 0),
        merged=jnp.bool_(True), it=jnp.int32(0), bucket=bucket,
        phase=jnp.int32(0), flags=flags0,
    )
    return st, rm, r0


def _slice_pool(st: CompactState, pair_cap: int, cs: int) -> CompactState:
    """Slice the two-orientation edge pool down to `cs` pairs per half.

    The pool is `concat([plo, phi], [phi, plo])` with each half
    front-compacted by extraction's `_select_compact`, so when the live
    pair count is <= cs, slots [0, cs) of each half hold every live entry.
    """
    def take(x):
        return jnp.concatenate([x[:cs], x[pair_cap:pair_cap + cs]])

    return st._replace(esrc=take(st.esrc), edst=take(st.edst),
                       ew=take(st.ew), eeid=take(st.eeid))


def _s2_stage(st: CompactState, v: int, cfg: SegmentationConfig, thresholds,
              nb: int) -> CompactState:
    """All stage-2 compact rounds: 2 warmup rounds, recompact, main phase."""
    # below 1 MPix the full-V head capacity is cheap and removes the
    # tight-k overflow->fallback path (quality-set finding: heads exceeded
    # the 16384 floor when the bucket ramp exits with many components).
    gd = _gate_div()
    gdq = _gate_div_q()
    comp_cap = (v if v <= 1 << 20
                else max(v // min(24, max(gdq * 3 // 4, 2))
                         if cfg.weight_buckets > 0
                         else v // min(96, max(gd * 3 // 4, 2)),
                         _CAP_FLOOR))
    # NOTE: live head/pair counts do NOT shrink with felz convergence
    # (non-merging components keep live boundary edges and stay heads every
    # round), so the component capacity must hold the stage-entry bound
    # (C <= V/128 by the gossip gate) throughout. Edge pairs DO shrink
    # monotonically under merges, so one recompact after the first rounds
    # is safe with 2x headroom.
    s2_iters = 2 * cfg.max_iters + nb
    quality = cfg.weight_buckets > 0
    # one warmup round shrinks live pairs ~4x (quality mode merges slower
    # under the bucket ramp: keep two rounds and a larger recompact cap).
    warm_rounds = 2 if quality else 1
    rec1_cap = max(v // min(8, max(gdq // 4, 2)) if quality
                   else v // min(64, max(gd // 2, 4)), _CAP_FLOOR)

    def early(s: CompactState) -> CompactState:
        """Warm round(s) + recompact (+ speed mode: 2 rounds, prune, second
        recompact). Shape-polymorphic in the edge capacity: round cost is
        CAPACITY-priced (sorts and M[esrc] gathers at pool size), so the
        small-pool branch below runs this
        same program several times cheaper."""
        s = _s2_phase(s, v, comp_cap, cfg.k, cfg.min_size, warm_rounds,
                      thresholds, nb, with_minsize=False,
                      flag_exhaustion=False)
        s, rec_ovf = _recompact_edges(s, rec1_cap)
        s = s._replace(
            flags=s.flags
            | jnp.where(rec_ovf, jnp.int32(FLAG_RECOMPACT_OVERFLOW),
                        jnp.int32(0))
        )
        if quality:
            return s
        # Speed mode: live edges/heads decay ~3-4x per round (measured
        # @1080p, blobs: 39.6k -> 25k -> 10.8k -> 2.7k directed edges,
        # 6.4k -> 1.4k -> 238 -> 44 heads; textured: 50k -> 31.6k -> 17.3k
        # -> 8.6k edges) while round cost is gather/scatter-bound at
        # CAPACITY. Two rounds at the recompacted cap, then prune provably-
        # dead edges and recompact to much smaller buffers for the
        # remaining rounds. The v/128 edge cap holds ~2x the worst measured
        # content at this point; low-k configs (many frozen-but-adjacent
        # final components) fit because of the prune.
        s = _s2_phase(s, v, comp_cap, cfg.k, cfg.min_size, 2,
                      thresholds, nb, with_minsize=False,
                      flag_exhaustion=False)
        s = _prune_dead(s, v, cfg.k, cfg.min_size)
        s, rec2_ovf = _recompact_edges(s, max(v // min(128, gd), _CAP_FLOOR // 2))
        return s._replace(
            flags=s.flags
            | jnp.where(rec2_ovf, jnp.int32(FLAG_RECOMPACT_OVERFLOW),
                        jnp.int32(0))
        )

    # ---- live-count small path: the pool capacity covers worst-case
    # (sponge-boundary) content, but bench/quality content runs ~5-10x
    # below it (live pairs ~V/104 blobs, ~V/82 textured @1080p vs the
    # V/24 speed pool). When every live pair fits a much smaller slice,
    # run the SAME early rounds on the sliced pool — identical results
    # (dead slots beyond the slice carry no information), at slice-sized
    # cost. Worst-case content takes the full-capacity branch instead; no
    # flags involved. GSEG_S2_SMALL=0 disables; *_DIV tunes the slice.
    pair_cap = st.esrc.shape[0] // 2
    small_on = os.environ.get("GSEG_S2_SMALL", "1") == "1"
    div = int(os.environ.get(
        "GSEG_S2_SMALL_DIV", "24" if quality else "64"))
    # cs >= ceil(rec1_cap/2) keeps the recompact slice full-length (the
    # sliced pool holds 2*cs entries, and _pair_dedup slices [:rec1_cap]).
    if not quality and gd < 64:
        div = min(div, max(gd // 2, 4))  # earlier gates: denser live sets
    if quality and gdq < 24:
        div = min(div, max(gdq // 2, 2))
    cs = max(v // div, -(-rec1_cap // 2))
    if small_on and cs < pair_cap:
        live = jnp.sum(jnp.isfinite(st.ew[:pair_cap]).astype(jnp.int32))
        st = jax.lax.cond(
            live <= cs,
            lambda s: early(_slice_pool(s, pair_cap, cs)),
            early, st,
        )
    else:
        st = early(st)

    if quality:
        return _s2_phase(st, v, comp_cap, cfg.k, cfg.min_size, s2_iters,
                         thresholds, nb, with_minsize=cfg.min_size > 1)
    comp_cap2 = max(v // min(1024, gd * 8), 4096)
    return _s2_phase(st, v, comp_cap2, cfg.k, cfg.min_size, s2_iters,
                     thresholds, nb, with_minsize=cfg.min_size > 1)


def _final_map(gst: GossipState, st: CompactState, rm, r0, max_sweeps):
    """Stage-G labels through the stage-2 root map -> final (H, W) labels.

    Each root slot gets its final label (st.fin for the r0 roots, itself
    for components with no live boundary edge), and a min-value flood
    within the stage-G components carries it to every pixel.
    GSEG_FINAL_GATHER=1 resolves the pixels with ONE V-sized gather
    instead: gst.L[p] is the component ROOT's flat pixel id (canonical
    labels), so a (V,) table of root-slot labels indexes directly.
    Returns (labels, unconverged)."""
    h, w = gst.L.shape
    v = h * w
    vid2d = jnp.arange(v, dtype=jnp.int32).reshape(h, w)
    # Root slots hold their final label (identity covers components with
    # no live boundary edge, which never appear in r0); r0 roots get
    # st.fin. Non-root slots are never referenced by the gather (L values
    # are always root ids); the flood path needs them at the sentinel.
    seed = jnp.where(gst.L == vid2d, gst.L, INT32_MAX).reshape(-1)
    seed = seed.at[jnp.where(rm, r0, v)].set(st.fin, mode="drop")
    if os.environ.get("GSEG_FINAL_GATHER", "0") == "1":
        labels = seed[gst.L.reshape(-1)].reshape(h, w)
        return labels, jnp.bool_(False)
    return _flood_values(gst.L, seed.reshape(h, w), max_sweeps)


def segment_turbo_impl(image: jnp.ndarray, cfg: SegmentationConfig,
                       gossip_rounds: int = 2, weights_override=None):
    """(H, W, 3) -> (labels, flags): (H, W) int32 canonical (min-vertex-id)
    labels plus a () int32 FLAG_* bitmask — nonzero means a capacity or
    sweep-budget violation occurred and the labels must not be trusted
    (`segment_turbo` checks it and raises / falls back).

    weights_override: see _stage_g — parity-testing hook only."""
    h, w = image.shape[0], image.shape[1]
    v = h * w
    with jax.named_scope("stage_g"):
        gst, weights, thresholds = _stage_g(image, cfg, gossip_rounds,
                                            weights_override)
    nb = max(cfg.weight_buckets, 1)
    with jax.named_scope("extract"):
        st, rm, r0 = _extract_stage(gst, weights, cfg)
    with jax.named_scope("stage2"):
        st = _s2_stage(st, v, cfg, thresholds, nb)
    with jax.named_scope("final_map"):
        labels, fm_unconv = _final_map(gst, st, rm, r0, 4 * (h + w))
    flags = st.flags | jnp.where(
        fm_unconv, jnp.int32(FLAG_GOSSIP_UNCONVERGED), jnp.int32(0)
    )
    return labels, flags


segment_turbo_flagged = jax.jit(
    segment_turbo_impl, static_argnames=("cfg", "gossip_rounds")
)


# ---------------------------------------------------------------------------
# Hierarchy mode: per-round partition capture (reference Fast Hierarchy
# Creation input, Report.pdf p.4 §3.2.3), turbo-native. Levels are the
# SAME partition sequence as segment_turbo's internal rounds: one level per
# felz Boruvka round (gossip rounds capture the dense label plane directly;
# stage-2 rounds capture the compact root map `fin` and render it through
# the seed-scatter + same-region flood of `_final_map` — still zero
# V-sized gathers).
# ---------------------------------------------------------------------------


def _stage_g_capture(image, cfg: SegmentationConfig, gossip_rounds: int,
                     n_levels: int):
    """_stage_g with a (n_levels, H, W) per-round label capture."""
    h, w = image.shape[0], image.shape[1]
    v = h * w
    max_sweeps = 4 * (h + w)

    smoothed = filters.gaussian_smooth(image, cfg.sigma)
    weights, _ = gg.edge_weight_planes(
        smoothed, cfg.connectivity, cfg.quantize_weight_bits
    )
    w8, eid8 = gg.incident_views(weights)
    vid = jnp.arange(v, dtype=jnp.int32).reshape(h, w)

    nb = max(cfg.weight_buckets, 1)
    thresholds = (
        bucket_thresholds(weights, nb) if cfg.weight_buckets > 0
        else jnp.array([jnp.inf], dtype=jnp.float32)
    )

    gst = GossipState(
        L=vid, S=jnp.ones((h, w), jnp.int32), ID=jnp.zeros((h, w), jnp.float32),
        merged=jnp.bool_(True), it=jnp.int32(0), bucket=jnp.int32(0),
        flags=jnp.int32(0),
    )
    levels = jnp.zeros((n_levels, h, w), jnp.int32)
    # same gate as _stage_g (incl. GSEG_GATE_DIV) so hierarchy levels
    # keep corresponding to segment_turbo's internal rounds.
    gate_c = (v // _gate_div_q() if cfg.weight_buckets > 0
              else v // _gate_div())

    def advance(s, s2):
        more = s.bucket + 1 < nb
        return s2._replace(
            bucket=jnp.minimum(s.bucket + 1, nb - 1),
            merged=s2.merged | more,
        )

    # peel the first two rounds (counting-scatter sizes; see _stage_g),
    # in one while_loop (single traced _ground body — compile cost).

    def pcond(c):
        s = c[0]
        return s.merged & (s.it < 2)

    def pbody(c):
        s, levels = c
        it0 = s.it
        s = advance(s, _ground(
            s, w8, eid8, vid, cfg.k, cfg.min_size, "felz", max_sweeps,
            tau=thresholds[s.bucket], sizes="count",
            idle_compmin=it0 == 0,
        ))
        return s, levels.at[jnp.minimum(it0, n_levels - 1)].set(s.L)

    gst, levels = jax.lax.while_loop(pcond, pbody, (gst, levels))
    # quality: pixel-scale root list (the bucket ramp can leave ~0.8V live
    # roots after the peel rounds — same fix as _stage_g).
    rcap = (v if v <= 1 << 20 or cfg.weight_buckets > 0
            else max(v // 2, _CAP_FLOOR))
    rlist, rovf = _build_rlist(gst.L, rcap)
    gst = gst._replace(
        flags=gst.flags
        | jnp.where(rovf, jnp.int32(FLAG_COMP_OVERFLOW), jnp.int32(0))
    )

    def gcond(c):
        s = c[0]
        comp = jnp.sum((s.L == vid).astype(jnp.int32))
        return s.merged & ((s.it < gossip_rounds) | (comp > gate_c))

    def gbody(c):
        s, levels, rl = c
        s2, rl2 = _ground(s, w8, eid8, vid, cfg.k, cfg.min_size, "felz",
                          max_sweeps, tau=thresholds[s.bucket], rlist=rl,
                          sizes="rlist")
        s2 = advance(s, s2)
        levels = levels.at[jnp.minimum(s.it, n_levels - 1)].set(s2.L)
        return s2, levels, rl2

    (gst, levels, _) = jax.lax.while_loop(
        gcond, gbody, (gst, levels, rlist)
    )
    return gst, weights, thresholds, levels


def _s2_phase_capture(st: CompactState, v, comp_cap, k, min_size, max_iters,
                      thresholds, nb, with_minsize, fins, cur,
                      flag_exhaustion=True, canonical: bool = True):
    """_s2_phase that also records `fin` after each FELZ round into
    fins[(cur)] (min-size rounds refine the same hierarchy level)."""
    n_levels = fins.shape[0]

    def cond(c):
        s = c[0]
        return s.merged & (s.it < max_iters)

    def body(c):
        s, fins, cur = c
        is_felz = s.phase == 0
        tau = thresholds[s.bucket]
        s2 = _s2_round(s, v, comp_cap, k, min_size, is_felz, tau=tau,
                       canonical=canonical)
        more_buckets = is_felz & (s.bucket + 1 < nb)
        s2 = s2._replace(
            bucket=jnp.where(is_felz,
                             jnp.minimum(s.bucket + 1, nb - 1), s.bucket),
            merged=s2.merged | more_buckets,
        )
        if with_minsize:
            flip = is_felz & ~s2.merged
            s2 = s2._replace(
                phase=jnp.where(flip, jnp.int32(1), s.phase),
                merged=s2.merged | flip,
            )
        fins = jnp.where(
            is_felz,
            fins.at[jnp.minimum(cur, n_levels - 1)].set(s2.fin),
            fins,
        )
        cur = cur + jnp.where(is_felz, jnp.int32(1), jnp.int32(0))
        return s2, fins, cur

    st = st._replace(merged=jnp.bool_(True), it=jnp.int32(0))
    st, fins, cur = jax.lax.while_loop(cond, body, (st, fins, cur))
    if flag_exhaustion:
        st = st._replace(
            flags=st.flags | jnp.where(
                st.merged, jnp.int32(FLAG_ITERS_EXHAUSTED), jnp.int32(0))
        )
    return st, fins, cur


def segment_turbo_hierarchy_impl(image, cfg: SegmentationConfig,
                                 gossip_rounds: int = 2,
                                 n_levels: int | None = None):
    """(H, W, 3) -> (levels (n_levels+1, H, W), labels, flags).

    Level 0 is the trivial partition; level i the partition after felz
    round i; levels past convergence repeat the last converged felz
    partition; `labels` is the final map after min-size."""
    h, w = image.shape[0], image.shape[1]
    v = h * w
    if n_levels is None:
        n_levels = cfg.max_iters
    nb = max(cfg.weight_buckets, 1)

    gst, weights, thresholds, glevels = _stage_g_capture(
        image, cfg, gossip_rounds, n_levels
    )
    g_count = jnp.minimum(gst.it, n_levels)
    st, rm, r0 = _extract_stage(gst, weights, cfg)

    comp_cap = (v if v <= 1 << 20
                else max(v // 24 if cfg.weight_buckets > 0 else v // 96,
                         _CAP_FLOOR))
    s2_iters = 2 * cfg.max_iters + nb
    fins0 = jnp.zeros((n_levels, st.fin.shape[0]), jnp.int32)
    warm_rounds = 2 if cfg.weight_buckets > 0 else 1
    st, fins, s2_count = _s2_phase_capture(
        st, v, comp_cap, cfg.k, cfg.min_size, warm_rounds, thresholds, nb,
        False, fins0, jnp.int32(0), flag_exhaustion=False,
    )
    st, rec_ovf = _recompact_edges(
        st, max(v // 16 if cfg.weight_buckets > 0 else v // 64, _CAP_FLOOR)
    )
    st = st._replace(
        flags=st.flags
        | jnp.where(rec_ovf, jnp.int32(FLAG_RECOMPACT_OVERFLOW), jnp.int32(0))
    )
    st, fins, s2_count = _s2_phase_capture(
        st, v, comp_cap, cfg.k, cfg.min_size, s2_iters, thresholds, nb,
        cfg.min_size > 1, fins, s2_count,
    )

    # pad unwritten fin slots with the last captured felz root map so levels
    # past convergence repeat the final felz partition.
    li = jnp.arange(n_levels, dtype=jnp.int32)
    last = jnp.maximum(jnp.minimum(s2_count, n_levels) - 1, 0)
    fins = jnp.where(
        (li[:, None] < s2_count) & (li[:, None] < n_levels),
        fins, fins[last][None],
    )
    # no felz round ever captured (s2_count == 0): levels fall back to the
    # identity root map (partition unchanged from stage G's last level).
    fins = jnp.where(s2_count == 0, jnp.where(rm, r0, 0)[None], fins)

    max_sweeps = 4 * (h + w)
    vid2d = jnp.arange(v, dtype=jnp.int32).reshape(h, w)
    seed_base = jnp.where(gst.L == vid2d, gst.L, INT32_MAX).reshape(-1)
    r0_safe = jnp.where(rm, r0, v)

    def render_fin(fin_l):
        seed = seed_base.at[r0_safe].set(fin_l, mode="drop")
        if os.environ.get("GSEG_FINAL_GATHER", "0") == "1":
            # one V-gather per level (see _final_map).
            return seed[gst.L.reshape(-1)].reshape(h, w), jnp.bool_(False)
        return _flood_values(gst.L, seed.reshape(h, w), max_sweeps)

    def level_j(j):
        def from_gossip(_):
            return glevels[j], jnp.bool_(False)

        def from_s2(_):
            return render_fin(fins[jnp.clip(j - g_count, 0, n_levels - 1)])

        return jax.lax.cond(j < g_count, from_gossip, from_s2, None)

    levels, unconvs = jax.lax.map(level_j, li)
    labels, fm_unconv = _final_map(gst, st, rm, r0, max_sweeps)
    flags = st.flags | jnp.where(
        fm_unconv | jnp.any(unconvs),
        jnp.int32(FLAG_GOSSIP_UNCONVERGED), jnp.int32(0),
    )
    level0 = vid2d[None]
    return jnp.concatenate([level0, levels], axis=0), labels, flags


segment_turbo_hierarchy_flagged = jax.jit(
    segment_turbo_hierarchy_impl,
    static_argnames=("cfg", "gossip_rounds", "n_levels"),
)


def segment_turbo_hierarchy(image, cfg: SegmentationConfig,
                            gossip_rounds: int = 2):
    """Checked hierarchy entry: (H, W, 3) -> (levels (L+1, H, W), labels).

    Same flag semantics as segment_turbo (raise / fallback / ignore per
    cfg.on_overflow)."""
    levels, labels, flags = segment_turbo_hierarchy_flagged(
        image, cfg, gossip_rounds
    )
    flags = int(flags)
    if flags == 0:
        return levels, labels
    msg = f"turbo capacity/budget violation: {describe_flags(flags)}"
    if cfg.on_overflow == "fallback":
        from .fastmst import segment_fastmst_hierarchy

        return segment_fastmst_hierarchy(image, cfg)
    if cfg.on_overflow == "ignore":
        return levels, labels
    raise RuntimeError(
        msg + " — rerun with SegmentationConfig(on_overflow='fallback') "
        "to route to the fastmst hierarchy, or use a larger-capacity config"
    )


def describe_flags(flags: int) -> str:
    names = {
        FLAG_GOSSIP_UNCONVERGED: "gossip sweep cap exhausted",
        FLAG_PAIR_OVERFLOW: "pair-extraction capacity overflow",
        FLAG_COMP_OVERFLOW: "component-head capacity overflow",
        FLAG_RECOMPACT_OVERFLOW: "edge-recompaction capacity overflow",
        FLAG_ITERS_EXHAUSTED: "stage-2 round budget exhausted",
    }
    hits = [msg for bit, msg in names.items() if flags & bit]
    return "; ".join(hits) if hits else "ok"


def segment_turbo(image: jnp.ndarray, cfg: SegmentationConfig,
                  gossip_rounds: int = 2) -> jnp.ndarray:
    """Checked turbo entry: (H, W, 3) -> (H, W) int32 labels.

    Runs the jitted pipeline, then inspects the overflow/unconvergence flag
    bitmask on the host (piggybacks on the device->host fetch every caller
    performs anyway). On a nonzero mask the result is NOT a valid
    segmentation; per cfg.on_overflow this either raises (default), falls
    back to the capacity-unbounded atomic path, or returns anyway
    ("ignore", for capacity experiments only).
    """
    labels, flags = segment_turbo_flagged(image, cfg, gossip_rounds)
    flags = int(flags)
    if flags == 0:
        return labels
    msg = f"turbo capacity/budget violation: {describe_flags(flags)}"
    if cfg.on_overflow == "fallback":
        from .atomic_boruvka import segment_atomic

        return segment_atomic(image, cfg)
    if cfg.on_overflow == "ignore":
        return labels
    raise RuntimeError(
        msg + " — rerun with SegmentationConfig(on_overflow='fallback') "
        "to route to the atomic path, or use a larger-capacity config"
    )
