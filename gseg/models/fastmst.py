"""DPP/FastMST segmentation path in JAX (compact supervertex rounds).

Rebuild of the reference's data-parallel-primitive variants: the ground-up
and ported FastMST "DPP Segmentation Hierarchies" (branches
boruvka_fastMST_fixingSegments_v1 / fastmst_segment; Report.pdf p.3-4
§3.2.2-3.2.3, after Vineet et al. HPG'09). The reference maps each Boruvka
round onto Thrust primitives: radix sort of packed 64-bit edge keys
(26b src | 26b dst | 12b weight), segmented min via a custom scan, pointer
jumping, supervertex renumbering (sort + adjacent-diff + prefix scan),
duplicate-edge removal, and edge-list relabel/compaction.

Redesign (v2 — per-round V-sized gathers are avoided, so the V-scale work
happens ONCE):

  ROUND 1 — dense, at pixel scale: with identity parents the per-component
  min outgoing edge is a per-PIXEL lexmin over the 8 incident-edge planes
  (the reference's Fast Graph Creation per-pixel kernels, Report.pdf p.3
  §3.2.1, fused with its first Boruvka round); hooks, mutual-hook removal
  and pointer jumping run on the (V,) successor array (`pointer_double`,
  the reference's pointer-jumping primitive), sizes/Int via segment
  scatters. This is the only V-scale round.

  EXTRACTION — dense planes -> compact edge list: live boundary edges are
  extracted and deduplicated to the minimum (w, eid) edge per component
  pair with chunked sorts (the reference's 64-bit-key duplicate-edge
  removal; lossless for Boruvka). Capacities are static with overflow
  flags (no silent truncation).

  ROUNDS 2+ — the faithful Vineet DPP schedule at supervertex scale on the
  compacted list (models/turbo.py `_s2_round` with canonical=False): one
  multi-operand `lax.sort` by (component, w, eid) replaces the packed-key
  radix sort + segmented-min scan; run heads are the per-component minima;
  hook chains resolve by pointer-doubling the successor map in compact
  index space; edge relabel + self-edge invalidation keep shapes static.

  FINAL — labels materialize by scattering each round-1 root's final root
  onto its root pixel and value-flooding the (tiny-diameter) round-1
  components — no V-sized gather.

Label convention: HOOK-SINK root vertex ids — byte-identical to
`segment_atomic` and the sequential oracles (models/boruvka_cpu.py), unlike
turbo's canonical min-vertex ids; the partition equals turbo's.
Full float32 weights and 32-bit ids: no 2^26-pixel cap and no 12-bit weight
quantization (SURVEY.md §6 hard parts); `quantize_weight_bits=12`
reproduces the reference's quantized weights for validation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import SegmentationConfig
from ..ops import filters
from ..ops import grid_graph as gg
from ..ops.primitives import (
    INT32_MAX,
    pointer_double,
    remove_mutual_hooks,
    segment_sum,
)
from . import turbo


def _round1_dense(image: jnp.ndarray, cfg: SegmentationConfig):
    """First Boruvka-Felzenszwalb round at pixel scale with dense plane ops.

    Returns (gst: turbo.GossipState with hook-sink labels/stats after round
    1, weights (4, H, W)). With identity parents the component min edge IS
    the vertex min edge, so no scatter reduction is needed; hooks resolve
    with one (V,) pointer-doubling pass (reference Appendix A Algs 1-6
    collapse to their first iteration)."""
    h, w = image.shape[0], image.shape[1]
    v = h * w
    smoothed = filters.gaussian_smooth(image, cfg.sigma)
    weights, _ = gg.edge_weight_planes(
        smoothed, cfg.connectivity, cfg.quantize_weight_bits
    )
    w8, eid8 = gg.incident_views(weights)
    vid = jnp.arange(v, dtype=jnp.int32).reshape(h, w)

    # round-1 predicate: all sizes 1, Int 0 => both thresholds equal k.
    vminw = jnp.min(w8, axis=0)
    cand = jnp.where(w8 == vminw[None], eid8, INT32_MAX)
    veid = jnp.min(cand, axis=0)
    has = jnp.isfinite(vminw)
    ok = has & (vminw <= jnp.float32(cfg.k))

    a, b = gg.edge_endpoints(veid.reshape(-1), w)
    other = jnp.where(
        ok.reshape(-1), a + b - vid.reshape(-1), vid.reshape(-1)
    )
    succ = remove_mutual_hooks(other)
    arange = vid.reshape(-1)
    used = succ != arange
    parent1 = pointer_double(succ)

    size1 = segment_sum(jnp.ones((v,), jnp.int32), parent1, v)
    id1 = jnp.zeros((v,), jnp.float32).at[
        jnp.where(used, parent1, v)
    ].max(jnp.where(used, vminw.reshape(-1), 0.0), mode="drop")

    gst = turbo.GossipState(
        L=parent1.reshape(h, w), S=size1.reshape(h, w),
        ID=id1.reshape(h, w), merged=jnp.any(used), it=jnp.int32(1),
        bucket=jnp.int32(0), flags=jnp.int32(0),
    )
    return gst, weights


def _extract_compact(gst, weights, v: int):
    """Dense planes -> deduped compact edge list + root list + stats.

    Same construction as turbo's extract stage, at the larger capacities the
    single-round handoff needs. MEASURED on ladder content (k=300,
    min_size=100, 540p/1080p, blobs AND textured): round-1 components
    average 3.4 px (comps = 0.29 V), distinct component pairs = 1.05-1.10 V
    — the earlier V/2 pair cap and V/4 comp cap both overflowed on every
    ladder rung. 1.25 V / V/2 hold the measured worst with headroom; the
    cost of the fat entry list is contained by recompacting after the
    first compact round (see segment_fastmst_impl)."""
    h, w = gst.L.shape
    pair_cap = max(v + v // 4, 16384)
    comp_cap = max(v // 2, 16384)

    ew4 = jnp.stack([weights[d] for d in range(4)], axis=-1).reshape(-1)
    la = jnp.stack([gst.L] * 4, axis=-1).reshape(-1)
    lb = jnp.stack(
        [gg.shift_plane(gst.L, dy, dx, -1) for dy, dx in gg.DIRS4],
        axis=-1,
    ).reshape(-1)
    eid4 = jnp.arange(4 * v, dtype=jnp.int32)
    live4 = jnp.isfinite(ew4) & (la != lb) & (lb >= 0)
    lo = jnp.where(live4, jnp.minimum(la, lb), INT32_MAX)
    hi = jnp.where(live4, jnp.maximum(la, lb), INT32_MAX)
    pm, plo, phi, pw, pe, pair_ovf = turbo._chunked_pair_extract(
        lo, hi, ew4, eid4, pair_cap
    )
    plo = jnp.where(pm, plo, 0)
    phi = jnp.where(pm, phi, 0)
    pw = jnp.where(pm, pw, jnp.inf)
    esrc = jnp.concatenate([plo, phi])
    edst = jnp.concatenate([phi, plo])
    ew = jnp.concatenate([pw, pw])
    eeid = jnp.concatenate([pe, pe])

    srt_src = jax.lax.sort(
        (jnp.where(jnp.isfinite(ew), esrc, INT32_MAX),)
    )[0]
    rhead = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), srt_src[1:] != srt_src[:-1]]
    ) & (srt_src != INT32_MAX)
    rm, (r0_arr,), root_ovf = turbo._select_compact(rhead, [srt_src],
                                                    comp_cap)
    r0 = jnp.where(rm, r0_arr, v)

    flags0 = (
        gst.flags
        | jnp.where(pair_ovf, jnp.int32(turbo.FLAG_PAIR_OVERFLOW),
                    jnp.int32(0))
        | jnp.where(root_ovf, jnp.int32(turbo.FLAG_COMP_OVERFLOW),
                    jnp.int32(0))
    )
    st = turbo.CompactState(
        esrc=esrc, edst=edst, ew=ew, eeid=eeid,
        SZf=gst.S.reshape(-1), IDf=gst.ID.reshape(-1),
        fin=jnp.where(rm, r0_arr, 0),
        merged=jnp.bool_(True), it=jnp.int32(0), bucket=jnp.int32(0),
        phase=jnp.int32(0), flags=flags0,
    )
    return st, rm, r0


def segment_fastmst_impl(image: jnp.ndarray, cfg: SegmentationConfig):
    """(H, W, 3) -> (labels, flags): hook-sink root-id labels + overflow
    flag bitmask (see turbo.FLAG_*)."""
    h, w = image.shape[0], image.shape[1]
    v = h * w
    gst, weights = _round1_dense(image, cfg)
    st, rm, r0 = _extract_compact(gst, weights, v)

    comp_cap = max(v // 2, 16384)
    thresholds = jnp.array([jnp.inf], dtype=jnp.float32)
    # staged cap shrinking (live pairs decay 3-4x per round, measured):
    # one round at the 2.5V-directed entry list, recompact to V; two more
    # rounds, recompact to V/4; run out. Keeps the fat entry capacity the
    # overflow data demands while only round 2 pays full-list sort cost.
    st = turbo._s2_phase(st, v, comp_cap, cfg.k, cfg.min_size, 1,
                         thresholds, 1, with_minsize=False,
                         flag_exhaustion=False, canonical=False)
    st, rec_ovf = turbo._recompact_edges(st, max(v, 16384))
    st = turbo._s2_phase(st, v, comp_cap, cfg.k, cfg.min_size, 2,
                         thresholds, 1, with_minsize=False,
                         flag_exhaustion=False, canonical=False)
    st, rec2_ovf = turbo._recompact_edges(st, max(v // 4, 16384))
    st = st._replace(
        flags=st.flags | jnp.where(
            rec_ovf | rec2_ovf,
            jnp.int32(turbo.FLAG_RECOMPACT_OVERFLOW), jnp.int32(0))
    )
    # Run-out rounds: pool sorts are CAPACITY-priced while live pairs keep
    # decaying 3-4x/round — route through a V/16 slice when the live count
    # fits (the recompacted pool is front-compacted, so slicing is
    # lossless then; _final_map only needs fin/flags, so the lax.cond
    # projects those out and branch shapes stay equal). Same pattern as
    # turbo._s2_stage; GSEG_S2_SMALL=0 disables.
    import os as _os

    def _runout(s):
        s = turbo._s2_phase(s, v, comp_cap, cfg.k, cfg.min_size,
                            2 * cfg.max_iters, thresholds, 1,
                            with_minsize=cfg.min_size > 1, canonical=False)
        return s.fin, s.flags

    pool = st.esrc.shape[0]
    cs = max(v // 16, 16384)
    if cs < pool and _os.environ.get("GSEG_S2_SMALL", "1") == "1":
        live = jnp.sum(jnp.isfinite(st.ew).astype(jnp.int32))

        def _sliced(s):
            return _runout(s._replace(
                esrc=s.esrc[:cs], edst=s.edst[:cs], ew=s.ew[:cs],
                eeid=s.eeid[:cs]))

        fin, flags2 = jax.lax.cond(live <= cs, _sliced, _runout, st)
    else:
        fin, flags2 = _runout(st)
    st = st._replace(fin=fin, flags=flags2)

    labels, fm_unconv = turbo._final_map(gst, st, rm, r0, 4 * (h + w))
    flags = st.flags | jnp.where(
        fm_unconv, jnp.int32(turbo.FLAG_GOSSIP_UNCONVERGED), jnp.int32(0)
    )
    return labels, flags


segment_fastmst_flagged = jax.jit(
    segment_fastmst_impl, static_argnames=("cfg",)
)


def segment_fastmst(image: jnp.ndarray, cfg: SegmentationConfig):
    """Checked DPP entry: (H, W, 3) -> (H, W) int32 hook-sink root labels,
    byte-identical to segment_atomic / the sequential oracle."""
    labels, flags = segment_fastmst_flagged(image, cfg)
    flags = int(flags)
    if flags == 0:
        return labels
    msg = (
        "fastmst capacity/budget violation: "
        f"{turbo.describe_flags(flags)}"
    )
    if cfg.on_overflow == "fallback":
        from .atomic_boruvka import segment_atomic

        return segment_atomic(image, cfg)
    if cfg.on_overflow == "ignore":
        return labels
    raise RuntimeError(
        msg + " — rerun with SegmentationConfig(on_overflow='fallback') "
        "to route to the atomic path"
    )


def segment_fastmst_hierarchy_impl(image: jnp.ndarray,
                                   cfg: SegmentationConfig,
                                   n_levels: int | None = None):
    """Hierarchy mode: (levels (n_levels+2, H, W), labels, flags).

    Level 0 = singletons, level 1 = the dense round, levels 2..n_levels+1
    = compact rounds rendered through the round-1 value flood (reference
    Fast Hierarchy Creation input, Report.pdf p.4 §3.2.3). Note the shape
    differs from turbo/superpixel hierarchies (max_iters+1 planes): the
    fastmst path captures the dense round as its own plane in addition to
    the singleton level, mirroring its two-phase schedule."""
    h, w = image.shape[0], image.shape[1]
    v = h * w
    if n_levels is None:
        n_levels = cfg.max_iters
    gst, weights = _round1_dense(image, cfg)
    st, rm, r0 = _extract_compact(gst, weights, v)

    comp_cap = max(v // 2, 16384)
    thresholds = jnp.array([jnp.inf], dtype=jnp.float32)
    fins0 = jnp.zeros((n_levels, st.fin.shape[0]), jnp.int32)
    # same staged cap shrinking as segment_fastmst_impl (measured ladder
    # pair densities; see _extract_compact).
    st, fins, s2_count = turbo._s2_phase_capture(
        st, v, comp_cap, cfg.k, cfg.min_size, 1, thresholds, 1,
        False, fins0, jnp.int32(0), flag_exhaustion=False,
        canonical=False,
    )
    st, rec_ovf = turbo._recompact_edges(st, max(v, 16384))
    st, fins, s2_count = turbo._s2_phase_capture(
        st, v, comp_cap, cfg.k, cfg.min_size, 2, thresholds, 1,
        False, fins, s2_count, flag_exhaustion=False,
        canonical=False,
    )
    st, rec2_ovf = turbo._recompact_edges(st, max(v // 4, 16384))
    st = st._replace(
        flags=st.flags | jnp.where(
            rec_ovf | rec2_ovf,
            jnp.int32(turbo.FLAG_RECOMPACT_OVERFLOW), jnp.int32(0))
    )
    st, fins, s2_count = turbo._s2_phase_capture(
        st, v, comp_cap, cfg.k, cfg.min_size, 2 * cfg.max_iters,
        thresholds, 1, cfg.min_size > 1, fins, s2_count, canonical=False,
    )

    li = jnp.arange(n_levels, dtype=jnp.int32)
    last = jnp.maximum(jnp.minimum(s2_count, n_levels) - 1, 0)
    fins = jnp.where(li[:, None] < s2_count, fins, fins[last][None])
    fins = jnp.where(s2_count == 0, jnp.where(rm, r0, 0)[None], fins)

    max_sweeps = 4 * (h + w)
    vid2d = jnp.arange(v, dtype=jnp.int32).reshape(h, w)
    seed_base = jnp.where(gst.L == vid2d, gst.L, INT32_MAX).reshape(-1)
    r0_safe = jnp.where(rm, r0, v)

    def render_fin(fin_l):
        seed = seed_base.at[r0_safe].set(fin_l, mode="drop").reshape(h, w)
        return turbo._flood_values(gst.L, seed, max_sweeps)

    levels, unconvs = jax.lax.map(render_fin, fins)
    labels, fm_unconv = turbo._final_map(gst, st, rm, r0, max_sweeps)
    flags = st.flags | jnp.where(
        fm_unconv | jnp.any(unconvs),
        jnp.int32(turbo.FLAG_GOSSIP_UNCONVERGED), jnp.int32(0),
    )
    out = jnp.concatenate([vid2d[None], gst.L[None], levels], axis=0)
    return out, labels, flags


segment_fastmst_hierarchy_flagged = jax.jit(
    segment_fastmst_hierarchy_impl, static_argnames=("cfg", "n_levels")
)


def segment_fastmst_hierarchy(image: jnp.ndarray, cfg: SegmentationConfig):
    """DPP Segmentation Hierarchies: per-round label capture.

    Returns (levels (L, H, W), final labels (H, W))."""
    levels, labels, flags = segment_fastmst_hierarchy_flagged(image, cfg)
    flags = int(flags)
    if flags == 0:
        return levels, labels
    msg = (
        "fastmst capacity/budget violation: "
        f"{turbo.describe_flags(flags)}"
    )
    if cfg.on_overflow == "fallback":
        from .atomic_boruvka import segment_atomic_hierarchy

        return segment_atomic_hierarchy(image, cfg)
    if cfg.on_overflow == "ignore":
        return levels, labels
    raise RuntimeError(msg)
