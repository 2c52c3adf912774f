"""Explicit-collectives spatial turbo: shard_map + ppermute halo exchange.

The second multi-chip implementation promised in parallel/spatial.py
(SURVEY.md §7 Layer F): the image is row-sharded over a 1-D mesh axis and
the turbo pipeline runs under `shard_map` with every cross-tile dependency
an explicit collective:

  - dense stage-G gossip sweeps exchange 1-row halos via `lax.ppermute`
    each sweep and reduce convergence flags with `psum` (the analog of the
    reference's single-GPU convergence flag, over the device interconnect
    instead of PCIe — report-extract 509-511);
  - prep (Gaussian + edge weights) exchanges a (radius+1)-row halo once;
  - extraction runs per tile (local chunked pair dedup at tile capacity),
    then `all_gather`s the small per-tile pools and dedups globally — every
    device ends with the identical compact edge list;
  - stage 2 (compact Boruvka rounds) is REPLICATED: identical deterministic
    computation on every device, no communication at all;
  - the final label map is seeded from the replicated root map and flooded
    back out through the sharded halo sweeps.

The partition is bit-identical to single-device `segment_turbo` (the same
global fixpoints and rounds; only the schedule of communication differs) —
tests/test_parallel.py asserts equality on an 8-device CPU mesh.

Memory note: stage 2 replicates (V,)-sized stat arrays per device, so this
path shards COMPUTE and the dense stage-G working set (the dominant term),
not the final V-sized vectors: the per-device footprint is
O(V/n_dev * planes) for the sharded stage-G fields plus O(V) int32/f32 for
the replicated stage-2 pools, so the replicated term caps the max image at
roughly the single-device memory ceiling (~6 V-sized vectors) — compute scales with the mesh, peak memory does not.
Quality mode (weight_buckets > 0) IS routed spatially: bucket thresholds
are sampled from gathered global weight planes with the dense arithmetic,
and tests/test_parallel.py asserts equality with the dense path in both
modes.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SegmentationConfig
from ..models import turbo
from ..ops import filters
from ..ops import grid_graph as gg
from ..ops.primitives import INT32_MAX

BIGDIST = turbo.BIGDIST


def _halo_pad(x, k, axis_name, n_dev, fill):
    """Pad a row-sharded tile with k rows from each mesh neighbor; global
    top/bottom tiles pad with `fill` (or edge-replicate if fill is None)."""
    idx = jax.lax.axis_index(axis_name)
    fwd = [(i, i + 1) for i in range(n_dev - 1)]
    bwd = [(i + 1, i) for i in range(n_dev - 1)]
    top = jax.lax.ppermute(x[-k:], axis_name, fwd)   # receive from idx-1
    bot = jax.lax.ppermute(x[:k], axis_name, bwd)    # receive from idx+1
    if fill is None:  # edge-replicate (Gaussian boundary semantics)
        top_fill = jnp.broadcast_to(x[:1], x[:k].shape)
        bot_fill = jnp.broadcast_to(x[-1:], x[:k].shape)
    else:
        top_fill = jnp.full_like(x[:k], fill)
        bot_fill = jnp.full_like(x[:k], fill)
    top = jnp.where(idx == 0, top_fill, top)
    bot = jnp.where(idx == n_dev - 1, bot_fill, bot)
    return jnp.concatenate([top, x, bot], axis=0)


def _make_comm(axis_name, n_dev):
    def shift(x, dy, dx, fill):
        if dy == 0:
            return gg.shift_plane(x, dy, dx, fill)
        xp = _halo_pad(x, 1, axis_name, n_dev, fill)
        return gg.shift_plane(xp, dy, dx, fill)[1:-1]

    def shifts8(x, fill):
        xp = _halo_pad(x, 1, axis_name, n_dev, fill)
        return [
            gg.shift_plane(xp, dy, dx, fill)[1:-1] for dy, dx in gg.DIRS8
        ]

    def reduce_any(b):
        return jax.lax.psum(b.astype(jnp.int32), axis_name) > 0

    def reduce_sum(v):
        return jax.lax.psum(v, axis_name)

    return turbo.Comm(
        shift=shift, shifts8=shifts8, reduce_any=reduce_any,
        reduce_sum=reduce_sum, dense=False,
    )


def _psum_or_flags(flags, axis_name, nbits=6):
    """Bitwise OR of int32 flag masks across the mesh axis."""
    out = jnp.int32(0)
    for b in range(nbits):
        any_b = jax.lax.psum((flags >> b) & 1, axis_name) > 0
        out = out | jnp.where(any_b, jnp.int32(1 << b), jnp.int32(0))
    return out


def _prep_spatial(image, cfg, comm, axis_name, n_dev, row_off, h_glob):
    """Gaussian + canonical edge-weight planes on a row tile with halo.

    Mirrors ops.filters.gaussian_smooth + ops.grid_graph.edge_weight_planes
    (same taps, same replicate boundary, same global validity) on a tile."""
    taps = filters.gaussian_kernel_1d(cfg.sigma)
    r = (len(taps) - 1) // 2
    k = r + 1
    img = _halo_pad(image.astype(jnp.float32), k, axis_name, n_dev, None)
    sm = filters.gaussian_smooth(img, cfg.sigma)
    # rows [k-1, h_loc+k+1) of the padded tile are exact: one halo row each
    # side for the dy=1 edge shifts.
    sm = sm[k - 1 : sm.shape[0] - (k - 1)]
    h_loc, w = image.shape[0], image.shape[1]
    ndirs = 4 if cfg.connectivity == 8 else 2
    rowg = row_off + jnp.arange(h_loc, dtype=jnp.int32)[:, None]
    colg = jnp.arange(w, dtype=jnp.int32)[None, :]
    planes = []
    for d, (dy, dx) in enumerate(gg.DIRS4):
        if d < ndirs:
            nb = gg.shift_plane(sm, dy, dx, 0.0)[1:-1]
            diff = sm[1:-1] - nb
            wt = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
            va = (rowg + dy < h_glob) & (colg + dx >= 0) & (colg + dx < w)
            wt = jnp.where(va, wt, jnp.inf)
        else:
            wt = jnp.full((h_loc, w), jnp.inf, jnp.float32)
        planes.append(wt)
    weights = jnp.stack(planes)
    if cfg.quantize_weight_bits:
        scale = (2 ** cfg.quantize_weight_bits - 1) / (
            jnp.sqrt(3.0) * 255.0
        )
        weights = jnp.where(
            jnp.isfinite(weights),
            jnp.round(weights * scale) / scale, jnp.inf,
        )
    return weights


def _incident_views_spatial(weights, vidg, comm):
    """gg.incident_views with global vertex ids and halo shifts."""
    w8, eid8 = [], []
    for d, (dy, dx) in enumerate(gg.DIRS4):
        w8.append(weights[d])
        eid8.append(
            jnp.where(jnp.isfinite(weights[d]), vidg * 4 + d, INT32_MAX)
        )
    for d, (dy, dx) in enumerate(gg.DIRS4):
        wt = comm.shift(weights[d], -dy, -dx, jnp.inf)
        anchor = comm.shift(vidg, -dy, -dx, 0)
        eid8.append(jnp.where(jnp.isfinite(wt), anchor * 4 + d, INT32_MAX))
        w8.append(wt)
    return jnp.stack(w8), jnp.stack(eid8)


def _turbo_spatial_impl(image, cfg: SegmentationConfig, gossip_rounds: int,
                        axis_name: str, n_dev: int, h_glob: int):
    h_loc, w = image.shape[0], image.shape[1]
    v = h_glob * w
    v_loc = h_loc * w
    max_sweeps = 4 * (h_glob + w)
    comm = _make_comm(axis_name, n_dev)
    idx = jax.lax.axis_index(axis_name)
    row_off = idx * h_loc

    weights = _prep_spatial(image, cfg, comm, axis_name, n_dev, row_off,
                            h_glob)
    vidg = (
        (row_off + jnp.arange(h_loc, dtype=jnp.int32)[:, None]) * w
        + jnp.arange(w, dtype=jnp.int32)[None, :]
    )
    w8, eid8 = _incident_views_spatial(weights, vidg, comm)

    gather = lambda x: jax.lax.all_gather(x, axis_name, tiled=True)
    nb = max(cfg.weight_buckets, 1)
    if cfg.weight_buckets > 0:
        # Exact global bucket thresholds: gather the 4 weight planes
        # (replicated, transient — quality mode already replicates V-sized
        # stage-2 state) and reuse the dense sampling arithmetic so the
        # bucket ramp is bit-identical to single-device segment_turbo.
        wg = jnp.stack([gather(weights[d]) for d in range(4)])
        thresholds = turbo.bucket_thresholds(wg, nb)
    else:
        thresholds = jnp.array([jnp.inf], dtype=jnp.float32)

    gst = turbo.GossipState(
        L=vidg, S=jnp.ones((h_loc, w), jnp.int32),
        ID=jnp.zeros((h_loc, w), jnp.float32),
        merged=jnp.bool_(True), it=jnp.int32(0), bucket=jnp.int32(0),
        flags=jnp.int32(0),
    )
    # same handoff gates as the dense path (models/turbo.py _stage_g,
    # including the GSEG_GATE_DIV / GSEG_GATE_DIV_Q knobs, so A/B sweeps
    # exercise this path too); the sizes scheme differs (subsum convergecast
    # works under halo exchange) but every scheme computes exact sizes, so
    # the partition is identical.
    gate_c = (v // turbo._gate_div_q() if cfg.weight_buckets > 0
              else v // turbo._gate_div())

    def advance(s, s2):
        # quality mode: the bucket cap advances one bucket per round; keep
        # looping while buckets remain even if this round merged nothing.
        more = s.bucket + 1 < nb
        return s2._replace(
            bucket=jnp.minimum(s.bucket + 1, nb - 1),
            merged=s2.merged | more,
        )

    def gcond(s):
        c = comm.reduce_sum(jnp.sum((s.L == vidg).astype(jnp.int32)))
        return s.merged & ((s.it < gossip_rounds) | (c > gate_c))

    def gbody(s):
        return advance(s, turbo._ground(
            s, w8, eid8, vidg, cfg.k, cfg.min_size, "felz", max_sweeps,
            tau=thresholds[s.bucket], comm=comm,
            idle_compmin=s.it == 0,
        ))

    gst = jax.lax.while_loop(gcond, gbody, gst)

    # ---- extraction: per-tile chunked pair dedup, then all_gather the
    # small pools and dedup globally (replicated from here on).
    ew4 = jnp.stack([weights[d] for d in range(4)], axis=-1).reshape(-1)
    la = jnp.stack([gst.L] * 4, axis=-1).reshape(-1)
    lb = jnp.stack(
        [comm.shift(gst.L, dy, dx, -1) for dy, dx in gg.DIRS4], axis=-1
    ).reshape(-1)
    eid4 = jnp.stack([vidg * 4 + d for d in range(4)], axis=-1).reshape(-1)
    live4 = jnp.isfinite(ew4) & (la != lb) & (lb >= 0)
    lo = jnp.where(live4, jnp.minimum(la, lb), INT32_MAX)
    hi = jnp.where(live4, jnp.maximum(la, lb), INT32_MAX)
    # quality mode hands off at v/32 components with near-pixel-scale
    # boundaries (the dense path's measured "sponge" finding): mirror the
    # dense gate-scaled pool divisors (_extract_stage), halved locally for
    # cross-tile duplicate headroom.
    pair_div = (min(6, max(turbo._gate_div_q() // 5, 2))
                if cfg.weight_buckets > 0
                else min(24, max(turbo._gate_div() // 4, 3)))
    cap_loc = max(v_loc // max(pair_div // 2, 1), turbo._CAP_FLOOR)
    pm_l, plo_l, phi_l, pw_l, pe_l, ovf_l = turbo._chunked_pair_extract(
        lo, hi, ew4, eid4, cap_loc
    )
    plo_l = jnp.where(pm_l, plo_l, INT32_MAX)
    phi_l = jnp.where(pm_l, phi_l, INT32_MAX)
    pw_l = jnp.where(pm_l, pw_l, jnp.inf)

    g_lo, g_hi, g_w, g_e = (
        gather(plo_l), gather(phi_l), gather(pw_l), gather(pe_l)
    )
    # global flat dedup of the gathered pools (pair minima are exact within
    # tiles; cross-tile duplicates resolve here).
    pair_cap = max(v // pair_div, turbo._CAP_FLOOR)
    s_lo, s_hi, s_w, s_e = jax.lax.sort((g_lo, g_hi, g_w, g_e), num_keys=4)
    head = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_),
         (s_lo[1:] != s_lo[:-1]) | (s_hi[1:] != s_hi[:-1])]
    ) & (s_lo != INT32_MAX)
    pm, (plo, phi, pw, pe), pair_ovf = turbo._select_compact(
        head, [s_lo, s_hi, s_w, s_e], pair_cap
    )

    SZf = gather(gst.S).reshape(-1)
    IDf = gather(gst.ID).reshape(-1)
    Lg = gather(gst.L)

    # stage-2 entry state built by the SAME helper as dense extraction
    # (pool orientation, root list, comp_cap, bucket carry — see the
    # round-4 bucket-drift bug note on turbo._pools_to_state).
    base_flags = gst.flags | jnp.where(
        ovf_l, jnp.int32(turbo.FLAG_PAIR_OVERFLOW), jnp.int32(0)
    )
    st, rm, r0 = turbo._pools_to_state(
        pm, plo, phi, pw, pe, pair_ovf, v, cfg, SZf, IDf, gst.bucket,
        base_flags,
    )
    # ---- stage 2: replicated (identical deterministic compute per device).
    st = turbo._s2_stage(st, v, cfg, thresholds, nb)

    # ---- final map: replicated (v,) root table, local V-gather (same
    # rewrite as turbo._final_map — local L values are GLOBAL root ids,
    # so the gather needs no halo communication at all; the flood stays
    # under GSEG_FINAL_GATHER=0).
    vid_full = jnp.arange(v, dtype=jnp.int32).reshape(h_glob, w)
    seed = jnp.where(Lg == vid_full, Lg, INT32_MAX).reshape(-1)
    seed = seed.at[jnp.where(rm, r0, v)].set(st.fin, mode="drop")
    if os.environ.get("GSEG_FINAL_GATHER", "0") == "1":
        labels = seed[gst.L.reshape(-1)].reshape(gst.L.shape)
        fm_unconv = jnp.bool_(False)
    else:
        seed_loc = jax.lax.dynamic_slice(
            seed.reshape(h_glob, w), (row_off, 0), (h_loc, w)
        )
        labels, fm_unconv = turbo._value_flood(
            gst.L, seed_loc, max_sweeps, comm
        )
    flags = st.flags | jnp.where(
        fm_unconv, jnp.int32(turbo.FLAG_GOSSIP_UNCONVERGED), jnp.int32(0)
    )
    flags = _psum_or_flags(flags, axis_name)
    return labels, flags.reshape(1)


def segment_turbo_spatial(
    image: jnp.ndarray,
    cfg: SegmentationConfig,
    mesh: Mesh,
    axis: str = "space",
    gossip_rounds: int = 4,
):
    """Segment one image row-sharded across `mesh` with explicit
    collectives. Returns ((H, W) int32 labels row-sharded, () int flags).

    H must be divisible by the mesh axis size. The partition equals
    single-device `segment_turbo`'s exactly, in both speed mode and quality
    mode (weight_buckets > 0: thresholds are sampled from the gathered
    global weight planes with the dense arithmetic, and the bucket ramp /
    handoff gate / stage-2 schedule mirror models/turbo.py)."""
    h, w = image.shape[0], image.shape[1]
    n_dev = mesh.shape[axis]
    if h % n_dev:
        raise ValueError(f"H={h} not divisible by mesh axis size {n_dev}")
    taps = filters.gaussian_kernel_1d(cfg.sigma)
    k_halo = (len(taps) - 1) // 2 + 1
    if h // n_dev < k_halo:
        raise ValueError(
            f"tile height {h // n_dev} < halo {k_halo} (sigma={cfg.sigma}): "
            "halo exchange only reaches immediate mesh neighbors"
        )
    fn = _spatial_program(cfg, mesh, axis, gossip_rounds, n_dev, h)
    image = jax.device_put(
        image, NamedSharding(mesh, P(axis, None, None))
    )
    labels, flags = fn(image)
    return labels, jnp.max(flags)


@functools.lru_cache(maxsize=16)
def _spatial_program(cfg, mesh, axis, gossip_rounds, n_dev, h):
    """The jitted shard_map program, built once per configuration so that
    repeated calls reuse its compilation."""
    return jax.jit(jax.shard_map(
        functools.partial(
            _turbo_spatial_impl, cfg=cfg, gossip_rounds=gossip_rounds,
            axis_name=axis, n_dev=n_dev, h_glob=h,
        ),
        mesh=mesh,
        in_specs=P(axis, None, None),
        out_specs=(P(axis, None), P(axis)),
        # loop carries mix axis-varying (halo-exchanged) and replicated
        # values by design (e.g. the replicated stage-2 state); skip the
        # varying-manual-axes analysis rather than pcast every carry.
        check_vma=False,
    ))
