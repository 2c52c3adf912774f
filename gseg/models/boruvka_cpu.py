"""Sequential Boruvka-Felzenszwalb oracle (NumPy).

Rebuild of the reference's CPU stepping-stone implementations
(`felzenszwalb_Boruvka_cpp` and `boruvka_sequential_python` branches,
reference README.md:34): the same round-based Boruvka merge rules as the JAX
atomic path, in plain NumPy float32, used as an executable specification.
`models.atomic_boruvka.segment_atomic` must match this oracle's labels
EXACTLY (same tie-breaking by canonical edge id, same float32 predicate
arithmetic) — the rebuild's formalization of the reference's
cross-implementation differential testing (SURVEY.md §4.2-4.3).
"""

from __future__ import annotations

import math

import numpy as np

from ..config import SegmentationConfig

INT32_MAX = np.iinfo(np.int32).max

_DIRS4 = ((0, 1), (1, 0), (1, 1), (1, -1))


def gaussian_smooth_np(img: np.ndarray, sigma: float) -> np.ndarray:
    """NumPy mirror of ops.filters.gaussian_smooth (same taps, edge padding,
    same shift-sum evaluation order so float32 results match bit-for-bit)."""
    img = img.astype(np.float32)
    sigma = max(float(sigma), 1e-2)
    radius = max(int(math.ceil(4.0 * sigma)), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2).astype(np.float32)
    k = (k / np.sum(k)).astype(np.float32)

    def conv(a, axis):
        pad = [(0, 0)] * a.ndim
        pad[axis] = (radius, radius)
        p = np.pad(a, pad, mode="edge")
        n = a.shape[axis]
        out = np.zeros_like(a)
        for i, t in enumerate(k):
            sl = [slice(None)] * a.ndim
            sl[axis] = slice(i, i + n)
            out = out + np.float32(t) * p[tuple(sl)]
        return out

    return conv(conv(img, 0), 1)


def edge_weight_planes_np(img: np.ndarray, connectivity: int = 8,
                          quantize_bits: int = 0):
    """NumPy mirror of ops.grid_graph.edge_weight_planes."""
    img = img.astype(np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w = img.shape[:2]
    weights = np.full((4, h, w), np.inf, dtype=np.float32)
    valid = np.zeros((4, h, w), dtype=bool)
    ndirs = 4 if connectivity == 8 else 2
    for d, (dy, dx) in enumerate(_DIRS4[:ndirs]):
        ys = slice(0, h - dy)
        xs = slice(max(-dx, 0), w - max(dx, 0))
        ys2 = slice(dy, h)
        xs2 = slice(max(dx, 0), w + min(dx, 0))
        diff = img[ys, xs] - img[ys2, xs2]
        wt = np.sqrt(np.sum(diff * diff, axis=-1)).astype(np.float32)
        if quantize_bits:
            scale = np.float32((2**quantize_bits - 1) / (math.sqrt(3.0) * 255.0))
            wt = (np.round(wt * scale) / scale).astype(np.float32)
        weights[d, ys, xs] = wt
        valid[d, ys, xs] = True
    return weights, valid


def bucket_thresholds_np(weights: np.ndarray, num_buckets: int) -> np.ndarray:
    """Weight-quantile bucket thresholds for quality mode.

    Deterministic stride sample of the eid-ordered weight planes (identical
    arithmetic in the NumPy oracle and the jnp paths so bucketed runs stay
    partition-comparable). Threshold b = the ((b+1)/N)-quantile of finite
    sampled weights; the last threshold is +inf.
    """
    flat = np.asarray(weights).transpose(1, 2, 0).reshape(-1)  # eid order
    stride = max(flat.size // 65536, 1)
    sample = flat[::stride][:65536].astype(np.float32)
    sample = np.where(np.isfinite(sample), sample, np.float32(np.inf))
    sample = np.sort(sample)
    n_fin = int(np.isfinite(sample).sum())
    out = np.full(num_buckets, np.inf, dtype=np.float32)
    for b in range(num_buckets - 1):
        idx = min(max(((b + 1) * n_fin) // num_buckets - 1, 0),
                  max(n_fin - 1, 0))
        out[b] = sample[idx] if n_fin else np.float32(np.inf)
    return out


def _edge_arrays(weights, valid, w):
    """Flatten canonical planes to edge arrays indexed by eid = anchor*4+d."""
    h = weights.shape[1]
    v = h * w
    offs = np.array([dy * w + dx for dy, dx in _DIRS4], dtype=np.int64)
    eidv = valid.transpose(1, 2, 0).reshape(-1)          # (4V,), eid order
    ew = weights.transpose(1, 2, 0).reshape(-1)
    a = np.repeat(np.arange(v, dtype=np.int64), 4)
    b = a + np.tile(offs, v)
    b = np.where(eidv, b, 0)
    return a, b, ew, eidv


def segment_boruvka_np(
    image: np.ndarray,
    cfg: SegmentationConfig,
    weights: np.ndarray | None = None,
    return_levels: bool = False,
):
    """Round-based Boruvka-Felzenszwalb in NumPy; returns (H, W) int32 labels
    (root vertex ids). Pass `weights` (4, H, W) to skip smoothing (used by the
    equivalence tests to feed identical float inputs to oracle and device path).
    """
    h, w = image.shape[0], image.shape[1]
    v = h * w
    if weights is None:
        sm = gaussian_smooth_np(image, cfg.sigma)
        weights, _ = edge_weight_planes_np(
            sm, cfg.connectivity, cfg.quantize_weight_bits
        )
    valid = np.isfinite(weights)
    ea, eb, ew, ev = _edge_arrays(weights, valid, w)
    live = np.nonzero(ev)[0]
    ea, eb, ew = ea[live], eb[live], ew[live]
    eid = live.astype(np.int64)

    parent = np.arange(v, dtype=np.int64)
    size = np.ones(v, dtype=np.int64)
    intdiff = np.zeros(v, dtype=np.float32)
    levels = [parent.astype(np.int32).copy()] if return_levels else None

    def flatten(p):
        while True:
            p2 = p[p]
            if np.array_equal(p2, p):
                return p
            p = p2

    if cfg.weight_buckets > 0:
        thresholds = bucket_thresholds_np(weights, cfg.weight_buckets)
    else:
        thresholds = np.array([np.inf], dtype=np.float32)

    def one_phase(mode, parent, size, intdiff):
        # quality mode: the weight cap advances one quantile bucket per
        # ROUND (not per convergence) — same ASA recovery at ~no extra
        # rounds (see tests); identical rule in models/turbo.py.
        bucket = 0
        max_rounds = cfg.max_iters + len(thresholds)
        for _ in range(max_rounds):
            tau = (thresholds[min(bucket, len(thresholds) - 1)]
                   if mode == "felz" else np.float32(np.inf))
            ra, rb = parent[ea], parent[eb]
            out = (ra != rb) & (ew <= tau)
            # per-component min eligible outgoing edge, ties -> min eid
            comp_minw = np.full(v, np.inf, dtype=np.float32)
            np.minimum.at(comp_minw, ra[out], ew[out])
            np.minimum.at(comp_minw, rb[out], ew[out])
            comp_eid = np.full(v, INT32_MAX, dtype=np.int64)
            besta = out & (ew == comp_minw[ra])
            bestb = out & (ew == comp_minw[rb])
            np.minimum.at(comp_eid, ra[besta], eid[besta])
            np.minimum.at(comp_eid, rb[bestb], eid[bestb])
            has = comp_eid != INT32_MAX

            idx = np.arange(v, dtype=np.int64)
            offs = np.array([dy * w + dx for dy, dx in _DIRS4], dtype=np.int64)
            sa = np.where(has, comp_eid // 4, 0)
            sb = sa + offs[np.where(has, comp_eid % 4, 0)]
            rsa, rsb = parent[sa], parent[sb]
            other = np.where(rsa == idx, rsb, rsa)
            cw = np.where(has, comp_minw, np.inf).astype(np.float32)

            if mode == "felz":
                # Multiply-form Felzenszwalb predicate: (w - Int(C))*|C| <= k
                # instead of w <= Int(C) + k/|C| (reference Report.pdf p.2
                # Eq. MInt). Mathematically identical for |C| > 0, but sub/
                # mul round identically on every backend whereas an
                # accelerator's f32 division need not be IEEE-exact (an
                # earlier accelerator differed from the CPU on 34% of k/s
                # values at k=30), which flips near-tie merges. All JAX paths use the same
                # form. size==0 stale non-root slots (lhs 0*inf -> nan)
                # are masked by `has` below.
                kf = np.float32(cfg.k)
                with np.errstate(invalid="ignore"):
                    lhs_self = (cw - intdiff) * size.astype(np.float32)
                    lhs_other = ((cw - intdiff[other])
                                 * size[other].astype(np.float32))
                ok = (lhs_self <= kf) & (lhs_other <= kf)
            else:
                ok = size < cfg.min_size
            hook = has & ok

            succ = np.where(hook, other, idx)
            mutual = (succ[succ] == idx) & (succ != idx)
            succ = np.where(mutual & (idx < succ), idx, succ)
            used = succ != idx
            if mode == "felz":
                bucket += 1
            if not used.any():
                if mode == "felz" and bucket < len(thresholds):
                    continue  # buckets remain: keep ramping the cap
                break

            new_root = flatten(succ)
            parent_new = new_root[parent]
            is_root = parent == idx
            size_new = np.zeros(v, dtype=np.int64)
            np.add.at(size_new, parent_new[is_root], size[is_root])
            intdiff_new = np.zeros(v, dtype=np.float32)
            np.maximum.at(intdiff_new, parent_new[is_root], intdiff[is_root])
            np.maximum.at(intdiff_new, parent_new[used], cw[used])
            parent, size, intdiff = parent_new, size_new, intdiff_new
            if return_levels and mode == "felz":
                levels.append(parent.astype(np.int32).copy())
        return parent, size, intdiff

    parent, size, intdiff = one_phase("felz", parent, size, intdiff)
    if cfg.min_size > 1:
        parent, size, intdiff = one_phase("minsize", parent, size, intdiff)

    labels = parent.astype(np.int32).reshape(h, w)
    if return_levels:
        return labels, np.stack(levels).reshape(-1, h, w)
    return labels
