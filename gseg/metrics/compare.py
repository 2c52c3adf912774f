"""ASA / UE quality metrics — rebuild of the reference `comparetool`.

Reference branch `comparetool` (README.md:22) scores segmentations against
BSDS500 human ground truths (Report.pdf p.5-6 §4.2, Eqs. 1-2):

    ASA(S) = sum_k max_i |s_k ∩ g_i|                / sum_i |g_i|
    UE(S)  = sum_i sum_{k: s_k∩g_i≠∅} min(|s_k ∩ g_i|, |s_k - g_i|) / sum_i |g_i|

where s_k are segmentation components and g_i ground-truth segments; both
denominators equal the pixel count. When an image has several human ground
truths, the one maximizing ASA is used (report-extract.txt:608-611).

Implementation: one sparse overlap histogram per (seg, gt) pair via
np.unique on paired codes — O(N log N) on host; a C++ fast path lives in
gseg/native (felz.cpp: compare_asa_ue); `asa_ue_jax` is a jit/vmap-able on-device
version for benchmarking whole batches without host transfers.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _overlap_counts(seg: np.ndarray, gt: np.ndarray):
    """Sparse |s_k ∩ g_i| table: returns (seg_ids, gt_ids, counts) and the
    per-seg-component total sizes aligned to seg_ids."""
    seg = np.asarray(seg).ravel()
    gt = np.asarray(gt).ravel()
    _, seg_c = np.unique(seg, return_inverse=True)
    _, gt_c = np.unique(gt, return_inverse=True)
    n_gt = int(gt_c.max()) + 1
    code = seg_c.astype(np.int64) * n_gt + gt_c
    pair, cnt = np.unique(code, return_counts=True)
    sk = pair // n_gt
    gi = pair % n_gt
    seg_sizes = np.bincount(seg_c)
    return sk, gi, cnt, seg_sizes


def asa_ue(seg: np.ndarray, gt: np.ndarray) -> Tuple[float, float]:
    """ASA and UE of a segmentation vs one ground-truth label map."""
    sk, gi, cnt, seg_sizes = _overlap_counts(seg, gt)
    n = seg.size
    # ASA: per seg component, its largest overlap with any gt segment.
    best = np.zeros(seg_sizes.shape[0], dtype=np.int64)
    np.maximum.at(best, sk, cnt)
    asa = best.sum() / n
    # UE: per overlapping (s_k, g_i): min(|s_k ∩ g_i|, |s_k| - |s_k ∩ g_i|).
    ue = np.minimum(cnt, seg_sizes[sk] - cnt).sum() / n
    return float(asa), float(ue)


def asa_ue_best_gt(seg: np.ndarray, gts: Sequence[np.ndarray]) -> Tuple[float, float]:
    """Score against the ground truth maximizing ASA (reference protocol)."""
    best = (-1.0, 0.0)
    for gt in gts:
        a, u = asa_ue(seg, gt)
        if a > best[0]:
            best = (a, u)
    return best


def asa_ue_jax(seg, gt, num_seg: int, num_gt: int):
    """On-device ASA/UE via a dense (num_seg, num_gt) overlap histogram.

    seg/gt: (H, W) int labels already compacted to [0, num_seg)/[0, num_gt).
    Suitable for jit/vmap when component counts are modest (e.g. scoring a
    vmapped BSDS batch without host round-trips). Static capacities follow
    the XLA static-shape rule (SURVEY.md §7).
    """
    import jax.numpy as jnp

    seg = seg.reshape(-1)
    gt = gt.reshape(-1)
    n = seg.shape[0]
    code = seg.astype(jnp.int32) * num_gt + gt.astype(jnp.int32)
    hist = jnp.zeros((num_seg * num_gt,), dtype=jnp.int32).at[code].add(
        1, mode="drop"
    )
    hist = hist.reshape(num_seg, num_gt)
    seg_sizes = jnp.sum(hist, axis=1)
    asa = jnp.sum(jnp.max(hist, axis=1)) / n
    ue = jnp.sum(jnp.minimum(hist, (seg_sizes[:, None] - hist))) / n
    return asa, ue
