"""Sequential Felzenszwalb-Huttenlocher segmentation (Kruskal + union-find).

Rebuild of the reference's CPU baseline semantics (branch
`felzenswlab_baseline`, reference README.md:33; the official algorithm of
ref [23]: sort edges by weight, sweep in order joining components when
w <= min(Int(Ca)+k/|Ca|, Int(Cb)+k/|Cb|), then a min-size post pass).
Written from the published algorithm, in NumPy + a Python sweep loop — this
is the quality gold standard the BSDS ASA/UE scores are measured against
(reference Fig. 4: CPU baseline ASA median 0.974). A C++ implementation of
the same semantics lives in gseg/native for speed.
"""

from __future__ import annotations

import numpy as np

from ..config import SegmentationConfig
from .boruvka_cpu import (
    _edge_arrays,
    edge_weight_planes_np,
    gaussian_smooth_np,
)


class UnionFind:
    """Rank + path-compression union-find (reference disjoint-set.h semantics)."""

    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.rank = np.zeros(n, dtype=np.int32)
        self.size = np.ones(n, dtype=np.int64)

    def find(self, x: int) -> int:
        root = x
        p = self.parent
        while p[root] != root:
            root = p[root]
        while p[x] != root:
            p[x], x = root, p[x]
        return root

    def union(self, a: int, b: int) -> int:
        if self.rank[a] < self.rank[b]:
            a, b = b, a
        self.parent[b] = a
        self.size[a] += self.size[b]
        if self.rank[a] == self.rank[b]:
            self.rank[a] += 1
        return a


def segment_kruskal_np(
    image: np.ndarray,
    cfg: SegmentationConfig,
    weights: np.ndarray | None = None,
) -> np.ndarray:
    """Returns (H, W) int32 labels (root vertex ids)."""
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

    # Stable sort on weight => ties process in canonical edge-id order,
    # matching the deterministic tie-break used on the device paths.
    order = np.argsort(ew, kind="stable")
    ea, eb, ew = ea[order], eb[order], ew[order]

    uf = UnionFind(v)
    intdiff = np.zeros(v, dtype=np.float32)
    k = np.float32(cfg.k)
    for i in range(ea.shape[0]):
        a = uf.find(ea[i])
        b = uf.find(eb[i])
        if a == b:
            continue
        wgt = ew[i]
        ta = intdiff[a] + k / np.float32(uf.size[a])
        tb = intdiff[b] + k / np.float32(uf.size[b])
        if wgt <= ta and wgt <= tb:
            r = uf.union(a, b)
            intdiff[r] = wgt  # sorted order: current edge is the max so far

    if cfg.min_size > 1:
        for i in range(ea.shape[0]):
            a = uf.find(ea[i])
            b = uf.find(eb[i])
            if a != b and (uf.size[a] < cfg.min_size or uf.size[b] < cfg.min_size):
                uf.union(a, b)

    labels = np.fromiter(
        (uf.find(i) for i in range(v)), dtype=np.int64, count=v
    )
    return labels.astype(np.int32).reshape(h, w)
