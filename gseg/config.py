"""Segmentation configuration.

JAX analog of the reference suite's CLI parameter conventions
(Felzenszwalb `sigma k min_size input output`, reference README.md:33 /
Report.pdf p.4 §4: K=80, hierarchy level 4 for benchmarks).

One frozen dataclass replaces the reference's per-binary positional args and
CMake-time flags (SURVEY.md §5 config/flag system).
"""

from __future__ import annotations

import dataclasses


ALGORITHMS = (
    "turbo",            # staged gossip + compact-graph path
    "atomic",           # scatter-min Boruvka-Felzenszwalb, on-device while_loop
    "atomic_hostsync",  # same, host-synced convergence flag per iteration
    "fastmst",          # DPP/FastMST path: sort-based segmented min + contraction
    "superpixel",       # superpixel hierarchy: per-iteration re-weighting
    "kruskal_cpu",      # sequential Felzenszwalb oracle (NumPy)
    "boruvka_cpu",      # sequential Boruvka oracle (NumPy)
    "kruskal_native",   # C++ Felzenszwalb baseline (ctypes)
)


@dataclasses.dataclass(frozen=True)
class SegmentationConfig:
    """Parameters shared by every algorithm variant.

    sigma:      Gaussian pre-smoothing std-dev (reference default 0.8).
    k:          Felzenszwalb threshold constant (tau(C) = k / |C|).
    min_size:   minimum component size enforced in a post-pass.
    max_iters:  static cap on Boruvka outer iterations. The reference observed
                <= 10-20 iterations on every image (Report p.5); 32 is a safe
                static bound for the lax.while_loop.
    algorithm:  one of ALGORITHMS.
    hierarchy_levels: number of per-iteration label maps to record (0 = only
                the final labels). The reference's Fast Hierarchy Creation
                stores a supervertex map per Boruvka iteration (Report p.4
                §3.2.3).
    quantize_weight_bits: 0 = full float32 edge weights (a deliberate quality
                improvement over the reference's 12-bit packed weights,
                Report p.4: 26+26+12-bit edge keys). Set to 12 to reproduce
                reference-style quantization for validation.
    connectivity: 8 (reference default: E,S,SE,NE canonical undirected dirs)
                or 4 (E,S).
    weight_buckets: 0 = plain Boruvka rounds (reference semantics). N > 0
                enables quality mode: edge eligibility ramps through N
                weight-quantile buckets (advance on convergence within a
                bucket), approximating Kruskal's sorted-order predicate
                evaluation while staying data-parallel — this closes most of
                the Boruvka-vs-Kruskal ASA gap that the reference accepted
                (Fig. 4: GPU ASA 0.905 vs CPU 0.974).
    on_overflow: what the checked turbo entry does when a capacity or
                sweep-budget flag is raised (the turbo path uses fixed
                measured-heuristic capacities; violations are detected, never
                silent): "raise" (default), "fallback" (route to the
                capacity-unbounded atomic path), or "ignore" (experiments).
    """

    sigma: float = 0.8
    k: float = 300.0
    min_size: int = 100
    max_iters: int = 32
    algorithm: str = "atomic"
    hierarchy_levels: int = 0
    quantize_weight_bits: int = 0
    connectivity: int = 8
    weight_buckets: int = 0
    on_overflow: str = "raise"

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {self.algorithm!r}; expected one of {ALGORITHMS}"
            )
        if self.connectivity not in (4, 8):
            raise ValueError("connectivity must be 4 or 8")
        if self.quantize_weight_bits not in (0, 8, 10, 12, 16):
            raise ValueError("quantize_weight_bits must be 0/8/10/12/16")
        if self.on_overflow not in ("raise", "fallback", "ignore"):
            raise ValueError("on_overflow must be raise/fallback/ignore")
