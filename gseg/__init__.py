"""gseg — graph-based image segmentation framework in JAX.

A ground-up JAX/XLA rebuild of the capabilities of
`akankshabaranwal/graph-algorithm-image-segmentation-GPGPU` (an ETH Zurich
CUDA suite for Felzenszwalb-style MST image segmentation): atomic-path
Boruvka-Felzenszwalb, DPP/FastMST segmentation hierarchies, superpixel
hierarchies, sequential CPU oracles, ASA/UE quality metrics, and a
performance/quality benchmark harness. See SURVEY.md for the component map.

Public API:
    segment(image, sigma=.8, k=300, min_size=100, algorithm="atomic")
        -> (H, W) int32 label map
    segment_hierarchy(...) -> (L, H, W) label maps + final labels
    SegmentationConfig, colorize, asa_ue
"""

from __future__ import annotations

import numpy as np

from .config import ALGORITHMS, SegmentationConfig
from .utils.labels import colorize, colorize_hierarchy, compact_labels_np

__version__ = "0.1.0"

__all__ = [
    "ALGORITHMS",
    "SegmentationConfig",
    "segment",
    "segment_hierarchy",
    "colorize",
    "colorize_hierarchy",
    "compact_labels_np",
    "__version__",
]


def segment(image, sigma=0.8, k=300.0, min_size=100, algorithm="atomic",
            config: SegmentationConfig | None = None):
    """Segment an (H, W, 3) image; returns (H, W) int32 labels
    (root vertex ids — use compact_labels_np for consecutive ids)."""
    cfg = config or SegmentationConfig(
        sigma=sigma, k=k, min_size=min_size, algorithm=algorithm
    )
    _check_weight_buckets(cfg, cfg.algorithm)
    image = np.asarray(image)
    if cfg.algorithm == "turbo":
        from .models.turbo import segment_turbo
        import jax.numpy as jnp

        return segment_turbo(jnp.asarray(image), cfg)
    if cfg.algorithm == "atomic":
        from .models.atomic_boruvka import segment_atomic
        import jax.numpy as jnp

        return segment_atomic(jnp.asarray(image), cfg)
    if cfg.algorithm == "atomic_hostsync":
        from .models.atomic_boruvka import segment_atomic_hostsync

        return segment_atomic_hostsync(image, cfg)
    if cfg.algorithm == "fastmst":
        from .models.fastmst import segment_fastmst
        import jax.numpy as jnp

        return segment_fastmst(jnp.asarray(image), cfg)
    if cfg.algorithm == "superpixel":
        from .models.superpixel import segment_superpixel
        import jax.numpy as jnp

        return segment_superpixel(jnp.asarray(image), cfg)
    if cfg.algorithm == "boruvka_cpu":
        from .models.boruvka_cpu import segment_boruvka_np

        return segment_boruvka_np(image, cfg)
    if cfg.algorithm == "kruskal_cpu":
        from .models.felzenszwalb_cpu import segment_kruskal_np

        return segment_kruskal_np(image, cfg)
    if cfg.algorithm == "kruskal_native":
        from .native.bindings import segment_kruskal_native

        return segment_kruskal_native(image, cfg)
    raise ValueError(f"unknown algorithm {cfg.algorithm!r}")


# Paths that honor cfg.weight_buckets (the quality-mode bucket ramp); every
# other algorithm ignores it, which would silently produce a different
# partition than the one the user asked for.
_BUCKET_AWARE = ("turbo", "boruvka_cpu")


def _check_weight_buckets(cfg: SegmentationConfig, route: str) -> None:
    # Kruskal paths already evaluate the predicate in sorted weight order —
    # the quality-mode ramp is a no-op there, not a silent semantic change.
    kruskal = ("kruskal_cpu", "kruskal_native")
    if cfg.weight_buckets > 0 and route not in _BUCKET_AWARE + kruskal:
        raise ValueError(
            f"weight_buckets={cfg.weight_buckets} is only honored by "
            f"{_BUCKET_AWARE}; the {route!r} path would silently ignore it "
            "and produce a different partition. Use weight_buckets=0 or "
            "algorithm='turbo'."
        )


def segment_hierarchy(image, sigma=0.8, k=300.0, min_size=100,
                      algorithm="atomic", config: SegmentationConfig | None = None):
    """Segment and return the full per-round hierarchy.

    Returns (levels, labels): levels (L, H, W) int32 one label map per
    Boruvka round (the reference's segmentation-hierarchy output,
    Report.pdf p.4 §3.2.3), labels (H, W) the final map after min-size.
    """
    cfg = config or SegmentationConfig(
        sigma=sigma, k=k, min_size=min_size, algorithm=algorithm
    )
    _check_weight_buckets(cfg, cfg.algorithm)
    image = np.asarray(image)
    if cfg.algorithm == "turbo":
        from .models.turbo import segment_turbo_hierarchy
        import jax.numpy as jnp

        return segment_turbo_hierarchy(jnp.asarray(image), cfg)
    if cfg.algorithm in ("atomic", "atomic_hostsync"):
        from .models.atomic_boruvka import segment_atomic_hierarchy
        import jax.numpy as jnp

        return segment_atomic_hierarchy(jnp.asarray(image), cfg)
    if cfg.algorithm == "fastmst":
        from .models.fastmst import segment_fastmst_hierarchy
        import jax.numpy as jnp

        return segment_fastmst_hierarchy(jnp.asarray(image), cfg)
    if cfg.algorithm == "superpixel":
        from .models.superpixel import segment_superpixel_hierarchy
        import jax.numpy as jnp

        return segment_superpixel_hierarchy(jnp.asarray(image), cfg)
    if cfg.algorithm == "boruvka_cpu":
        from .models.boruvka_cpu import segment_boruvka_np

        labels, levels = segment_boruvka_np(image, cfg, return_levels=True)
        return levels, labels
    raise ValueError(f"no hierarchy mode for algorithm {cfg.algorithm!r}")
