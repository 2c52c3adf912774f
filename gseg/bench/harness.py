"""Performance & quality benchmark harness.

Rebuild of the reference's benchmark layer (SURVEY.md §2.3): branch
`performance_benchmark` (JPG resolution ladder 960x540..7680x4320, 20 reps,
high-resolution clocks, disk I/O excluded — Report.pdf p.4 §4.1) and branch
`benchmarking` + `comparetool` (BSDS500 ASA/UE quality protocol — Report.pdf
p.5-6 §4.2). Emits structured JSON rows; `plots.py` renders the Fig. 2 /
Fig. 4 style figures for side-by-side comparison with the reference.

Timing protocol notes:
  - every rep ends in `jax.block_until_ready` on its outputs; the input is
    already on the device (the reference protocol likewise excludes I/O).
  - every row names the device it ran on (`device_info`); the measurement
    paths refuse to run without a GPU.
  - phase attribution mirrors the reference's {total | filter+graph |
    segmentation} panels: filter+graph is timed as its own jitted program;
    segmentation = total - filter+graph (the full pipeline is one fused XLA
    program, so an in-program split would change what is measured).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, Iterable, List, Sequence

import numpy as np

from ..config import SegmentationConfig

# Reference resolution ladder (reference README.md:26).
RESOLUTION_LADDER = (
    (540, 960),
    (720, 1280),
    (1080, 1920),
    (1440, 2560),
    (2160, 3840),
    (2880, 5120),
    (4320, 7680),
)


def device_info(require_gpu: bool = True) -> dict:
    """Platform, device kind and count of the default backend. With
    require_gpu, no GPU is an error: a measurement is never silently taken
    on the CPU."""
    import jax

    devs = jax.devices()
    info = {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs)}
    if require_gpu and info["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default backend is {info['platform']!r} "
            f"({info['device_kind']}); measurements run only on the GPU")
    return info


def _timed(fn: Callable, reps: int) -> Dict[str, float]:
    """Time fn over `reps` runs after one warm-up (compile) run, each
    fenced by `jax.block_until_ready`."""
    import jax

    jax.block_until_ready(fn())  # warmup / compile
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    mean = float(np.mean(times))
    return {
        "mean_s": mean,
        "std_s": float(np.std(times)),
        "min_s": float(np.min(times)),
        "max_s": float(np.max(times)),
        # the reference's stability criterion: fraction of measurements
        # within 5% of the mean (Report: "95% of measurements within 5%",
        # SURVEY.md §4 item 4) — recorded so our rows state it directly.
        "within5pct": float(np.mean(np.abs(np.array(times) - mean)
                                    <= 0.05 * mean)) if mean > 0 else 0.0,
        "reps": reps,
    }


def segment_fn(algorithm: str, cfg: SegmentationConfig, checked: bool = True):
    """Jitted end-to-end segmentation callable for a device algorithm.

    checked=False returns the turbo path WITHOUT the per-call host flag
    fetch — for timing loops; validate the configuration once with the
    checked variant first."""
    import jax.numpy as jnp

    if algorithm == "turbo":
        from ..models.turbo import segment_turbo, segment_turbo_flagged

        if not checked:
            # gossip_rounds passed explicitly: a defaulted static arg is a
            # different jit cache key than an explicitly-passed equal value,
            # and the checked warmup call passes it explicitly.
            return lambda img: segment_turbo_flagged(img, cfg, 2)[0]
        return lambda img: segment_turbo(img, cfg)
    if algorithm == "atomic":
        from ..models.atomic_boruvka import segment_atomic

        return lambda img: segment_atomic(img, cfg)
    if algorithm == "atomic_hostsync":
        from ..models.atomic_boruvka import segment_atomic_hostsync

        return lambda img: segment_atomic_hostsync(np.asarray(img), cfg)
    if algorithm == "fastmst":
        from ..models.fastmst import segment_fastmst, segment_fastmst_flagged

        if not checked:
            return lambda img: segment_fastmst_flagged(img, cfg)[0]
        return lambda img: segment_fastmst(img, cfg)
    if algorithm == "superpixel":
        from ..models.superpixel import (
            segment_superpixel,
            segment_superpixel_flagged,
        )

        if not checked:
            return lambda img: segment_superpixel_flagged(img, cfg)[0]
        return lambda img: segment_superpixel(img, cfg)
    if algorithm == "kruskal_native":
        from ..native.bindings import segment_kruskal_native

        return lambda img: segment_kruskal_native(np.asarray(img), cfg)
    if algorithm == "kruskal_cpu":
        from ..models.felzenszwalb_cpu import segment_kruskal_np

        return lambda img: segment_kruskal_np(np.asarray(img), cfg)
    if algorithm == "boruvka_cpu":
        from ..models.boruvka_cpu import segment_boruvka_np

        return lambda img: segment_boruvka_np(np.asarray(img), cfg)
    raise ValueError(f"unknown algorithm {algorithm!r}")


def segment_level_fn(algorithm: str, cfg: SegmentationConfig,
                     level: int = 4):
    """Hierarchy-level-`level` segmentation callable (reference quality
    protocol: BSDS500 scored at hierarchy level 4, report-extract
    651-658). Hierarchy algorithms return the captured level-`level` label
    map (clamped to the last level); single-level algorithms (atomic,
    CPU baselines) return their final labels, as in the reference."""

    def pick(levels, level):
        return levels[min(level, levels.shape[0] - 1)]

    if algorithm == "turbo":
        from ..models.turbo import segment_turbo_hierarchy

        return lambda img: pick(segment_turbo_hierarchy(img, cfg)[0], level)
    if algorithm == "fastmst":
        from ..models.fastmst import segment_fastmst_hierarchy

        return lambda img: pick(segment_fastmst_hierarchy(img, cfg)[0],
                                level)
    if algorithm == "superpixel":
        from ..models.superpixel import segment_superpixel_hierarchy

        return lambda img: pick(segment_superpixel_hierarchy(img, cfg)[0],
                                level)
    return segment_fn(algorithm, cfg)


def prep_fn(cfg: SegmentationConfig):
    """Jitted filter + graph-creation stage (for phase attribution)."""
    import functools
    import jax

    from ..models.atomic_boruvka import prepare_graph

    return jax.jit(functools.partial(prepare_graph, cfg=cfg))


def run_performance_ladder(
    algorithms: Sequence[str] = ("turbo",),
    resolutions: Sequence = RESOLUTION_LADDER,
    reps: int = 20,
    cfg: SegmentationConfig | None = None,
    out_path: str | None = None,
    content: str = "blobs",
) -> List[dict]:
    """Reference Fig. 2 protocol on synthetic ladder images.

    content: "blobs" (piecewise-constant regions + noise; the tuned-on
    default) or "textured" (photo-like multi-octave value noise — de-risks
    blob-specific capacity/gate tuning; reference benchmarks photographs,
    reference README.md:26).

    Returns one JSON-able row per (algorithm, resolution) with total and
    filter+graph phase stats.
    """
    import jax
    import jax.numpy as jnp

    from ..utils.synthetic import blobs_image, textured_image

    cfg = cfg or SegmentationConfig(k=300.0, min_size=100)
    rows: List[dict] = []
    for h, w in resolutions:
        if content == "textured":
            img_np = textured_image(h, w, seed=0)
        else:
            img_np = blobs_image(
                h, w, num_blobs=max(8, (h * w) // 65536), seed=0
            )
        img = jax.device_put(jnp.asarray(img_np))
        prep = prep_fn(cfg)
        prep_stats = _timed(lambda: prep(img)[0], reps)
        for algo in algorithms:
            if algo in ("turbo", "fastmst", "superpixel"):
                # Validate capacities once (checked call raises on overflow),
                # then time the uncheck-variant (no per-call host fetch).
                jax.block_until_ready(
                    segment_fn(algo, cfg, checked=True)(img))
            fn = segment_fn(algo, cfg, checked=False)
            total = _timed(lambda: fn(img), reps)
            # Re-fetch the flags AFTER the timed reps (same input + config
            # => deterministic flags; one extra run) so a capacity overflow
            # can never hide inside a headline number.
            flags_val = 0
            if algo == "turbo":
                from ..models.turbo import segment_turbo_flagged

                flags_val = int(segment_turbo_flagged(img, cfg, 2)[1])
            elif algo == "fastmst":
                from ..models.fastmst import segment_fastmst_flagged

                flags_val = int(segment_fastmst_flagged(img, cfg)[1])
            elif algo == "superpixel":
                from ..models.superpixel import segment_superpixel_flagged

                flags_val = int(segment_superpixel_flagged(img, cfg)[1])
            row = {
                **device_info(require_gpu=False),
                "flags": flags_val,
                "algorithm": algo,
                "content": content,
                "height": h,
                "width": w,
                "mpix": h * w / 1e6,
                "total": total,
                "filter_graph": prep_stats,
                "segmentation_s": max(
                    total["mean_s"] - prep_stats["mean_s"], 0.0
                ),
                "mpix_per_s": (h * w / 1e6) / total["mean_s"]
                if total["mean_s"] > 0
                else float("inf"),
            }
            rows.append(row)
    if out_path:
        with open(out_path, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return rows


def run_quality_benchmark(
    images_gts: Iterable,
    algorithms: Sequence[str] = ("turbo", "kruskal_native"),
    cfg: SegmentationConfig | None = None,
    out_path: str | None = None,
) -> List[dict]:
    """Reference Fig. 4 protocol: ASA/UE per image, best ground truth.

    images_gts: iterable of (name, image (H,W,3) uint8, [gt label maps]).
    Reference settings: K=80, min_size=100 on BSDS500 (report-extract 651-658).
    """
    from ..metrics.compare import asa_ue_best_gt
    from ..utils.labels import compact_labels_np

    cfg = cfg or SegmentationConfig(k=80.0, min_size=100)
    rows: List[dict] = []
    fns = {a: segment_fn(a, cfg) for a in algorithms}
    for name, image, gts in images_gts:
        import jax.numpy as jnp

        dev_img = jnp.asarray(image)
        for algo, fn in fns.items():
            labels = np.asarray(fn(dev_img))
            asa, ue = asa_ue_best_gt(compact_labels_np(labels), gts)
            rows.append(
                {"image": name, "algorithm": algo, "asa": asa, "ue": ue}
            )
    if out_path:
        with open(out_path, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return rows


def summarize_quality(rows: List[dict]) -> Dict[str, dict]:
    """Per-algorithm ASA/UE medians (the reference's headline numbers)."""
    out: Dict[str, dict] = {}
    algos = sorted({r["algorithm"] for r in rows})
    for a in algos:
        asas = [r["asa"] for r in rows if r["algorithm"] == a]
        ues = [r["ue"] for r in rows if r["algorithm"] == a]
        out[a] = {
            "asa_median": float(np.median(asas)),
            "ue_median": float(np.median(ues)),
            "n": len(asas),
        }
    return out
