"""Flagship benchmark: turbo-path segmentation throughput at 1080p, one GPU.

Prints the device (platform, device_kind, count), then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device"}.

Protocol mirrors the reference's (Report.pdf p.4 §4.1): repeated timed runs
on the same input, disk I/O excluded (the input lives on the device before
timing; every rep ends in `jax.block_until_ready`). Baseline: the
reference's atomic CUDA path at 1920x1080 on a GTX 1080 Ti — 51.3 ms TOTAL
(filter + graph + segmentation, decoded Fig. 2a, BASELINE.md) = 40.4
MPix/s. Our timed region covers the same stages (Gaussian + edge weights +
full Boruvka loop + min-size), all on the device. Without a GPU it exits
nonzero instead of timing the CPU.
"""

from __future__ import annotations

import json
import time

import numpy as np


def main() -> None:
    from gseg.utils.jaxcache import enable_parallel_gpu_compile

    enable_parallel_gpu_compile()
    import jax
    import jax.numpy as jnp

    from gseg.bench.harness import device_info
    from gseg.utils.jaxcache import enable_persistent_cache

    dev = device_info(require_gpu=True)
    print(json.dumps(dev), flush=True)
    enable_persistent_cache()

    from gseg.config import SegmentationConfig
    from gseg.models.turbo import segment_turbo, segment_turbo_flagged
    from gseg.utils.synthetic import blobs_image

    h, w = 1080, 1920
    cfg = SegmentationConfig(sigma=0.8, k=300.0, min_size=100, max_iters=32)
    img = jax.device_put(
        jnp.asarray(blobs_image(h, w, num_blobs=32, noise=8.0, seed=0)))

    # Warmup / compile, with the capacity-flag check (raises on violation).
    jax.block_until_ready(segment_turbo(img, cfg))

    reps = 5
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        # gossip_rounds passed explicitly, as the checked warmup call does:
        # a defaulted static arg is a different jit cache key.
        jax.block_until_ready(segment_turbo_flagged(img, cfg, 2))
        times.append(time.perf_counter() - t0)
    mean_s = float(np.mean(times))

    mpix = (h * w) / 1e6
    mpix_per_s = mpix / mean_s
    baseline_mpix_per_s = mpix / 0.0513  # reference atomic total @1080p
    print(json.dumps({
        "metric": "1080p_turbo_total_throughput",
        "value": round(mpix_per_s, 2),
        "unit": "MPix/s",
        "vs_baseline": round(mpix_per_s / baseline_mpix_per_s, 3),
        "device": dev,
    }))


if __name__ == "__main__":
    main()
