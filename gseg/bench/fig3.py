"""Fig. 3 study: conventional (host-synced) vs device-orchestrated loop.

Rebuild of the reference's dynamic-parallelism experiment (Report.pdf p.5,
report-extract 486-517; BASELINE.md): the reference ran its atomic
Felzenszwalb at 480p for 1000 reps in both modes — `ab conventional` (a
4-byte convergence-flag device->host copy per Boruvka iteration) and
`ab dynamic` (a device-side orchestration kernel; no host crossing) — and
reported min/median/max. Their finding: the device-orchestrated mode had a
*tighter* distribution but a slightly worse median (4955/5004/5140 us vs
4666/4709/6493 us), blamed on an SM-resource quirk of CUDA dynamic
parallelism.

The JAX equivalents (SURVEY.md §2.4 S7/S8): `segment_atomic` keeps the
whole Boruvka loop in `lax.while_loop` on device (the analog of ab
dynamic), and `segment_atomic_hostsync` jits one round at a time and
fetches the merge flag each iteration (the analog of ab conventional).

Usage:
    python -m gseg.bench.fig3 --reps 100 --out bench_out/fig3.jsonl
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _run_mode(fn, img, reps: int) -> dict:
    import jax

    jax.block_until_ready(fn(img))  # warmup / compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(img))
        ts.append(time.perf_counter() - t0)
    ts = np.asarray(ts)
    return {
        "min_s": float(ts.min()),
        "median_s": float(np.median(ts)),
        "max_s": float(ts.max()),
        "mean_s": float(ts.mean()),
        "std_s": float(ts.std()),
        "reps": reps,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=854)
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from ..utils.jaxcache import (
        enable_parallel_gpu_compile,
        enable_persistent_cache,
    )
    from .harness import device_info

    enable_parallel_gpu_compile()
    dev = device_info(require_gpu=True)
    enable_persistent_cache()
    import jax
    import jax.numpy as jnp

    from ..config import SegmentationConfig
    from ..models.atomic_boruvka import segment_atomic, segment_atomic_hostsync
    from ..utils.synthetic import blobs_image

    cfg = SegmentationConfig(k=300.0, min_size=100)
    img_np = blobs_image(args.height, args.width, num_blobs=12, noise=8.0,
                         seed=0)
    img = jax.device_put(jnp.asarray(img_np))

    rows = []
    for mode, fn, inp in (
        ("device_loop", lambda im: segment_atomic(im, cfg), img),
        # hostsync takes numpy (it round-trips per iteration by design)
        ("hostsync", lambda im: jnp.asarray(
            segment_atomic_hostsync(im, cfg)), img_np),
    ):
        stats = _run_mode(fn, inp, args.reps)
        stats.update({"mode": mode, "height": args.height,
                      "width": args.width, **dev})
        rows.append(stats)
        print(json.dumps(stats), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
