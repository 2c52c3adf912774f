"""Benchmark CLI: `python -m gseg.bench {perf|quality}`.

Rebuild of the reference's benchmark driver scripts (branches
performance_benchmark / benchmarking, SURVEY.md §2.3 B2-B4): runs the
resolution ladder or the quality protocol and writes JSONL (the quality run
also the Fig.4 style plots). Both run only on a GPU: without one they exit
nonzero and say which device JAX found.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gseg.bench")
    sub = p.add_subparsers(dest="cmd", required=True)

    pp = sub.add_parser("perf", help="resolution-ladder performance run")
    pp.add_argument("--algorithms", default="turbo")
    pp.add_argument("--max-mpix", type=float, default=9.0,
                    help="skip ladder rungs above this many megapixels")
    pp.add_argument("--reps", type=int, default=5)
    pp.add_argument("--k", type=float, default=300.0)
    pp.add_argument("--min-size", type=int, default=100)
    pp.add_argument("--out-dir", default="bench_out")

    qp = sub.add_parser("quality", help="ASA/UE quality run")
    qp.add_argument("--algorithms", default="turbo,kruskal_native")
    qp.add_argument("--bsds-root", default=os.environ.get("BSDS500_ROOT"))
    qp.add_argument("--split", default="val")
    qp.add_argument("--limit", type=int, default=None)
    qp.add_argument("--synthetic-n", type=int, default=20,
                    help="synthetic set size when BSDS500 is unavailable")
    qp.add_argument("--k", type=float, default=80.0)
    qp.add_argument("--min-size", type=int, default=100)
    qp.add_argument("--out-dir", default="bench_out")

    args = p.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    from ..config import SegmentationConfig
    from ..utils.jaxcache import (
        enable_parallel_gpu_compile,
        enable_persistent_cache,
    )
    from .harness import device_info

    enable_parallel_gpu_compile()

    dev = device_info(require_gpu=True)
    print(json.dumps(dev), flush=True)
    enable_persistent_cache()
    algorithms = tuple(a.strip() for a in args.algorithms.split(","))

    if args.cmd == "perf":
        from .harness import RESOLUTION_LADDER, run_performance_ladder

        cfg = SegmentationConfig(k=args.k, min_size=args.min_size)
        resolutions = [
            (h, w) for h, w in RESOLUTION_LADDER
            if h * w / 1e6 <= args.max_mpix
        ]
        rows = run_performance_ladder(
            algorithms, resolutions, args.reps, cfg,
            out_path=os.path.join(args.out_dir, "perf.jsonl"),
        )
        for r in rows:
            print(json.dumps({
                "algorithm": r["algorithm"], "mpix": r["mpix"],
                "total_ms": r["total"]["mean_s"] * 1e3,
                "mpix_per_s": r["mpix_per_s"], **dev,
            }))
        return 0

    # quality
    from ..utils import datasets
    from .harness import run_quality_benchmark, summarize_quality
    from .plots import plot_quality

    cfg = SegmentationConfig(k=args.k, min_size=args.min_size)
    if datasets.bsds500_available(args.bsds_root):
        samples = datasets.load_bsds500(args.bsds_root, args.split, args.limit)
        source = f"BSDS500:{args.split}"
    else:
        samples = datasets.synthetic_quality_set(n=args.synthetic_n)
        source = "synthetic"
    rows = run_quality_benchmark(
        samples, algorithms, cfg,
        out_path=os.path.join(args.out_dir, "quality.jsonl"),
    )
    plot_quality(rows, os.path.join(args.out_dir, "quality.png"))
    print(json.dumps({"source": source, "summary": summarize_quality(rows)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
