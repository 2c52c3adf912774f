"""Phase profiler for the turbo path on the GPU.

Times cumulative prefixes of the pipeline (prep -> +gossip -> +extract ->
+stage2 -> full) as separate jitted programs, so per-phase cost is the
difference of adjacent rows. Also reports gossip round count, stage-2 round
count and the capacity flags — the diagnostics that size every capacity and
kernel decision (see models/turbo.py docstring).

Usage:
    python -m gseg.bench.profile_turbo --height 1080 --width 1920 \
        [--content textured] [--trace DIR]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--weight-buckets", type=int, default=0)
    ap.add_argument("--gossip-rounds", type=int, default=2)
    ap.add_argument("--phases", default="prep,gossip,extract,s2,full")
    ap.add_argument("--content", default="blobs",
                    choices=("blobs", "textured"))
    ap.add_argument("--trace", default=None,
                    help="also trace one run of the full program into "
                         "this directory and print device time by stage")
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
    from ..models import turbo
    from ..utils.synthetic import blobs_image, textured_image

    h, w = args.height, args.width
    gr = args.gossip_rounds
    cfg = SegmentationConfig(
        k=300.0, min_size=100, weight_buckets=args.weight_buckets
    )
    img = jax.device_put(jnp.asarray(
        blobs_image(h, w, num_blobs=max(8, (h * w) // 65536), noise=8.0,
                    seed=0)
        if args.content == "blobs" else textured_image(h, w, seed=0)))

    def f_prep(im):
        from ..ops import filters
        from ..ops import grid_graph as gg

        sm = filters.gaussian_smooth(im, cfg.sigma)
        wts, _ = gg.edge_weight_planes(
            sm, cfg.connectivity, cfg.quantize_weight_bits
        )
        return (jnp.isfinite(wts).sum(),)  # invalid slots hold +inf

    def f_gossip(im):
        gst, _, _ = turbo._stage_g(im, cfg, gr)
        return gst.L.max(), gst.it, gst.flags

    def f_extract(im):
        gst, wts, _ = turbo._stage_g(im, cfg, gr)
        st, rm, r0 = turbo._extract_stage(gst, wts, cfg)
        return st.esrc.max(), gst.it, st.flags

    def f_s2(im):
        gst, wts, thr = turbo._stage_g(im, cfg, gr)
        st, rm, r0 = turbo._extract_stage(gst, wts, cfg)
        st = turbo._s2_stage(st, h * w, cfg, thr, max(cfg.weight_buckets, 1))
        return st.fin.max(), st.it, st.flags

    def f_full(im):
        labels, flags = turbo.segment_turbo_impl(im, cfg, gr)
        return labels.max(), jnp.int32(0), flags

    fns = {
        "prep": f_prep, "gossip": f_gossip, "extract": f_extract,
        "s2": f_s2, "full": f_full,
    }
    for name in filter(None, args.phases.split(",")):
        fn = jax.jit(fns[name])
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(img))
        compile_s = time.perf_counter() - t0
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(img))
            ts.append(time.perf_counter() - t0)
        row = {
            "phase": name,
            "h": h,
            "w": w,
            "content": args.content,
            "mean_s": float(np.mean(ts)),
            "min_s": float(np.min(ts)),
            "compile_s": compile_s,
            **dev,
        }
        if len(out) == 3:
            row["iters"] = int(out[1])
            row["flags"] = int(out[2])
        print(json.dumps(row), flush=True)

    if args.trace:
        from .trace import device_time

        jax.block_until_ready(turbo.segment_turbo_flagged(img, cfg, gr))
        with jax.profiler.trace(args.trace):
            jax.block_until_ready(turbo.segment_turbo_flagged(img, cfg, gr))
        print(json.dumps({"trace": args.trace, "h": h, "w": w,
                          "content": args.content,
                          **device_time(args.trace), **dev}), flush=True)


if __name__ == "__main__":
    main()
