#!/usr/bin/env python3
"""End-to-end smoke test of the segmentation system on an NVIDIA GPU.

Drives the main path once through the entry points a user calls, and checks
every result by the repo's own references:

  kernels  builds the tile-pass library (ops/tilepass.py), then runs turbo
           at 1080p and 4K with every dense fixpoint computed twice, as the
           kernel and as the XLA sweep: the planes must be bit-equal at
           every call of all five rules.
  cli      `gseg.cli.main` (the `python -m gseg` CLI) at 1080p and 4K.
  api      `gseg.segment` with turbo in speed mode and quality mode
           (weight_buckets=16) at 1080p and 4K, blobs and textured content;
           atomic at 4K must give turbo's partition.
  oracle   the largest ULP gap between the GPU's smoothed and weight planes
           and their NumPy mirrors; turbo against the NumPy oracle
           (models/boruvka_cpu) on identical weights, exact canonical
           partitions: the 20-seed synthetic set and 540p / 1080p blobs and
           textured, speed mode and wb16.
  others   fastmst, superpixel, every hierarchy and `segment_batch` at 540p
           against their oracles and invariants.

All programs are compiled first, concurrently on a thread pool (compiling
dominates a cold run); the phases then run the compiled programs, and the
public entry points find theirs in the persistent compile cache. Each phase
prints JSON lines: the first call's seconds, block_until_ready-fenced
warm times, the peak device memory so far and the card. Any failed check raises, and the script exits
nonzero; so does a run without a GPU.

With --four it runs only the multi-device paths, on four GPUs, each against
its single-device result: turbo_spatial on a 1x4 `space` mesh at 4K,
multichip_step on a 2x2 `data` x `space` mesh and segment_batch_sharded on
4 images.

The last line of standard output is
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SPEED = dict(sigma=0.8, k=300.0, min_size=100)
FHD, UHD, QHD = (1080, 1920), (2160, 3840), (540, 960)
SYNTH = (161, 241)  # datasets.synthetic_quality_set
COMPILE_WORKERS = 8


def log(**row) -> None:
    print(json.dumps(row), flush=True)


def require_gpu(count: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU — JAX's default backend is "
                 f"{devs[0].platform!r}; this smoke test runs only on a GPU")
    if len(devs) < count:
        sys.exit(f"chip_smoke: needs {count} GPUs, JAX sees {len(devs)}")
    return devs


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(out, flush=True)
    return out.splitlines()[0]


class Smoke:
    def __init__(self, card_line: str):
        import jax

        self.card = card_line
        self.dev = jax.devices()[0]
        self.compiled = {}
        self.both = {}

    def precompile(self, programs: dict) -> None:
        """Lower `programs` ({name: () -> jax.stages.Lowered}) in order,
        then compile them on a thread pool. Compiled programs are kept by
        name; those the entry points compile again are served by the
        persistent compile cache."""
        t0 = time.perf_counter()
        lowered = {name: lower() for name, lower in programs.items()}
        lower_s = time.perf_counter() - t0

        def compile_one(item):
            name, lo = item
            t = time.perf_counter()
            return name, lo.compile(), time.perf_counter() - t

        t0 = time.perf_counter()
        with ThreadPoolExecutor(COMPILE_WORKERS) as pool:
            done = list(pool.map(compile_one, lowered.items()))
        self.compiled.update({name: c for name, c, _ in done})
        log(phase="precompile", programs=len(done), workers=COMPILE_WORKERS,
            lower_s=lower_s, compile_wall_s=time.perf_counter() - t0,
            compile_s={name if isinstance(name, str)
                       else "/".join(map(str, name)): dt
                       for name, _, dt in done})

    def peak(self) -> int:
        return int(self.dev.memory_stats()["peak_bytes_in_use"])

    def run(self, fn, *args, reps: int = 3):
        """First call (compile + run), then `reps` fenced warm calls.
        Returns (output, first-call seconds, warm seconds)."""
        import jax

        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        first = time.perf_counter() - t0
        warm = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            warm.append(time.perf_counter() - t0)
        return out, first, warm

    def report(self, phase: str, first=None, warm=None, **kw) -> None:
        row = dict(phase=phase, **kw)
        if first is not None:  # the first call loads the compiled program
            row["first_call_s"] = first
            row["ms"] = [t * 1e3 for t in warm]
        row["peak_bytes"] = self.peak()
        row["card"] = self.card
        log(**row)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def same_partition(a, b) -> bool:
    from gseg.utils.labels import canonical_min_labels_np

    return np.array_equal(canonical_min_labels_np(np.asarray(a)),
                          canonical_min_labels_np(np.asarray(b)))


def image(shape, content: str, seed: int = 0) -> np.ndarray:
    from gseg.utils.synthetic import blobs_image, textured_image

    h, w = shape
    if content == "blobs":
        return blobs_image(h, w, num_blobs=max(8, h * w // 65536), noise=8.0,
                           seed=seed)
    return textured_image(h, w, seed=seed)


def struct(shape, dtype=np.uint8):
    import jax

    return jax.ShapeDtypeStruct(shape, dtype)


def programs(s: Smoke, phases) -> dict:
    """Every program the single-GPU phases run, as lowering thunks."""
    import jax

    from gseg.bench.fixpoints import Both, fixpoints
    from gseg.config import SegmentationConfig as C
    from gseg.models import atomic_boruvka as atomic
    from gseg.models import fastmst, superpixel, turbo
    from gseg.parallel.batching import segment_batch_flagged

    def flagged_turbo(**kw):
        return jax.jit(lambda im, w=None: turbo.segment_turbo_impl(
            im, C(**kw), 2, weights_override=w))

    def checked(shape):
        def lower():
            s.both[shape] = Both()
            with fixpoints(s.both[shape]):
                return flagged_turbo(**SPEED).lower(struct(shape + (3,)))
        return lower

    def override(shape, **kw):
        return lambda: flagged_turbo(**kw).lower(
            struct(shape + (3,)), struct((4,) + shape, np.float32))

    def entry(fn, shape, *args):
        return lambda: fn.lower(struct(shape), *args)

    out = {}
    if "kernels" in phases:
        out.update({("kernels", sh): checked(sh) for sh in (FHD, UHD)})
    if {"cli", "api"} & set(phases):
        for sh in (FHD, UHD):
            for wb in (0, 16):
                out[("turbo", sh, wb)] = entry(
                    turbo.segment_turbo_flagged, sh + (3,),
                    C(algorithm="turbo", weight_buckets=wb, **SPEED), 2)
        out[("atomic", UHD)] = entry(atomic.segment_atomic, UHD + (3,),
                                     C(algorithm="atomic", **SPEED))
    if "oracle" in phases:
        for wb in (0, 16):
            out[("oracle", SYNTH, wb)] = override(
                SYNTH, k=30.0, min_size=10, weight_buckets=wb)
            for sh in (QHD, FHD):
                out[("oracle", sh, wb)] = override(sh, weight_buckets=wb,
                                                   **SPEED)
    if "others" in phases:
        im = QHD + (3,)
        hier = dict(k=120.0, min_size=1, max_iters=16)
        out.update({
            ("fastmst", QHD): entry(fastmst.segment_fastmst_flagged, im,
                                    C(algorithm="fastmst", **SPEED)),
            ("atomic", QHD): entry(atomic.segment_atomic, im,
                                   C(algorithm="atomic", **SPEED)),
            ("superpixel", QHD): entry(
                superpixel.segment_superpixel_flagged, im,
                C(algorithm="superpixel", **SPEED)),
            ("turbo", QHD): entry(turbo.segment_turbo_flagged, im,
                                  C(algorithm="turbo", **SPEED), 2),
            ("batch", QHD): entry(segment_batch_flagged, (3,) + im,
                                  C(algorithm="turbo", **SPEED)),
            ("hier", "turbo"): entry(turbo.segment_turbo_hierarchy_flagged,
                                     im, C(algorithm="turbo", **hier), 2),
            ("hier", "fastmst"): entry(
                fastmst.segment_fastmst_hierarchy_flagged, im,
                C(algorithm="fastmst", **hier)),
            ("hier", "atomic"): entry(atomic.segment_atomic_hierarchy, im,
                                      C(algorithm="atomic", **hier)),
            ("hier", "superpixel"): entry(
                superpixel.segment_superpixel_hierarchy_flagged, im,
                C(algorithm="superpixel", **hier)),
        })
    return out


def phase_kernels(s: Smoke) -> None:
    import jax.numpy as jnp

    for shape, content in ((FHD, "blobs"), (UHD, "textured")):
        both = s.both[shape]
        img = jnp.asarray(image(shape, content))
        (labels, flags), first, _ = s.run(s.compiled[("kernels", shape)],
                                          img, reps=0)
        check(int(flags) == 0, f"kernel parity run flags {int(flags)}")
        check(all(both.calls.values()),
              f"a rule was never called: {both.calls}")
        check(not any(both.mismatches.values()),
              f"kernel != XLA sweep: {both.mismatches}")
        s.report("kernel_parity", shape=list(shape), content=content,
                 calls=both.calls, mismatched_cells=both.mismatches,
                 unconverged=both.unconverged, run_s=first)


def phase_cli(s: Smoke) -> None:
    import jax.numpy as jnp

    from gseg import cli
    from gseg.config import SegmentationConfig
    from gseg.models.turbo import segment_turbo_flagged
    from gseg.utils import image_io

    cfg = SegmentationConfig(algorithm="turbo", **SPEED)
    with tempfile.TemporaryDirectory() as d:
        for shape in (FHD, UHD):
            img = image(shape, "blobs")
            src, dst = os.path.join(d, "in.ppm"), os.path.join(d, "out.ppm")
            lab = os.path.join(d, "labels.npy")
            image_io.write_ppm(src, img)
            argv = [src, dst, "--algorithm", "turbo", "--k", str(cfg.k),
                    "--min-size", str(cfg.min_size), "--labels-out", lab,
                    "--time"]
            t0 = time.perf_counter()
            check(cli.main(argv) == 0, "cli failed")
            cold = time.perf_counter() - t0
            t0 = time.perf_counter()
            check(cli.main(argv) == 0, "cli failed")
            warm = time.perf_counter() - t0
            labels = np.load(lab)
            ref, flags = segment_turbo_flagged(jnp.asarray(img), cfg, 2)
            check(int(flags) == 0, "turbo flags")
            check(labels.shape == shape and same_partition(labels, ref),
                  "cli labels != API partition")
            check(image_io.read_image(dst).shape == shape + (3,),
                  "cli rendering shape")
            s.report("cli", shape=list(shape), cold_s=cold, warm_s=warm,
                     components=int(labels.max()) + 1)


def phase_api(s: Smoke) -> None:
    import jax.numpy as jnp

    import gseg
    from gseg.config import SegmentationConfig
    from gseg.models.turbo import segment_turbo_flagged

    for shape in (FHD, UHD):
        for wb in (0, 16):
            cfg = SegmentationConfig(algorithm="turbo", weight_buckets=wb,
                                     **SPEED)
            for content in ("blobs", "textured"):
                img = image(shape, content)
                t0 = time.perf_counter()
                labels = np.asarray(gseg.segment(img, config=cfg))
                first = time.perf_counter() - t0  # compile + upload + run
                dev = jnp.asarray(img)
                (lab2, flags), _, warm = s.run(
                    lambda im: segment_turbo_flagged(im, cfg, 2), dev)
                check(int(flags) == 0, f"flags {int(flags)}")
                check(np.array_equal(labels, np.asarray(lab2)),
                      "segment() != flagged entry")
                check(labels.shape == shape and labels.min() >= 0,
                      "label shape/range")
                s.report("api_turbo", shape=list(shape),
                         weight_buckets=wb, content=content, first=first,
                         warm=warm,
                         components=int(np.unique(labels).size))
                if shape == UHD and wb == 0 and content == "blobs":
                    turbo_labels = labels
    acfg = SegmentationConfig(algorithm="atomic", **SPEED)
    img = image(UHD, "blobs")
    from gseg.models.atomic_boruvka import segment_atomic

    dev = jnp.asarray(img)
    atomic, first, warm = s.run(lambda im: segment_atomic(im, acfg), dev)
    check(same_partition(atomic, turbo_labels), "atomic != turbo at 4K")
    s.report("api_atomic", shape=list(UHD), first=first, warm=warm,
             equals_turbo=True)


def _ulp(a: np.ndarray, b: np.ndarray) -> int:
    """Largest ULP gap between two float32 arrays of non-negative values
    (infinities must coincide)."""
    fa, fb = np.isfinite(a), np.isfinite(b)
    check(np.array_equal(fa, fb), "inf pattern differs")
    ia = a[fa].astype(np.float32).view(np.int32).astype(np.int64)
    ib = b[fb].astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.max(np.abs(ia - ib))) if ia.size else 0


def phase_oracle(s: Smoke) -> None:
    import jax
    import jax.numpy as jnp

    from gseg.config import SegmentationConfig
    from gseg.models import boruvka_cpu as oracle
    from gseg.ops import filters
    from gseg.ops import grid_graph as gg
    from gseg.utils.datasets import synthetic_quality_set

    cfg = SegmentationConfig(**SPEED)
    smooth = jax.jit(lambda im: filters.gaussian_smooth(im, cfg.sigma))
    planes = jax.jit(lambda sm: gg.edge_weight_planes(sm)[0])
    for shape in (FHD, UHD):
        for content in ("blobs", "textured"):
            img = image(shape, content)
            sm_np = oracle.gaussian_smooth_np(img, cfg.sigma)
            w_np, _ = oracle.edge_weight_planes_np(sm_np)
            sm_gpu = np.asarray(smooth(jnp.asarray(img)))
            w_gpu = np.asarray(planes(jnp.asarray(sm_np)))
            s.report("weights_ulp", shape=list(shape), content=content,
                     smoothed_max_ulp=_ulp(sm_gpu, sm_np),
                     weights_max_ulp=_ulp(w_gpu, w_np))

    def parity(cfg, img, fn):
        sm = oracle.gaussian_smooth_np(img, cfg.sigma)
        w_np, _ = oracle.edge_weight_planes_np(sm)
        labels, flags = fn(jnp.asarray(img), jnp.asarray(w_np))
        check(int(flags) == 0, f"flags {int(flags)}")
        return same_partition(labels,
                              oracle.segment_boruvka_np(img, cfg, w_np))

    for wb in (0, 16):
        qcfg = SegmentationConfig(k=30.0, min_size=10, weight_buckets=wb)
        fn = s.compiled[("oracle", SYNTH, wb)]
        equal = [parity(qcfg, img, fn)
                 for _, img, _ in synthetic_quality_set(n=20, h=SYNTH[0],
                                                        w=SYNTH[1])]
        check(all(equal), f"synthetic seeds differ: {equal}")
        s.report("oracle_synthetic", weight_buckets=wb, seeds=len(equal),
                 equal=sum(equal))
        cfg = SegmentationConfig(weight_buckets=wb, **SPEED)
        for shape in (QHD, FHD):
            fn = s.compiled[("oracle", shape, wb)]
            for content in ("blobs", "textured"):
                eq = parity(cfg, image(shape, content), fn)
                check(eq, f"oracle parity {shape} {content} wb{wb}")
                s.report("oracle_parity", shape=list(shape),
                         content=content, weight_buckets=wb, equal=eq)


def phase_others(s: Smoke) -> None:
    import jax
    import jax.numpy as jnp

    import gseg
    from gseg.config import SegmentationConfig
    from gseg.models.boruvka_cpu import segment_boruvka_np
    from gseg.models.fastmst_np import superpixel_hierarchy_np
    from gseg.ops import filters
    from gseg.ops import grid_graph as gg
    from gseg.parallel.batching import segment_batch

    img = image(QHD, "blobs")
    dev = jnp.asarray(img)
    cfg = SegmentationConfig(**SPEED)
    # oracle on the GPU's own weights: these paths have no weights hook
    w_gpu = np.asarray(jax.jit(lambda im: gg.edge_weight_planes(
        filters.gaussian_smooth(im, cfg.sigma))[0])(dev))
    expect = segment_boruvka_np(img, cfg, w_gpu)

    for algo in ("fastmst", "atomic"):
        c = SegmentationConfig(algorithm=algo, **SPEED)
        t0 = time.perf_counter()
        labels = np.asarray(gseg.segment(img, config=c))
        check(np.array_equal(labels, expect), f"{algo} != oracle")
        s.report("others", algorithm=algo, shape=list(QHD),
                 first_s=time.perf_counter() - t0, equals_oracle=True)

    for algo in ("turbo", "fastmst", "atomic", "superpixel"):
        c = SegmentationConfig(algorithm=algo, k=120.0, min_size=1,
                               max_iters=16)
        t0 = time.perf_counter()
        levels, final = gseg.segment_hierarchy(img, config=c)
        levels, final = np.asarray(levels), np.asarray(final)
        counts = [np.unique(lv).size for lv in levels]
        check(counts[0] == img.shape[0] * img.shape[1], "level 0")
        check(all(a >= b for a, b in zip(counts, counts[1:])),
              f"{algo} levels do not coarsen: {counts}")
        for i in range(len(levels) - 1):  # each level nests in the next
            pair = np.unique(np.stack([levels[i].ravel(),
                                       levels[i + 1].ravel()]), axis=1)
            check(np.unique(pair[0]).size == pair.shape[1],
                  f"{algo} level {i} does not nest in level {i + 1}")
        row = dict(algorithm=algo, shape=list(QHD), levels=len(levels),
                   first_s=time.perf_counter() - t0)
        if algo == "superpixel":
            np_levels, _ = superpixel_hierarchy_np(img, c)
            n = min(len(np_levels), len(levels))
            row["levels_equal_oracle"] = sum(
                same_partition(np_levels[i], levels[i]) for i in range(n))
            row["levels_compared"] = n
        else:
            w_c = segment_boruvka_np(img, c, w_gpu)
            check(same_partition(final, w_c), f"{algo} hierarchy final")
            row["final_equals_oracle"] = True
        s.report("hierarchy", **row)

    c = SegmentationConfig(algorithm="superpixel", **SPEED)
    sp = np.asarray(gseg.segment(img, config=c))
    check(sp.shape == QHD and np.unique(sp).size >= 1, "superpixel")
    s.report("others", algorithm="superpixel", shape=list(QHD),
             components=int(np.unique(sp).size))

    c = SegmentationConfig(algorithm="turbo", **SPEED)
    imgs = np.stack([image(QHD, "blobs", seed=i) for i in range(2)]
                    + [image(QHD, "textured", seed=0)])
    out, first, warm = s.run(lambda x: segment_batch(x, c),
                             jnp.asarray(imgs))
    for i in range(len(imgs)):
        single = np.asarray(gseg.segment(imgs[i], config=c))
        check(np.array_equal(np.asarray(out[i]), single),
              f"segment_batch image {i} != segment")
    s.report("segment_batch", shape=list(imgs.shape[:3]), first=first,
             warm=warm)


def phase_four(s: Smoke) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from gseg.config import SegmentationConfig
    from gseg.models.atomic_boruvka import segment_atomic
    from gseg.models.turbo import segment_turbo
    from gseg.parallel.batching import (
        data_parallel_mesh,
        segment_batch,
        segment_batch_sharded,
    )
    from gseg.parallel.spatial import multichip_step
    from gseg.parallel.turbo_spatial import segment_turbo_spatial

    from jax.sharding import NamedSharding, PartitionSpec as P

    from gseg.models.turbo import segment_turbo_flagged
    from gseg.parallel import batching, turbo_spatial

    devs = jax.devices()[:4]
    cfg = SegmentationConfig(**SPEED)
    tcfg = SegmentationConfig(algorithm="turbo", **SPEED)
    space = Mesh(np.asarray(devs), ("space",))
    data = data_parallel_mesh(devs)
    batch = (4,) + FHD + (3,)

    def sharded(shape, mesh, spec):
        return jax.ShapeDtypeStruct(shape, np.uint8,
                                    sharding=NamedSharding(mesh, spec))

    s.precompile({
        "turbo_spatial": lambda: turbo_spatial._spatial_program(
            cfg, space, "space", 4, 4, UHD[0]).lower(
                sharded(UHD + (3,), space, P("space", None, None))),
        "turbo": lambda: segment_turbo_flagged.lower(
            struct(UHD + (3,)), cfg, 2),
        "batch_sharded": lambda: batching._sharded_program(
            tcfg, data, "data").lower(sharded(batch, data, P("data"))),
        "batch": lambda: batching.segment_batch_flagged.lower(
            struct(batch), tcfg),
    })

    img = image(UHD, "blobs")
    mesh = space
    (labels, flags), first, warm = s.run(
        lambda im: segment_turbo_spatial(im, cfg, mesh), jnp.asarray(img))
    check(int(flags) == 0, f"turbo_spatial flags {int(flags)}")
    ref = np.asarray(segment_turbo(jnp.asarray(img), cfg))
    check(np.array_equal(np.asarray(labels), ref),
          "turbo_spatial != single-device turbo")
    s.report("four_turbo_spatial", mesh="1x4 space", shape=list(UHD),
             first=first, warm=warm)

    mesh = Mesh(np.asarray(devs).reshape(2, 2), ("data", "space"))
    imgs = np.stack([image(QHD, "blobs", seed=i) for i in range(2)])
    out, first, warm = s.run(lambda x: multichip_step(x, cfg, mesh),
                             jnp.asarray(imgs))
    for i in range(len(imgs)):
        single = np.asarray(segment_atomic(jnp.asarray(imgs[i]), cfg))
        check(np.array_equal(np.asarray(out[i]), single),
              f"multichip_step image {i} != single device")
    s.report("four_multichip_step", mesh="2x2 data x space",
             shape=list(imgs.shape[:3]), first=first, warm=warm)

    mesh = data
    imgs = np.stack([image(FHD, "blobs", seed=i) for i in range(2)]
                    + [image(FHD, "textured", seed=i) for i in range(2)])
    out, first, warm = s.run(
        lambda x: segment_batch_sharded(x, tcfg, mesh), jnp.asarray(imgs))
    single = np.asarray(segment_batch(jnp.asarray(imgs), tcfg))
    check(np.array_equal(np.asarray(out), single),
          "segment_batch_sharded != segment_batch")
    s.report("four_segment_batch_sharded", mesh="4 data",
             shape=list(imgs.shape[:3]), first=first, warm=warm)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the multi-device paths, on four GPUs")
    p.add_argument("--phases", default="kernels,cli,api,oracle,others",
                   help="comma list of single-GPU phases to run")
    args = p.parse_args(argv)

    from gseg.utils.jaxcache import (
        GPU_COMPILE_FLAGS,
        enable_parallel_gpu_compile,
    )

    enable_parallel_gpu_compile()  # before the backend starts
    count = 4 if args.four else 1
    devs = require_gpu(count)
    log(phase="setup", xla_flags=os.environ["XLA_FLAGS"],
        compile_flags=list(GPU_COMPILE_FLAGS))
    line = card()
    from gseg.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    s = Smoke(line)
    t0 = time.perf_counter()
    if args.four:
        phase_four(s)
    else:
        phases = {"kernels": phase_kernels, "cli": phase_cli,
                  "api": phase_api, "oracle": phase_oracle,
                  "others": phase_others}
        names = args.phases.split(",")
        if "kernels" in names:
            from gseg.ops import tilepass

            t1 = time.perf_counter()
            tilepass._register()
            s.report("kernel_build", build_s=time.perf_counter() - t1,
                     library=os.path.relpath(tilepass.LIB_PATH))
        s.precompile(programs(s, names))
        for name in names:
            phases[name](s)
    log(phase="total", seconds=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
