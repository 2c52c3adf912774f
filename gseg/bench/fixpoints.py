"""Tile-pass kernels vs XLA sweeps for turbo's dense fixpoints, on the GPU.

Two tools, both driven through `models.turbo`'s own round code:

  Both          a fixpoint implementation that runs every dense fixpoint
                twice, as the tile-pass kernel and as the XLA sweep, returns
                the sweep's result and counts, per rule, the cells where the
                two differ. A turbo run traced with it checks the kernels on
                the planes of a real run.
  main()        end-to-end A/B: turbo with the kernels and with the XLA
                sweeps, both compiled in this process and timed in turns
                (k, x, x, k, ...) on the same inputs.

    python -m gseg.bench.fixpoints [--reps 5] [--sizes 1080x1920,2160x3840]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SegmentationConfig
from ..models import turbo
from ..ops import tilepass


def _bits(x):
    return (jax.lax.bitcast_convert_type(x, jnp.int32)
            if x.dtype == jnp.float32 else x)


class Both:
    """Kernel and sweep side by side; see the module docstring."""

    def __init__(self):
        self.calls = {rule: 0 for rule in tilepass.RULES}
        self.mismatches = {rule: 0 for rule in tilepass.RULES}
        self.unconverged = {rule: 0 for rule in tilepass.RULES}

    def _record(self, rule, got, ref):
        *gp, gu = got
        *rp, ru = ref
        n = sum(jnp.sum(_bits(a) != _bits(b)) for a, b in zip(gp, rp))

        def note(n, gu, ru):
            self.calls[rule] += 1
            self.mismatches[rule] += int(n) + int(bool(gu) != bool(ru))
            self.unconverged[rule] += int(bool(ru))

        jax.debug.callback(note, n, gu, ru)
        return ref

    def compmin(self, L, bw, be, sz, ms, idle=None):
        return self._record(
            "compmin", tilepass.compmin(L, bw, be, sz, ms, idle=idle),
            turbo._compmin_gossip(L, bw, be, sz, ms, idle=idle))

    def label_dist(self, L, allow8, idf, dist, ms):
        return self._record(
            "label_dist", tilepass.label_dist(L, allow8, idf, dist, ms),
            turbo._label_gossip(L, allow8, idf, dist, ms))

    def label(self, L, allow8, idf, ms):
        return self._record(
            "label", tilepass.label(L, allow8, idf, ms),
            turbo._label_gossip_nd(L, allow8, idf, ms))

    def value_flood(self, L, val, ms):
        return self._record(
            "value", tilepass.value_flood(L, val, ms),
            turbo._value_flood(L, val, ms))

    def subtree_sums(self, pdir, s, ms):
        return self._record(
            "subsum", tilepass.subtree_sums(pdir, s, ms),
            turbo._subtree_sweeps(pdir, s, ms))


@contextlib.contextmanager
def fixpoints(impl):
    """Trace turbo's dense fixpoints with `impl` (None = XLA sweeps). Only
    programs traced inside the block are affected; give each its own fresh
    jit (a new lambda) so no cached trace is reused."""
    with mock.patch.object(
            turbo, "_fixpoints",
            lambda comm=None: None if comm is not None and not comm.dense
            else impl):
        yield


def compile_turbo(image, cfg: SegmentationConfig, impl="kernels"):
    """AOT-compiled `segment_turbo_impl` for this image shape with the
    given fixpoint implementation ("kernels" = the platform default).
    Returns (compiled, compile seconds)."""
    fn = jax.jit(lambda im: turbo.segment_turbo_impl(im, cfg, 2))
    t0 = time.perf_counter()
    if impl == "kernels":
        compiled = fn.lower(image).compile()
    else:
        with fixpoints(impl):
            compiled = fn.lower(image).compile()
    return compiled, time.perf_counter() - t0


def main(argv=None) -> int:
    from ..utils.jaxcache import (
        enable_parallel_gpu_compile,
        enable_persistent_cache,
    )
    from ..utils.labels import canonical_min_labels_np
    from ..utils.synthetic import blobs_image, textured_image
    from .harness import device_info

    p = argparse.ArgumentParser(prog="gseg.bench.fixpoints")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--sizes", default="1080x1920,2160x3840")
    args = p.parse_args(argv)
    enable_parallel_gpu_compile()
    dev = device_info(require_gpu=True)
    enable_persistent_cache()
    cfg = SegmentationConfig(sigma=0.8, k=300.0, min_size=100)
    for size in args.sizes.split(","):
        h, w = (int(x) for x in size.split("x"))
        shape = jax.ShapeDtypeStruct((h, w, 3), jnp.uint8)
        kern, ck = compile_turbo(shape, cfg, "kernels")
        xla, cx = compile_turbo(shape, cfg, None)
        for content in ("blobs", "textured"):
            img = jnp.asarray(
                blobs_image(h, w, 32, 8.0, 0) if content == "blobs"
                else textured_image(h, w, 0))
            outs = {}
            times = {"kernels": [], "xla": []}
            order = ["kernels", "xla", "xla", "kernels"] * (
                -(-args.reps // 2))
            for name in ["kernels", "xla"] + order:  # first pair: warm-up
                f = kern if name == "kernels" else xla
                t0 = time.perf_counter()
                out = jax.block_until_ready(f(img))
                dt = time.perf_counter() - t0
                if name not in outs:
                    outs[name] = out
                else:
                    times[name].append(dt)
            for name, (labels, flags) in outs.items():
                if int(flags) != 0:
                    raise RuntimeError(f"{name}: flags {int(flags)}")
            same = np.array_equal(
                canonical_min_labels_np(np.asarray(outs["kernels"][0])),
                canonical_min_labels_np(np.asarray(outs["xla"][0])))
            if not same:
                raise RuntimeError("kernel and sweep partitions differ")
            print(json.dumps({
                "bench": "fixpoints_ab", "shape": [h, w], "content": content,
                "compile_s": {"kernels": ck, "xla": cx},
                "ms": {k: [t * 1e3 for t in v] for k, v in times.items()},
                "median_ms": {k: float(np.median(v)) * 1e3
                              for k, v in times.items()},
                "partition_equal": same, **dev,
            }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
