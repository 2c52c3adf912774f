"""Compilation setup: the persistent XLA compilation cache and the GPU
compile flags.

The segmentation pipelines compile large programs (nested while_loops over
gossip sweeps: about two minutes for turbo at 1080p on an H100 with XLA's
defaults). Compiling a program's kernels on several threads cuts that about
threefold, and a persistent on-disk cache makes every later process start
fast for known shapes.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX already uses that directory
and nothing here changes it. Otherwise the cache lives at a fixed
`.jax_cache/` in the checkout (git-ignored): the path is part of what makes
an entry findable again. XLA:CPU entries are AOT machine code for the
host's exact CPU features, and loading entries built on another host has
crashed the compiler, so on the CPU the cache gets a subdirectory keyed by
a fingerprint of the host's CPU flags: a new host means a cold cache, never
a crash.
"""

from __future__ import annotations

import hashlib
import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


# Flags for the GPU compiler: LLVM compiles a program's kernels in
# parallel (XLA's default is one thread). They change compile time only.
GPU_COMPILE_FLAGS = (
    "--xla_gpu_enable_llvm_module_compilation_parallelism=true",
)


def enable_parallel_gpu_compile() -> None:
    """Add GPU_COMPILE_FLAGS to XLA_FLAGS (a flag already there is left
    as it is). XLA reads XLA_FLAGS when the backend starts, so call this
    before the first device operation of the process."""
    flags = os.environ.get("XLA_FLAGS", "").split()
    names = {f.split("=")[0] for f in flags}
    flags += [f for f in GPU_COMPILE_FLAGS if f.split("=")[0] not in names]
    os.environ["XLA_FLAGS"] = " ".join(flags)


def _host_fingerprint() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    return hashlib.sha1(flags.encode()).hexdigest()[:12]
    except OSError:
        pass
    import platform

    return hashlib.sha1(platform.processor().encode()).hexdigest()[:12]


def enable_persistent_cache() -> None:
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    path = DEFAULT_DIR
    if jax.default_backend() == "cpu":
        path = os.path.join(path, f"cpu-{_host_fingerprint()}")
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
