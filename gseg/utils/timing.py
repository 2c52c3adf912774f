"""Phase timing + profiler hooks.

Rebuild of the reference's observability layer (SURVEY.md §5): the CUDA code
wraps pipeline phases in C++ high_resolution_clock timers and uses nvprof
offline. Here: a PhaseTimer fenced by `jax.block_until_ready`, and a
jax.profiler trace context.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict


class PhaseTimer:
    """Accumulates per-phase wall times with device fencing.

    with timer.phase("segmentation") as ph:  # fences ph["result"] at exit
        ph["result"] = run(...)
    """

    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        import jax

        t0 = time.perf_counter()
        holder = {}
        yield holder
        if "result" in holder:
            jax.block_until_ready(holder["result"])
        dt = time.perf_counter() - t0
        self.phases[name] = self.phases.get(name, 0.0) + dt

    def json(self) -> str:
        return json.dumps({k: round(v, 5) for k, v in self.phases.items()})


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """jax.profiler trace into `log_dir` (the nvprof analog)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
