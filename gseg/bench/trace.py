"""Device time by named scope, from a `jax.profiler` trace.

models/turbo.py wraps its stages in `jax.named_scope` ("stage_g",
"extract", "stage2", "final_map"); XLA carries the scope into each
operation's name metadata, and the profiler into the device events'
stats. `device_time` sums the durations of the events on the GPU planes
of one trace by the first scope whose name appears in the event's name or
stats, and separately by event name.
"""

from __future__ import annotations

import glob
import os
from collections import Counter


def _xplane(log_dir: str) -> str:
    paths = sorted(glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                             recursive=True))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    return paths[-1]


def device_time(log_dir: str, scopes=("stage_g", "extract", "stage2",
                                      "final_map"), top: int = 15) -> dict:
    """Returns {"busy_ns", "window_ns", "by_scope": {scope: ns},
    "top_ops": [(name, ns)], "sort_ns", "lines"} over the GPU planes.
    Only the per-stream kernel lines are summed when the plane has them
    (other lines repeat the same kernels as XLA ops or modules); "lines"
    lists every line with its event count and time."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(_xplane(log_dir))
    by_scope, by_name = Counter(), Counter()
    spans, lines = [], {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        plane_lines = list(plane.lines)
        for line in plane_lines:
            evs = list(line.events)
            lines[f"{plane.name}|{line.name}"] = (
                len(evs), sum(int(e.duration_ns) for e in evs))
        streams = [ln for ln in plane_lines if ln.name.startswith("Stream")]
        for line in streams or plane_lines:
            for ev in line.events:
                dur = int(ev.duration_ns)
                text = ev.name + " " + " ".join(
                    str(v) for _, v in ev.stats)
                by_name[ev.name] += dur
                scope = next((s for s in scopes if f"{s}/" in text),
                             "other")
                by_scope[scope] += dur
                spans.append((int(ev.start_ns), int(ev.start_ns) + dur))
    busy, end = 0, None
    for a, b in sorted(spans):  # union of intervals, all GPU lines
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = (max(b for _, b in spans) - min(a for a, _ in spans)
              if spans else 0)
    return {
        "busy_ns": busy,
        "window_ns": window,
        "by_scope": dict(by_scope),
        "top_ops": by_name.most_common(top),
        "sort_ns": sum(v for k, v in by_name.items() if "sort" in k.lower()),
        "lines": lines,
    }
