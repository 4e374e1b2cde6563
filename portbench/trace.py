"""The traced window: ``torch.profiler`` over the card, and its summary.

``summarize`` reads the profiler's trace (the Chrome trace it exports,
written under the checkout's ``build/portbench`` and removed once read)
into:

- ``kernels``: (name, start_us, end_us) of every device activity
  (kernels, copies and fills) inside the window;
- ``busy_s``: the union of their intervals, overlaps counted once;
- ``window_s``: the window's length, from the ``portbench.window``
  annotation around the loop;
- ``device_ops``: the ten device operations that took most time, with
  their summed seconds;
- ``idle_gaps``: the idle time between device activities, summed by the
  innermost host operation running at each gap's middle, the ten
  largest.
"""

from __future__ import annotations

import bisect
import json
import os
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function", "cuda_runtime")
TRACE_FILE = Path(__file__).resolve().parents[1] / "build" / "portbench" / "trace.json"


def profiler(cuda: bool):
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities, record_shapes=False, with_stack=False)


def short_name(name: str, width: int = 160) -> str:
    """A device operation's name without the namespace and return-type
    noise of a C++ template instance, cut to ``width`` characters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "std::array<char*, 2ul>",
                  "std::array<char*, 3ul>"):
        name = name.replace(noise, "")
    return name[:width]


def union_length(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, w0: float, w1: float) -> list:
    """(start, end) of the stretches of [w0, w1] that no interval covers."""
    gaps, cursor = [], w0
    for s, e in sorted(intervals):
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < w1:
        gaps.append((cursor, w1))
    return gaps


def innermost(host, starts, t: float, reach: int = 4096):
    """The name of the latest-starting host event (``host`` sorted by
    start, ``starts`` their starts) that covers time t: the innermost of
    nested events. "host: none" where none within ``reach`` does."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        if host[j][2] >= t:
            return host[j][0]
    return "host: none"


def summarize_events(events: list, top: int = 10) -> dict:
    """The summary of Chrome-trace events (dicts with "name", "cat",
    "ts", "dur" in microseconds)."""
    window = [e for e in events if e.get("name") == "portbench.window" and e.get("cat") in HOST_CATEGORIES]
    if not window:
        raise ValueError("the trace holds no portbench.window annotation")
    w = max(window, key=lambda e: e["dur"])
    w0, w1 = w["ts"], w["ts"] + w["dur"]
    kernels = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") in DEVICE_CATEGORIES and "dur" in e and w0 <= e["ts"] <= w1]
    intervals = [(s, min(e, w1)) for _, s, e in kernels]
    by_op = {}
    for name, s, e in kernels:
        by_op[short_name(name)] = by_op.get(short_name(name), 0.0) + (e - s) * 1e-6
    host = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") in HOST_CATEGORIES and "dur" in e and e["ts"] <= w1 and e["ts"] + e["dur"] >= w0
            and e["name"] != "portbench.window"]
    host.sort(key=lambda h: h[1])
    starts = [h[1] for h in host]
    by_gap = {}
    for s, e in idle_gaps(intervals, w0, w1):
        name = innermost(host, starts, 0.5 * (s + e))
        by_gap[name] = by_gap.get(name, 0.0) + (e - s) * 1e-6
    return {
        "kernels": kernels,
        "busy_s": union_length(intervals) * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "device_ops": sorted(([k, v] for k, v in by_op.items()), key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(([k, v] for k, v in by_gap.items()), key=lambda kv: -kv[1])[:top],
    }


def summarize(prof, cuda: bool) -> dict:
    """The summary of a finished ``profiler``'s trace."""
    TRACE_FILE.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(TRACE_FILE))
    try:
        with open(TRACE_FILE) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(TRACE_FILE)
    return summarize_events(events)
