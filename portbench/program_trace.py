"""The program's own spans in a traced window, and what they read.

With the program's tracing on (``maria_torch.io.logging.set_tracing``),
each stage of a realization is a ``maria_torch.<layer>.<stage>``
annotation in the profiler's trace. ``join`` reads the raw Chrome-trace
events of the window (those ``trace.summarize_events`` reads) and puts
every device activity (kernel, copy, fill) under the annotations open on
the host thread that launched it: the activity and the CUDA runtime or
CUDA driver API call that launched it carry one ``correlation`` id, and
the call's start falls inside the annotations on its thread. The launch
is read from both ``cuda_runtime`` and ``cuda_driver`` calls: the hand
kernels go out through ctypes to the CUDA driver API.

The functions below read a per-layer number from a context ``ctx`` as
the harness hands its readers one, with ``ctx["trace"]["program"]`` the
join and ``ctx["program"]`` the program's ``trace_summary()``; each
returns None where the trace holds nothing of its own (the program
without spans, a cell without the stage, a run on the CPU).
"""

from __future__ import annotations

import bisect

from .trace import DEVICE_CATEGORIES, idle_gaps, union_length

LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
PREFIXES = ("maria_torch.", "portbench.")  # the annotations the join keeps
HARNESS_SPANS = ("portbench.synthesis", "portbench.map")
# host calls that wait for the card: the synchronizes and the synchronous copy
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")


def _correlation(e: dict):
    return (e.get("args") or {}).get("correlation")


def _open_at(spans: list, points: list) -> list:
    """For each (t, index) of ``points`` on one thread, (index, the
    indexes in ``spans`` of those open at t, outermost first); ``spans``
    (index, start, end) nest on a thread."""
    marks = [(s, 0, i, e) for i, s, e in spans] + [(t, 1, i, None) for t, i in points]
    marks.sort(key=lambda m: (m[0], m[1]))
    stack, out = [], []
    for t, kind, i, end in marks:
        while stack and stack[-1][1] < t:
            stack.pop()
        if kind == 0:
            stack.append((i, end))
        else:
            out.append((i, tuple(j for j, _ in stack)))
    return out


def join(events: list) -> dict:
    """{"spans": [(name, start_us, end_us)] of the window's annotations
    named ``PREFIXES``; "activities": [(start_us, end_us, open)] of every
    device activity in the window, ``open`` the indexes of the spans open
    at its launch ("()" where no launch is found); "syncs": [(name,
    start_us, open)] of the host calls that wait for the card}."""
    window = [e for e in events if e.get("name") == "portbench.window" and "dur" in e]
    if not window:
        raise ValueError("the trace holds no portbench.window annotation")
    w = max(window, key=lambda e: e["dur"])
    w0, w1 = w["ts"], w["ts"] + w["dur"]
    spans, by_thread = [], {}
    for e in events:
        name = e.get("name", "")
        if (e.get("cat") == "user_annotation" and "dur" in e and name.startswith(PREFIXES)
                and name != "portbench.window" and e["ts"] <= w1 and e["ts"] + e["dur"] >= w0):
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append((len(spans), e["ts"], e["ts"] + e["dur"]))
            spans.append((name, e["ts"], e["ts"] + e["dur"]))
    calls, launch_of = [], {}
    for e in events:
        if e.get("cat") in LAUNCH_CATEGORIES and "dur" in e:
            if _correlation(e) is not None:
                launch_of[_correlation(e)] = len(calls)
            calls.append(e)
    points = {}
    for i, e in enumerate(calls):
        points.setdefault((e.get("pid"), e.get("tid")), []).append((e["ts"], i))
    open_of = {}
    for thread, pts in points.items():
        open_of.update(_open_at(by_thread.get(thread, []), pts))
    activities = []
    for e in events:
        if e.get("cat") in DEVICE_CATEGORIES and "dur" in e and w0 <= e["ts"] <= w1:
            call = launch_of.get(_correlation(e))
            activities.append((e["ts"], min(e["ts"] + e["dur"], w1), open_of.get(call, ())))
    syncs = [(e["name"], e["ts"], open_of[i]) for i, e in enumerate(calls)
             if e["name"] in SYNC_CALLS and w0 <= e["ts"] <= w1]
    return {"spans": spans, "activities": activities, "syncs": syncs}


def _joined(ctx: dict):
    if not ctx.get("cuda"):
        return None
    joined = ctx.get("trace", {}).get("program")
    if not joined or not any(name.startswith("maria_torch.") for name, _, _ in joined["spans"]):
        return None
    return joined


def device_ms_under(ctx: dict, name: str):
    """Device milliseconds a realization (the union of intervals) of the
    activities launched inside span ``name``, or None where no such span
    launched any."""
    joined = _joined(ctx)
    if joined is None or not ctx["realizations"]:
        return None
    spans = joined["spans"]
    hit = [(s, e) for s, e, opened in joined["activities"] if any(spans[j][0] == name for j in opened)]
    return 1e-3 * union_length(hit) / ctx["realizations"] if hit else None


def layer_sample_device_ms(ctx: dict):
    return device_ms_under(ctx, "maria_torch.atmosphere.sample")


def noise_device_ms(ctx: dict):
    return device_ms_under(ctx, "maria_torch.noise")


def noise_basis_ms(ctx: dict):
    """Host milliseconds a realization inside ``noise.basis``, from the
    program's aggregates."""
    summary = ctx.get("program")
    if not summary or not ctx["realizations"]:
        return None
    agg = summary["spans"].get("maria_torch.noise.basis")
    return 1e3 * agg["host_s"] / ctx["realizations"] if agg else None


def cg_step_ms(ctx: dict):
    """The mean over the window's ``mapper.cg_step`` spans of the device
    extent of what each launched: its first activity's start to its last
    one's end."""
    joined = _joined(ctx)
    if joined is None:
        return None
    steps = {j for j, (name, _, _) in enumerate(joined["spans"]) if name == "maria_torch.mapper.cg_step"}
    extent = {}
    for s, e, opened in joined["activities"]:
        for j in opened:
            if j in steps:
                lo, hi = extent.get(j, (s, e))
                extent[j] = (min(lo, s), max(hi, e))
    return 1e-3 * sum(hi - lo for lo, hi in extent.values()) / len(extent) if extent else None


def program_syncs_per_realization(ctx: dict):
    """Host calls that wait for the card made inside a ``maria_torch.``
    span, a realization; the harness's own fall outside."""
    joined = _joined(ctx)
    if joined is None or not ctx["realizations"]:
        return None
    spans = joined["spans"]
    inside = [1 for _, _, opened in joined["syncs"] if any(spans[j][0].startswith("maria_torch.") for j in opened)]
    return len(inside) / ctx["realizations"]


def coverage(joined: dict) -> dict:
    """The shares of the harness's spans (``HARNESS_SPANS``) that the
    program's spans account for: "device", of the device time launched
    inside a harness span, what was launched inside a ``maria_torch.``
    span too; "idle", of the card's idle time inside a harness span, what
    falls inside a ``maria_torch.`` span (on any thread)."""
    spans = joined["spans"]
    harness = [(s, e) for name, s, e in spans if name in HARNESS_SPANS]
    program = [(s, e) for name, s, e in spans if name.startswith("maria_torch.")]
    launched = [(s, e, opened) for s, e, opened in joined["activities"]
                if any(spans[j][0] in HARNESS_SPANS for j in opened)]
    covered = [(s, e) for s, e, opened in launched if any(spans[j][0].startswith("maria_torch.") for j in opened)]
    all_device = union_length([(s, e) for s, e, _ in launched])
    if not harness:
        return {"device": None, "idle": None}
    w0, w1 = min(s for s, _ in harness), max(e for _, e in harness)
    gaps = idle_gaps([(s, e) for s, e, _ in joined["activities"]], w0, w1)
    idle_in_harness = _intersect(gaps, _merge(harness))
    idle_in_program = _intersect(idle_in_harness, _merge(program))
    idle = union_length(idle_in_harness)
    return {"device": union_length(covered) / all_device if all_device else None,
            "idle": union_length(idle_in_program) / idle if idle else None}


def _merge(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _intersect(a, b) -> list:
    """The intersection of two lists of sorted disjoint intervals."""
    out, starts = [], [s for s, _ in b]
    for s, e in a:
        k = max(bisect.bisect_right(starts, s) - 1, 0)
        while k < len(b) and b[k][0] < e:
            lo, hi = max(s, b[k][0]), min(e, b[k][1])
            if hi > lo:
                out.append((lo, hi))
            k += 1
    return out
