"""Progress bars, duration logging, a device profile
(maria_tpu/io/logging.py) and the program's spans and counters. tqdm is
optional: without it a progress bar is the bare iterable.

Spans and counters. ``span(name)`` marks a stage of the program and
``count(name, n)`` counts an event in it; both do nothing until tracing
is on (``set_tracing(True)``, the ``tracing()`` block, or ``profiler()``,
which turns it on for its block). Off, a span is one check of a module
flag that returns a shared null context: no clock, no allocation, no
synchronize. On, a span opens ``torch.profiler.record_function`` under
the name ``maria_torch.<name>``, so a profiler's trace holds the stage
on its own clock with the kernels launched inside it, and adds to
in-memory aggregates by name: calls, host seconds, and self seconds (the
span less what its child spans cover). Spans never synchronize: a
stage's device time is read from a profiler's trace, by the kernels
that its host calls launched. ``trace_summary()`` returns the aggregates
and the counters since ``reset_trace()``, the kernels' launch counters
(``<kernel>.launches``) among them. The aggregates are one table for the
process: the program opens its spans from one thread.

A name is ``<layer>.<stage>...`` in letters, digits and ``_``, the
layer one of ``SPAN_LAYERS``::

    with span("noise"):
        with span("noise.basis"):
            basis = band_noise_basis(offsets, noise_kwargs)
            count("noise.basis_builds")
"""

from __future__ import annotations

import contextlib
import importlib
import logging
import os
import threading
import time as _time

logger = logging.getLogger("maria_torch")

DEFAULT_BAR_FORMAT = "{l_bar}{bar:16}{r_bar}"


def progress_bar(iterable=None, desc: str = "", disable: bool = True, total: int = None):
    """A tqdm bar in the package's format, or the bare iterable (a null
    context without one) where tqdm is not installed."""
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable if iterable is not None else contextlib.nullcontext()
    return tqdm(iterable, desc=desc, disable=disable, total=total, bar_format=DEFAULT_BAR_FORMAT)


@contextlib.contextmanager
def log_duration(message: str, level: int = logging.DEBUG):
    """Log ``message`` with the block's wall time on exit."""
    start = _time.monotonic()
    yield
    logger.log(level, f"{message} in {_time.monotonic() - start:.2f} s")


@contextlib.contextmanager
def profiler(log_dir: str, host_trace: bool = False):
    """A torch.profiler trace of the enclosed block, CPU and (where there
    is one) CUDA activity, written to ``log_dir``/trace.json for
    chrome://tracing or Perfetto, with tracing on so that the program's
    stages are in it; ``host_trace`` also records the Python call stacks.

        with maria_torch.io.logging.profiler("prof"):
            sim.run()
    """
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    start = _time.monotonic()
    with torch.profiler.profile(activities=activities, with_stack=host_trace) as prof, tracing(True):
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info(f"device profile captured to {path} ({_time.monotonic() - start:.2f} s traced)")


# -- spans and counters -----------------------------------------------------------------------

SPAN_PREFIX = "maria_torch."
SPAN_LAYERS = ("program", "atmosphere", "noise", "sim", "tod", "mapper")
# the kernels whose launch counters (``<op>.launches``, counted on or off) the summary lists
KERNEL_COUNTERS = (("ar_extrude", "ar_extrude"), ("band_tables", "band_tables"), ("bin_map", "bin_map"),
                   ("los_sample", "los_sample"), ("pink_cascade", "pink_cascade"), ("pink_noise", "pink_noise"),
                   ("pixel_ids", "pixel_ids"), ("shared_v", "shared_v"), ("sht", "sht_synth"), ("sht", "sht_anal"))

_tracing = False
_NULL = contextlib.nullcontext()
_spans = {}  # maria_torch.<name> -> [calls, host seconds, self seconds]
_counters = {}
_launches0 = {}  # the kernels' launch counters at the last reset_trace()
_open = threading.local()  # each thread's stack of open spans


class _Span:
    __slots__ = ("name", "record", "start", "children")

    def __init__(self, name: str):
        self.name = SPAN_PREFIX + name

    def __enter__(self):
        import torch

        stack = _open.__dict__.setdefault("stack", [])
        self.record = torch.profiler.record_function(self.name)
        self.record.__enter__()
        self.children = 0.0
        stack.append(self)
        self.start = _time.perf_counter()
        return self

    def __exit__(self, *exc):
        elapsed = _time.perf_counter() - self.start
        stack = _open.stack
        stack.pop()
        if stack:
            stack[-1].children += elapsed
        agg = _spans.get(self.name)
        if agg is None:
            agg = _spans[self.name] = [0, 0.0, 0.0]
        agg[0] += 1
        agg[1] += elapsed
        agg[2] += elapsed - self.children
        self.record.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one stage of the program (module
    docstring): with tracing off the shared null context."""
    if not _tracing:
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if _tracing:
        _counters[name] = _counters.get(name, 0) + n


def set_tracing(on: bool) -> bool:
    """Turn the program's spans and counters on or off; returns whether
    they were on."""
    global _tracing
    was, _tracing = _tracing, bool(on)
    return was


@contextlib.contextmanager
def tracing(on: bool = True):
    """The enclosed block with tracing ``on`` (or off); after it, tracing
    is as it was before."""
    was = set_tracing(on)
    try:
        yield
    finally:
        set_tracing(was)


def _kernel_launches() -> dict:
    out = {}
    for module, op in KERNEL_COUNTERS:
        fn = getattr(importlib.import_module(f"maria_torch.ops.{module}"), op)
        out[f"{op}.launches"] = fn.launches
    return out


def trace_summary() -> dict:
    """{"spans": {maria_torch.<name>: {"calls", "host_s", "self_s"}},
    "counters": {name: n}} since the last ``reset_trace()``; the counters
    include each kernel's launches (``<kernel>.launches``), which count
    with tracing off too."""
    launches = {k: v - _launches0.get(k, 0) for k, v in _kernel_launches().items()}
    return {
        "spans": {name: {"calls": c, "host_s": h, "self_s": s} for name, (c, h, s) in _spans.items()},
        "counters": {**_counters, **launches},
    }


def reset_trace():
    """Clear the spans' aggregates and the counters."""
    _spans.clear()
    _counters.clear()
    _launches0.update(_kernel_launches())
