"""Progress bars, duration logging and a device profile
(maria_tpu/io/logging.py). tqdm is optional: without it a progress bar
is the bare iterable."""

from __future__ import annotations

import contextlib
import logging
import os
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
    chrome://tracing or Perfetto; ``host_trace`` also records the Python
    call stacks.

        with maria_torch.io.logging.profiler("prof"):
            sim.run()
    """
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    start = _time.monotonic()
    with torch.profiler.profile(activities=activities, with_stack=host_trace) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info(f"device profile captured to {path} ({_time.monotonic() - start:.2f} s traced)")
