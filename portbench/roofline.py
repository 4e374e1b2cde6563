"""A work item's share of its roofline in a traced window: the least
time the card could take for the item's calls (``kernels/<item>.py``:
operations over the peak rate or bytes over the bandwidth, whichever is
larger), over the device time of the kernels attributed to it."""

from __future__ import annotations

import importlib


def share_pct(ctx: dict, item: str, calls_counter: str = None):
    """The item's roofline share in percent, or None where the trace shows
    none of its kernels or the cell does no such work."""
    shape = ctx["work"].get(item)
    if shape is None or not ctx["cuda"]:
        return None
    cost = importlib.import_module(f"portbench.kernels.{item}")
    device_s = sum(e - s for name, s, e in ctx["trace"]["kernels"] if cost.matches(name)) * 1e-6
    if device_s <= 0:
        return None
    calls = ctx["counters"][calls_counter] if calls_counter else shape["calls"] * ctx["realizations"]
    return 100.0 * calls * cost.least_seconds(shape) / device_s
