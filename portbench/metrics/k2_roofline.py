"""K2's share of its roofline (``kernels/k2.py``), over K2's launches
in the window as the program counts them."""

from ..roofline import share_pct


def read(ctx: dict):
    return share_pct(ctx, "k2", calls_counter="bin_map")
