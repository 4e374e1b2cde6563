"""The noise product's share of its roofline (``kernels/noise_gemm.py``)."""

from ..roofline import share_pct


def read(ctx: dict):
    return share_pct(ctx, "noise_gemm")
