"""Interpolation on regular grids in torch (maria_tpu/ops/interp.py).

The TPU versions avoid gathers (windowed one-hot contractions, the
clamped-ramp table identity); on the card a gather is cheap, so these
are the plain gather forms, which give the same values.
"""

from __future__ import annotations

import numpy as np
import torch

from ..band import axis_transform, fractional_index

__all__ = [
    "interp_bilinear_uniform",
    "TableEval",
    "upsample_time_phases",
    "upsample_time",
]


def interp_bilinear_uniform(values, x, y, x0, dx, y0, dy, fill_value=0.0):
    """Bilinear sample of a (ny, nx) field on a uniform grid at points
    (x, y); points outside the grid get ``fill_value``."""
    ny, nx = values.shape
    fx = (x - x0) / dx
    fy = (y - y0) / dy
    inside = (fx >= 0) & (fx <= nx - 1) & (fy >= 0) & (fy <= ny - 1)
    ix = torch.clamp(torch.floor(fx).to(torch.int64), 0, nx - 2)
    iy = torch.clamp(torch.floor(fy).to(torch.int64), 0, ny - 2)
    wx, wy = fx - ix, fy - iy
    flat = values.reshape(-1)
    base = iy * nx + ix
    v00 = flat[base]
    v01 = flat[base + 1]
    v10 = flat[base + nx]
    v11 = flat[base + nx + 1]
    out = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx + v10 * wy * (1 - wx) + v11 * wy * wx
    return torch.where(inside, out, torch.full_like(out, fill_value))


class TableEval:
    """(x, y) -> bilinear interpolation of a small 2-D table (x-major),
    clipped to the table's domain; uniform and log-uniform axes index
    arithmetically, as in maria_tpu's ``make_table_eval``."""

    def __init__(self, x_side, y_side, table, device=None):
        self.x_side = np.asarray(x_side, dtype=np.float64)
        self.y_side = np.asarray(y_side, dtype=np.float64)
        self.tx = axis_transform(self.x_side)
        self.ty = axis_transform(self.y_side)
        self.table = torch.tensor(np.asarray(table, dtype=np.float32), device=device)

    def __call__(self, x, y):
        nx, ny = self.table.shape
        u = torch.clamp(fractional_index(self.tx, x, torch), 0.0, nx - 1.0)
        v = torch.clamp(fractional_index(self.ty, y, torch), 0.0, ny - 1.0)
        i = torch.clamp(torch.floor(u).to(torch.int64), 0, nx - 2)
        j = torch.clamp(torch.floor(v).to(torch.int64), 0, ny - 2)
        wu, wv = u - i, v - j
        flat = self.table.reshape(-1)
        base = i * ny + j
        return (
            flat[base] * (1 - wu) * (1 - wv)
            + flat[base + 1] * (1 - wu) * wv
            + flat[base + ny] * wu * (1 - wv)
            + flat[base + ny + 1] * wu * wv
        )


def _phase_stencil_matrix(ratio: int, kind: str) -> np.ndarray:
    s = np.arange(ratio, dtype=np.float64) / ratio
    if kind == "linear":
        return np.stack([1 - s, s])
    return 0.5 * np.stack(
        [
            -s + 2 * s**2 - s**3,
            2 - 5 * s**2 + 3 * s**3,
            s + 4 * s**2 - 3 * s**3,
            -(s**2) + s**3,
        ]
    )


def upsample_time_phases(values, ratio: int, n_fine: int, kind: str = "cubic"):
    """Upsample (..., n_coarse) to n_fine samples for an integer
    coarse/fine ratio: fine sample c*ratio + r interpolates the coarse
    samples around c with weights that depend only on the phase r
    (Catmull-Rom, edge cells clamped; or linear)."""
    n_c = values.shape[-1]
    if kind == "linear" or n_c < 4:
        taps = [values[..., :-1], values[..., 1:]]
        C = _phase_stencil_matrix(ratio, "linear")
    else:
        pad = torch.cat([values[..., :1], values, values[..., -1:]], dim=-1)
        taps = [pad[..., :-3], pad[..., 1:-2], pad[..., 2:-1], pad[..., 3:]]
        C = _phase_stencil_matrix(ratio, "cubic")
    Ct = torch.as_tensor(C, dtype=values.dtype, device=values.device)  # (taps, ratio)
    out = sum(taps[k][..., None] * Ct[k] for k in range(len(taps)))  # (..., n_c-1, ratio)
    out = out.reshape(*values.shape[:-1], (n_c - 1) * ratio)
    deficit = n_fine - out.shape[-1]
    if deficit > 0:
        out = torch.cat([out, values[..., -1:].expand(*values.shape[:-1], deficit)], dim=-1)
    return out[..., :n_fine]


def upsample_time(values, t_coarse, t_fine, kind: str = "cubic"):
    """Upsample (..., n_coarse) from a uniform coarse time grid to
    arbitrary fine times (linear or Catmull-Rom), clamped at the ends."""
    n = values.shape[-1]
    t0 = float(t_coarse[0])
    dt = (float(t_coarse[-1]) - t0) / max(n - 1, 1)
    f = (torch.as_tensor(np.asarray(t_fine), dtype=values.dtype, device=values.device) - t0) / dt
    if kind == "linear" or n < 4:
        i = torch.clamp(torch.floor(f).to(torch.int64), 0, n - 2)
        w = torch.clamp(f - i, 0.0, 1.0)
        return values[..., i] * (1 - w) + values[..., i + 1] * w
    i = torch.clamp(torch.floor(f).to(torch.int64), 1, n - 3)
    s = torch.clamp(f - i, 0.0, 1.0)
    p0, p1, p2, p3 = values[..., i - 1], values[..., i], values[..., i + 1], values[..., i + 2]
    return 0.5 * (
        2 * p1
        + (-p0 + p2) * s
        + (2 * p0 - 5 * p1 + 4 * p2 - p3) * s**2
        + (-p0 + 3 * p1 - 3 * p2 + p3) * s**3
    )
