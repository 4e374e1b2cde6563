"""Line-of-sight screen sampling (maria_tpu/atmosphere/sampling.py),
Fourier screens only.

A screen at height h is sampled at x = h*px + vx*t, y = h*py + vy*t,
rotated into its extrusion frame by ``angle``, with (px, py) the
unit-height east/north line-of-sight projections per (detector, coarse
time). The TPU's windowed one-hot contraction exists because the TPU has
no fast gather; on the card the sampler is the plain bilinear gather,
which gives the same values inside the window.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.interp import interp_bilinear_uniform
from .fourier import synthesize_matern_field_2d

__all__ = ["accumulate_pwv"]


def accumulate_pwv(mean_pwv, screens, px, py, t_rel, W=None, generator=None, draws=None):
    """Zenith-scaled pwv (n_det, n_t) in mm: the mean plus the sum of the
    per-screen turbulence samples.

    ``W`` holds each screen's spectral weights as device tensors (default:
    the screens' host arrays, moved to px's device). ``draws`` optionally
    supplies each screen's white normals, shape (ny, nx//2+1, 2).
    """
    pwv = torch.full(px.shape, float(np.float32(mean_pwv)), dtype=px.dtype, device=px.device)
    for i, screen in enumerate(screens):
        w = W[i] if W is not None else torch.as_tensor(screen.W, device=px.device)
        values = synthesize_matern_field_2d(
            w, screen.ny, screen.nx, generator=generator,
            draw=None if draws is None else draws[i],
        )
        x = screen.h * px + screen.vx * t_rel
        y = screen.h * py + screen.vy * t_rel
        ca, sa = float(np.cos(screen.angle)), float(np.sin(screen.angle))
        tx = ca * x + sa * y
        ty = -sa * x + ca * y
        ty_res = screen.ty_res if screen.ty_res is not None else screen.res
        sample = interp_bilinear_uniform(values, tx, ty, screen.tx_min, screen.res, screen.ty_min, ty_res)
        pwv = pwv + screen.pwv_rms * sample
    return pwv
