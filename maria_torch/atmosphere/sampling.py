"""Line-of-sight screen sampling (maria_tpu/atmosphere/sampling.py),
Fourier screens and Fourier 3-D screen groups.

A screen at height h is sampled at x = h*px + vx*t, y = h*py + vy*t,
rotated into its extrusion frame by ``angle``, with (px, py) the
unit-height east/north line-of-sight projections per (detector, coarse
time). Every screen, and every layer of a group, is sampled with the
plain bilinear gather at every coarse step.

The JAX package's default samplers for a group are TPU devices: a
boresight-tracked window contracted with one-hot hats, per-layer
temporal decimation (each layer sampled every d-th step and linearly
upsampled) and a static-hat GEMM (detector offsets frozen over the
observation). They exist because a TPU has no fast gather, and the last
two approximate the bilinear value. A card gathers fast, so the port
keeps the contract, the exact bilinear values, and not that workaround:
its values equal maria_tpu's exact path (``bs_px=None``) and, inside
the window, its undecimated windowed path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.interp import interp_bilinear_uniform
from .fourier import synthesize_layered_matern_2d, synthesize_matern_field_2d

__all__ = ["accumulate_pwv", "group_tensors"]


def group_tensors(group, device) -> dict:
    """A ScreenGroup's spectral operators as float32 tensors on ``device``."""
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "W": torch.as_tensor(np.asarray(group.W), **f32),
        "M_cos": torch.as_tensor(np.asarray(group.M_cos), **f32),
        "M_sin": torch.as_tensor(np.asarray(group.M_sin), **f32),
        "beam": None if group.beam is None else torch.as_tensor(np.asarray(group.beam), **f32),
    }


def _sample(values, h, angle, vx, vy, res_x, res_y, tx_min, ty_min, px, py, t_rel):
    x = h * px + vx * t_rel
    y = h * py + vy * t_rel
    ca, sa = float(np.cos(angle)), float(np.sin(angle))
    tx = ca * x + sa * y
    ty = -sa * x + ca * y
    return interp_bilinear_uniform(values, tx, ty, tx_min, res_x, ty_min, res_y)


def accumulate_pwv(mean_pwv, screens, px, py, t_rel, W=None, generator=None, draws=None,
                   groups=(), group_tables=None, group_draws=None):
    """Zenith-scaled pwv (n_det, n_t) in mm: the mean plus the sum of the
    per-screen and per-layer turbulence samples.

    ``W`` holds each screen's spectral weights and ``group_tables`` each
    group's ``group_tensors`` on px's device (default: built from the
    host arrays). ``draws`` optionally supplies each screen's white
    normals, (ny, nx//2+1, 2), and ``group_draws`` each group's,
    (2J, ny, nx//2+1, 2); otherwise they come from ``generator``,
    screens first, then groups.
    """
    pwv = torch.full(px.shape, float(np.float32(mean_pwv)), dtype=px.dtype, device=px.device)
    for i, screen in enumerate(screens):
        w = W[i] if W is not None else torch.as_tensor(screen.W, device=px.device)
        values = synthesize_matern_field_2d(
            w, screen.ny, screen.nx, generator=generator,
            draw=None if draws is None else draws[i],
        )
        ty_res = screen.ty_res if screen.ty_res is not None else screen.res
        sample = _sample(values, screen.h, screen.angle, screen.vx, screen.vy, screen.res, ty_res,
                         screen.tx_min, screen.ty_min, px, py, t_rel)
        pwv = pwv + screen.pwv_rms * sample
    for g, group in enumerate(groups):
        tabs = group_tables[g] if group_tables is not None else group_tensors(group, px.device)
        stack = synthesize_layered_matern_2d(
            tabs["W"], tabs["M_cos"], tabs["M_sin"], tabs["beam"], group.ny, group.nx,
            generator=generator, draw=None if group_draws is None else group_draws[g],
        )
        for il, h in enumerate(group.heights):
            sample = _sample(stack[il], float(h), group.angle, group.vx, group.vy, group.res, group.res,
                             group.tx_min, group.ty_min, px, py, t_rel)
            pwv = pwv + float(group.pwv_rms[il]) * sample
    return pwv
