"""Line-of-sight screen sampling (maria_tpu/atmosphere/sampling.py):
Fourier screens, Fourier 3-D screen groups and AR screens.

A screen at height h is sampled at x = h*px + vx*t, y = h*py + vy*t,
rotated into its extrusion frame by ``angle``, with (px, py) the
unit-height east/north line-of-sight projections per (detector, coarse
time). Every screen, and every layer of a group, is sampled with the
bilinear gather at every coarse step, all layers in one pass
(``ops/los_sample.py``: a kernel on the card, plain torch on the CPU).

The JAX package's default samplers for a group are TPU devices: a
boresight-tracked window contracted with one-hot hats, per-layer
temporal decimation (each layer sampled every d-th step and linearly
upsampled) and a static-hat GEMM (detector offsets frozen over the
observation). They exist because a TPU has no fast gather, and the last
two approximate the bilinear value. A card gathers fast, so the port
keeps the contract, the exact bilinear values, and not that workaround:
its values equal maria_tpu's exact path (``bs_px=None``) and, inside
the window, its undecimated windowed path.

An AR screen (``W`` None) takes its values from its process's extrusion
(``ar_values``), beam-blurred here by an FFT Gaussian on its grid of
``res`` by ``ty_res``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.logging import count, span
from ..ops.los_sample import Layer, los_sample
from .fourier import synthesize_layered_matern_2d, synthesize_matern_field_2d

__all__ = ["accumulate_pwv", "gaussian_blur_2d", "gaussian_blur_weights", "group_tensors", "synthesize_layers"]


def group_tensors(group, device) -> dict:
    """A ScreenGroup's spectral operators as float32 tensors on ``device``."""
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "W": torch.as_tensor(np.asarray(group.W), **f32),
        "M_cos": torch.as_tensor(np.asarray(group.M_cos), **f32),
        "M_sin": torch.as_tensor(np.asarray(group.M_sin), **f32),
        "beam": None if group.beam is None else torch.as_tensor(np.asarray(group.beam), **f32),
    }


def gaussian_blur_weights(ny: int, nx: int, sigma_y: float, sigma_x: float, res_y: float, res_x: float):
    """(ny, nx//2+1) float32 multiplier of the rfft2 spectrum that blurs a
    periodic (ny, nx) grid of spacings (res_y, res_x) by a Gaussian of
    widths (sigma_y, sigma_x)."""
    ky = 2 * np.pi * np.fft.fftfreq(ny, d=res_y)
    kx = 2 * np.pi * np.fft.rfftfreq(nx, d=res_x)
    return np.exp(-0.5 * (sigma_y**2 * ky[:, None] ** 2 + sigma_x**2 * kx[None, :] ** 2)).astype(np.float32)


def gaussian_blur_2d(values, sigma_y, sigma_x, res_y, res_x, weights=None):
    """Periodic FFT Gaussian blur of a (ny, nx) field (maria_tpu's
    AR-path beam smoothing). ``weights`` optionally gives
    ``gaussian_blur_weights`` as a tensor on the field's device."""
    ny, nx = values.shape
    if weights is None:
        weights = torch.as_tensor(gaussian_blur_weights(ny, nx, sigma_y, sigma_x, res_y, res_x), device=values.device)
    return torch.fft.irfft2(torch.fft.rfft2(values) * weights, s=(ny, nx))


def synthesize_layers(screens, device, W=None, generator=None, draws=None, groups=(), group_tables=None,
                      group_draws=None, ar_values=None, blur=None) -> list:
    """Every layer the sampler reads (``ops.los_sample.Layer``), in
    ``accumulate_pwv``'s order: each screen's grid, then each group's
    stack a height at a time; the draws as ``accumulate_pwv`` takes them.
    Each screen (a fine/coarse pair is two) is counted in
    ``atmosphere.screens``."""
    layers = []
    for i, screen in enumerate(screens):
        ty_res = screen.ty_res if screen.ty_res is not None else screen.res
        count("atmosphere.screens")
        with span("atmosphere.synthesize"):
            if screen.W is not None:
                w = W[i] if W is not None else torch.as_tensor(screen.W, device=device)
                values = synthesize_matern_field_2d(
                    w, screen.ny, screen.nx, generator=generator,
                    draw=None if draws is None else draws[i],
                )
            else:
                if ar_values is None or i not in ar_values:
                    raise ValueError("AR screen values missing; run the process first.")
                values = ar_values[i]
                if screen.beam_sigma > 0:
                    values = gaussian_blur_2d(values, screen.beam_sigma, screen.beam_sigma, ty_res, screen.res,
                                              weights=None if blur is None else blur[i])
        layers.append(Layer(values, screen.h, screen.angle, screen.vx, screen.vy, screen.res, ty_res,
                            screen.tx_min, screen.ty_min, screen.pwv_rms))
    for g, group in enumerate(groups):
        with span("atmosphere.synthesize"):
            tabs = group_tables[g] if group_tables is not None else group_tensors(group, device)
            stack = synthesize_layered_matern_2d(
                tabs["W"], tabs["M_cos"], tabs["M_sin"], tabs["beam"], group.ny, group.nx,
                generator=generator, draw=None if group_draws is None else group_draws[g],
            )
        layers.extend(
            Layer(stack[il], float(h), group.angle, group.vx, group.vy, group.res, group.res, group.tx_min,
                  group.ty_min, float(group.pwv_rms[il]))
            for il, h in enumerate(group.heights)
        )
    return layers


def accumulate_pwv(mean_pwv, screens, px, py, t_rel, W=None, generator=None, draws=None,
                   groups=(), group_tables=None, group_draws=None, ar_values=None, blur=None):
    """Zenith-scaled pwv (n_det, n_t) in mm: the mean plus the sum of the
    per-screen and per-layer turbulence samples.

    ``W`` holds each Fourier screen's spectral weights and
    ``group_tables`` each group's ``group_tensors`` on px's device
    (default: built from the host arrays). ``draws`` optionally supplies
    each Fourier screen's white normals, (ny, nx//2+1, 2), and
    ``group_draws`` each group's, (2J, ny, nx//2+1, 2); otherwise they
    come from ``generator``, screens first, then groups. An AR screen i
    reads its (ny, nx) values from ``ar_values[i]``; ``blur[i]``
    optionally holds its ``gaussian_blur_weights`` on px's device.
    Every layer is synthesized first, then all are sampled together by
    ``ops.los_sample`` (on a card, one kernel launch).
    """
    layers = synthesize_layers(screens, px.device, W=W, generator=generator, draws=draws, groups=groups,
                               group_tables=group_tables, group_draws=group_draws, ar_values=ar_values, blur=blur)
    if not layers:
        return torch.full(px.shape, float(np.float32(mean_pwv)), dtype=px.dtype, device=px.device)
    with span("atmosphere.sample"):
        pwv = los_sample(mean_pwv, layers, px, py, t_rel)
        count("atmosphere.layers_sampled", len(layers))
    return pwv
