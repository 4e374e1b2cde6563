"""Detector noise (maria_tpu/noise/__init__.py): white plus a 1/f^beta
knee, with an optional spatially correlated part projected through a
low-rank focal-plane basis.

The spectrum is drawn directly in the frequency domain (the rfft of
white noise is complex white noise) on the fast length
``good_fft_size(n)`` and truncated to n; the inverse transform of every
row is kernel K1 (``ops.pink_noise``). ``noise.dft`` holds the
total-power route's form: the whole banded noise stage as one matrix
product, its draw from kernel K3 (``ops.shared_v``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..atmosphere.fourier import good_fft_size
from ..ops.pink_noise import pink_noise

__all__ = ["generate_noise_with_knee", "band_half_spectrum", "DEFAULT_NOISE_SIM_KWARGS"]

DEFAULT_NOISE_SIM_KWARGS = {
    "correlated_noise_proportion": 0.5,
    "correlated_noise_spatial_scale": 1.0,
}


def _pink_weights_np(n: int, sample_rate: float, knee: float, beta: float):
    f = np.fft.rfftfreq(n, d=1 / sample_rate)
    with np.errstate(divide="ignore"):
        ps = np.where(f != 0, (knee / 2) / np.abs(f) ** beta, 0.0)
    return np.sqrt(2 * sample_rate * ps)


def _spectral_white_scale_np(n_fft: int):
    """Per-bin amplitude of the spectral white draw: the rfft of N(0, 1)
    noise has Var(Re) = Var(Im) = n/2 inside, and real DC and Nyquist
    bins of variance n."""
    n_f = n_fft // 2 + 1
    scale = np.full(n_f, np.sqrt(n_fft / 2))
    scale[0] = np.sqrt(n_fft)
    if n_fft % 2 == 0:
        scale[-1] = np.sqrt(n_fft)
    return scale


def band_half_spectrum(sample_rate: float, knee: float, beta: float, n_fft: int,
                       corr_prop: float = 0.0, pink_only: bool = False) -> np.ndarray:
    """The (n_fft//2 + 1,) half-spectrum amplitude c(f) of the noise
    process, including the spectral white draw's scale."""
    w = _pink_weights_np(n_fft, sample_rate, knee, beta)
    base = w**2 if pink_only else sample_rate + (1.0 - corr_prop) * w**2
    return np.sqrt(base) * _spectral_white_scale_np(n_fft)


def _draw(shape, generator, device, given, what):
    if given is None:
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    if tuple(given.shape) != tuple(shape):
        raise ValueError(f"{what} draw must have shape {tuple(shape)}, got {tuple(given.shape)}")
    return given.to(device=device, dtype=torch.float32).contiguous()


def generate_noise_with_knee(shape: tuple, sample_rate: float = 1.0, knee: float = 0.0,
                             beta: float = 1.0, basis=None, corr_prop: float = 0.0,
                             generator=None, white=None, mode_white=None, device=None, rows=None):
    """Unit-NEP noise of shape (n_det, n_time).

    The white part has variance ``sample_rate`` per sample (times an NEP
    in W√s it has the right PSD); the pink part adds (knee/2)/f^beta to
    the one-sided PSD. A fraction ``corr_prop`` of the pink power is
    common to the detectors through the (n_det, k) ``basis``.

    ``white`` optionally supplies the detector draw, (n_det, n_fft//2+1, 2)
    unit normals, and ``mode_white`` the correlated modes' draw,
    (k, n_fft//2+1, 2); otherwise they come from ``generator``.

    Without a knee (``knee <= 0``) the noise is white alone,
    sqrt(sample_rate) N(0, 1), and has no correlated part, as in
    maria_tpu: ``white`` is then the (n_det, n) time-domain draw itself,
    and no kernel runs (maria_tpu draws it with ``jax.random.normal``).

    ``rows`` (a slice of the detector axis) returns only those rows, equal
    to the same rows of the call without it: ``shape``, ``basis`` and any
    handed-in draws stay whole, and every draw is made at its whole shape
    in the order above before the rows are kept. The one-process call is
    ``rows=None``, the whole axis.
    """
    n_det, n = shape
    rows = slice(None) if rows is None else rows
    device = white.device if device is None and white is not None else device
    if knee <= 0:
        return float(np.sqrt(sample_rate)) * _draw((n_det, n), generator, device, white, "white")[rows]

    n_fft = good_fft_size(n)
    n_f = n_fft // 2 + 1
    w = _pink_weights_np(n_fft, sample_rate, knee, beta)
    cp = corr_prop if basis is not None else 0.0
    c = np.sqrt(sample_rate + (1.0 - cp) * w**2) * _spectral_white_scale_np(n_fft)
    noise = pink_noise(c, _draw((n_det, n_f, 2), generator, device, white, "white")[rows], n, n_fft)
    if cp > 0:
        basis = torch.as_tensor(basis, dtype=torch.float32, device=noise.device)[rows]
        k = basis.shape[-1]
        c_modes = w * _spectral_white_scale_np(n_fft)
        mode_noise = pink_noise(c_modes, _draw((k, n_f, 2), generator, noise.device, mode_white, "mode"), n, n_fft)
        noise = noise + (float(np.sqrt(corr_prop)) * basis) @ mode_noise
    return noise
