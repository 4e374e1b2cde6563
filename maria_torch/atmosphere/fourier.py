"""FFT synthesis of Matérn turbulence screens (maria_tpu/atmosphere/fourier.py).

Host numpy builds the spectral weights W(k); the device draws the
half-spectrum of 2-D white noise directly in k-space and runs one
``torch.fft.irfft2``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import matern_spectral_density

__all__ = [
    "good_fft_size",
    "white_rfft2_spectrum",
    "synthesize_matern_field_2d",
    "field_spectral_weights_2d",
    "band_split_spectral_weights_2d",
]


def good_fft_size(n: int) -> int:
    """Smallest m * 2^k >= n with odd part m in {1, 3, 5, 9}. It fixes
    the noise process's FFT length, so the port keeps it as it is."""
    n = max(int(n), 16)
    best = 1 << (n - 1).bit_length()
    for m in (3, 5, 9):
        size = m << max(0, (-(-n // m) - 1).bit_length()) if n > m else m
        while size < n:
            size *= 2
        best = min(best, size)
    return best


def _rfft2_double_weights(S):
    weights_full = np.ones_like(S)
    weights_full[:, 1:] = 2.0
    if (2 * (S.shape[1] - 1)) % 2 == 0:
        weights_full[:, -1] = 1.0
    return weights_full


def field_spectral_weights_2d(ny, nx, dy, dx, nu, r0, beam_sigma=0.0):
    """W(k) with irfft2(rfft2(white) * W) a unit-variance Matérn(nu, r0)
    field, beam-smoothed by a Gaussian of width ``beam_sigma``; DC zeroed."""
    ky = 2 * np.pi * np.fft.fftfreq(ny, d=dy)
    kx = 2 * np.pi * np.fft.rfftfreq(nx, d=dx)
    k = np.sqrt(ky[:, None] ** 2 + kx[None, :] ** 2)
    S = matern_spectral_density(k, nu=nu, r0=r0, d=2)
    S[0, 0] = 0.0
    norm = np.sqrt(ny * nx / np.sum(_rfft2_double_weights(S) * S))
    W = np.sqrt(S) * norm
    if beam_sigma > 0:
        W = W * np.exp(-0.5 * beam_sigma**2 * k**2)
    return W.astype(np.float32)


def band_split_spectral_weights_2d(ny_f, nx_f, res_f, ny_c, nx_c, res_c, k_c, nu, r0,
                                   beam_sigma=0.0, order=8):
    """(W_fine, W_coarse) of a screen pair that jointly carries the
    Matérn spectrum, split at k_c by an order-``order`` power partition."""

    def grid_k(ny, nx, d):
        ky = 2 * np.pi * np.fft.fftfreq(ny, d=d)
        kx = 2 * np.pi * np.fft.rfftfreq(nx, d=d)
        return np.sqrt(ky[:, None] ** 2 + kx[None, :] ** 2)

    def taper(k):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(k > 0, 1.0 / (1.0 + (k_c / np.maximum(k, 1e-30)) ** order), 0.0)

    k_f = grid_k(ny_f, nx_f, res_f)
    k_cg = grid_k(ny_c, nx_c, res_c)
    S_f = matern_spectral_density(k_f, nu=nu, r0=r0, d=2) * taper(k_f)
    S_c = matern_spectral_density(k_cg, nu=nu, r0=r0, d=2) * (1.0 - taper(k_cg))
    S_f[0, 0] = 0.0
    S_c[0, 0] = 0.0
    var = (np.sum(_rfft2_double_weights(S_f) * S_f) / (ny_f * nx_f)
           + np.sum(_rfft2_double_weights(S_c) * S_c) / (ny_c * nx_c))
    amp = 1.0 / np.sqrt(var)
    W_f = amp * np.sqrt(S_f)
    W_c = amp * np.sqrt(S_c)
    if beam_sigma > 0:
        W_f = W_f * np.exp(-0.5 * beam_sigma**2 * k_f**2)
        W_c = W_c * np.exp(-0.5 * beam_sigma**2 * k_cg**2)
    return W_f.astype(np.float32), W_c.astype(np.float32)


def white_rfft2_spectrum(ny: int, nx: int, generator=None, draw=None, device=None):
    """Complex (ny, nx//2+1) spectrum distributed exactly as
    rfft2(normal(ny, nx)), drawn in k-space.

    ``draw`` optionally supplies the unit normals, shape
    (ny, nx//2+1, 2) [re, im]; otherwise they come from ``generator``.
    The self-conjugate columns kx=0 and kx=nx/2 are symmetrized along ky.
    """
    if nx % 2:
        raise ValueError("white_rfft2_spectrum requires even nx")
    nxr = nx // 2 + 1
    if draw is None:
        draw = torch.randn((ny, nxr, 2), generator=generator, device=device, dtype=torch.float32)
    elif tuple(draw.shape) != (ny, nxr, 2):
        raise ValueError(f"screen draw must have shape {(ny, nxr, 2)}, got {tuple(draw.shape)}")
    else:
        draw = draw.to(device=device, dtype=torch.float32)
    g = float(np.sqrt(np.float32(ny * nx) / np.float32(2.0))) * draw
    z = torch.complex(g[..., 0], g[..., 1])
    cols = z[:, [0, nxr - 1]]
    rev = torch.roll(torch.flip(cols, dims=(0,)), 1, dims=0)  # ky -> (-ky) mod ny
    sym = (cols + torch.conj(rev)) * float(1 / np.sqrt(2))
    z = z.clone()
    z[:, 0] = sym[:, 0]
    z[:, nxr - 1] = sym[:, 1]
    return z


def synthesize_matern_field_2d(W, ny: int, nx: int, generator=None, draw=None):
    """The (ny, nx) real screen with spectral weights W (a device tensor)."""
    spec = white_rfft2_spectrum(ny, nx, generator=generator, draw=draw, device=W.device)
    return torch.fft.irfft2(spec * W, s=(ny, nx))
