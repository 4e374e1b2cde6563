"""FFT synthesis of Matérn turbulence screens (maria_tpu/atmosphere/fourier.py).

Host numpy builds the spectral weights W(k); the device draws the
half-spectrum of 2-D white noise directly in k-space and runs one
``torch.fft.irfft2``. The layered (3-D) synthesis mixes 2J such draws
into L vertically correlated layer screens with one real matrix product
in k-space.
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
    "layered_matern_kz_nodes",
    "layered_field_spectral_weights",
    "synthesize_layered_matern_2d",
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


def layered_matern_kz_nodes(nu: float, r0: float, dz_max: float, dz_min: float, J1: int = 64, J2: int = 32):
    """Vertical-wavenumber quadrature of a 3-D Matérn field sliced into
    layers: J1 midpoint-uniform nodes (spacing pi/dz_max) plus J2
    geometric tail nodes up to pi/dz_min, weighted by the 1-D restriction
    spectrum (2 nu / r0^2 + kz^2)^-(nu + 1/2) and normalized to sum 1."""
    s2 = 2 * nu / r0**2
    dkz = np.pi / dz_max
    kz1 = (np.arange(J1) + 0.5) * dkz
    w1 = (s2 + kz1**2) ** -(nu + 0.5) * dkz
    kz_hi = max(np.pi / dz_min, 4 * J1 * dkz)
    edges = np.geomspace(J1 * dkz, kz_hi, J2 + 1)
    kz2 = np.sqrt(edges[:-1] * edges[1:])
    w2 = (s2 + kz2**2) ** -(nu + 0.5) * np.diff(edges)
    kz = np.concatenate([kz1, kz2])
    w = np.concatenate([w1, w2])
    return kz, w / w.sum()


def layered_field_spectral_weights(ny: int, nx: int, dy: float, dx: float, heights, nu: float, r0: float,
                                   beam_sigmas=None, J1: int = 64, J2: int = 32):
    """Host operators of L vertically correlated layer screens, slices at
    ``heights`` of one isotropic 3-D Matérn(nu, r0) field.

    Returns (W, M_cos, M_sin, beam): W (J, ny, nx//2+1) per-node 2-D
    spectral amplitudes, each node's grid variance normalized to its
    quadrature weight with the horizontal DC bin zeroed; M_cos, M_sin
    (L, J) the layer mixing matrices cos/sin(kz_j h_l); beam
    (L, ny, nx//2+1) per-layer Gaussian beam factors, or None."""
    heights = np.asarray(heights, dtype=np.float64)
    span = max(float(heights.max() - heights.min()), 1.0)
    dz_min = max(5.0, 0.5 * np.diff(np.sort(heights)).min()) if len(heights) > 1 else 5.0
    kz, w_node = layered_matern_kz_nodes(nu, r0, dz_max=2.5 * span + 1e3, dz_min=dz_min, J1=J1, J2=J2)

    ky = 2 * np.pi * np.fft.fftfreq(ny, d=dy)
    kx = 2 * np.pi * np.fft.rfftfreq(nx, d=dx)
    k2 = ky[:, None] ** 2 + kx[None, :] ** 2
    S3 = matern_spectral_density(np.sqrt(k2[None] + kz[:, None, None] ** 2), nu=nu, r0=r0, d=3)
    S3[:, 0, 0] = 0.0
    rfft_w = np.ones((ny, kx.size))
    rfft_w[:, 1:] = 2.0
    if nx % 2 == 0:
        rfft_w[:, -1] = 1.0
    node_var = np.sum(S3 * rfft_w[None], axis=(1, 2)) / (ny * nx)
    W = np.sqrt(S3 * (w_node / node_var)[:, None, None]).astype(np.float32)

    M_cos = np.cos(kz[None, :] * heights[:, None]).astype(np.float32)
    M_sin = np.sin(kz[None, :] * heights[:, None]).astype(np.float32)

    beam = None
    if beam_sigmas is not None:
        sig = np.asarray(beam_sigmas, dtype=np.float64)
        beam = np.exp(-0.5 * sig[:, None, None] ** 2 * k2[None]).astype(np.float32)
    return W, M_cos, M_sin, beam


def white_rfft2_spectrum(ny: int, nx: int, generator=None, draw=None, device=None, batch: tuple = ()):
    """Complex (*batch, ny, nx//2+1) spectrum distributed exactly as
    rfft2(normal(*batch, ny, nx)), drawn in k-space.

    ``draw`` optionally supplies the unit normals, shape
    (*batch, ny, nx//2+1, 2) [re, im]; otherwise they come from
    ``generator``. The self-conjugate columns kx=0 and kx=nx/2 are
    symmetrized along ky.
    """
    if nx % 2:
        raise ValueError("white_rfft2_spectrum requires even nx")
    nxr = nx // 2 + 1
    shape = (*batch, ny, nxr, 2)
    if draw is None:
        draw = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    elif tuple(draw.shape) != shape:
        raise ValueError(f"screen draw must have shape {shape}, got {tuple(draw.shape)}")
    else:
        draw = draw.to(device=device, dtype=torch.float32)
    g = float(np.sqrt(np.float32(ny * nx) / np.float32(2.0))) * draw
    z = torch.complex(g[..., 0], g[..., 1])
    cols = z[..., :, [0, nxr - 1]]
    rev = torch.roll(torch.flip(cols, dims=(-2,)), 1, dims=-2)  # ky -> (-ky) mod ny
    sym = (cols + torch.conj(rev)) * float(1 / np.sqrt(2))
    z = z.clone()
    z[..., :, 0] = sym[..., 0]
    z[..., :, nxr - 1] = sym[..., 1]
    return z


def synthesize_matern_field_2d(W, ny: int, nx: int, generator=None, draw=None):
    """The (ny, nx) real screen with spectral weights W (a device tensor)."""
    spec = white_rfft2_spectrum(ny, nx, generator=generator, draw=draw, device=W.device)
    return torch.fft.irfft2(spec * W, s=(ny, nx))


def synthesize_layered_matern_2d(W, M_cos, M_sin, beam, ny: int, nx: int, generator=None, draw=None):
    """The (L, ny, nx) stack of vertically correlated layer screens.

    2J white half-spectra are drawn in k-space (``draw`` optionally
    supplies them, (2J, ny, nx//2+1, 2)), weighted by [W; W], mixed into
    L layers by [M_cos | M_sin] as one real (L, 2J) x (2J, ny*nxr*2)
    product (the mixing matrix is real, so real and imaginary parts mix
    alike), beam-weighted, and inverse-transformed by one batched irfft2.
    W, M_cos, M_sin and beam are device tensors (beam may be None)."""
    J = W.shape[0]
    spec = white_rfft2_spectrum(ny, nx, generator=generator, draw=draw, device=W.device, batch=(2 * J,))
    spec = spec * torch.cat([W, W], dim=0)
    M = torch.cat([M_cos, M_sin], dim=1)  # (L, 2J)
    mixed = M @ torch.view_as_real(spec).reshape(2 * J, -1)
    mixed = torch.view_as_complex(mixed.reshape(M.shape[0], ny, nx // 2 + 1, 2))
    if beam is not None:
        mixed = mixed * beam
    return torch.fft.irfft2(mixed, s=(ny, nx))
