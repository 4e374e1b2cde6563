"""Plain float64 building blocks of the references: the operations that
the program's realization performs, written from their definitions in
plain torch and numpy, with none of the program's code.

``rounder(kind)`` gives the precision of a computation: "none" for the
reference, "bf16" and "fp8" (e4m3 with a per-tensor scale) for the
control that stands in for a program computed one step below the
precision that its configuration states.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F64 = torch.float64
H, K_B, C = 6.62607015e-34, 1.380649e-23, 2.99792458e8  # Planck's and Boltzmann's constants, the speed of light
M32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
FP8_MAX = 448.0  # the largest finite e4m3 value


def f64(a, device):
    """A float64 tensor on ``device`` from an array or a tensor."""
    if torch.is_tensor(a):
        return a.to(device=device, dtype=F64)
    return torch.as_tensor(np.asarray(a), dtype=F64, device=device)


def rounder(kind: str):
    """x -> x rounded to ``kind`` and back to its own type."""
    if kind == "none":
        return lambda x: x
    if kind == "bf16":
        return lambda x: x.to(torch.bfloat16).to(x.dtype)
    if kind == "fp8":
        def fp8(x):
            scale = float(x.abs().max()) / FP8_MAX or 1.0
            return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
        return fp8
    raise ValueError(f"unknown precision '{kind}'")


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit words of a * m for int64 a < 2^32, split so that
    every partial product stays below 2^48."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & M32
    return hi, lo


def philox4x32_10(ctr, key):
    """Philox4x32-10 (Salmon et al., SC 2011) on int64 tensors holding
    32-bit words; ``ctr`` four broadcastable tensors, ``key`` two ints."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W[0]) & M32
        k1 = (k1 + PHILOX_W[1]) & M32
    return c0, c1, c2, c3


def box_muller(a, b):
    """Two standard normals from two 32-bit words each, float64: the top
    24 bits as a uniform in (0, 1)."""
    u = ((a >> 8).to(F64) + 0.5) * 2.0**-24
    v = ((b >> 8).to(F64) + 0.5) * 2.0**-24
    r = torch.sqrt(-2.0 * torch.log(u))
    return r * torch.cos(2 * math.pi * v), r * torch.sin(2 * math.pi * v)


def philox_complex_normals(key, rows, m1: int):
    """(len(rows), m1) complex standard normals (re, im): bin 2p of a
    row from Philox words (x0, x1), bin 2p + 1 from (x2, x3), at counter
    (p, row, 0, 0) under ``key``."""
    n_pairs = (m1 + 1) // 2
    device = rows.device
    p = torch.arange(n_pairs, dtype=torch.int64, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    x0, x1, x2, x3 = philox4x32_10((p, rows[:, None], zero, zero), key)
    shape = (len(rows), n_pairs)
    re_e, im_e = box_muller(x0.expand(shape), x1.expand(shape))
    re_o, im_o = box_muller(x2.expand(shape), x3.expand(shape))
    re = torch.stack([re_e, re_o], dim=-1).reshape(len(rows), 2 * n_pairs)[:, :m1]
    im = torch.stack([im_e, im_o], dim=-1).reshape(len(rows), 2 * n_pairs)[:, :m1]
    return re, im


def offsets_to_phi_theta(dx, dy, cphi, ctheta):
    """The azimuthal-equidistant projection inverted: tangent-plane
    offsets (dx, dy) about (cphi, ctheta) to (phi, theta); positive dx
    decreases phi."""
    r = torch.sqrt(dx**2 + dy**2)
    sinc = torch.where(r > 0, torch.sin(r) / torch.where(r > 0, r, 1.0), 1.0)
    sin_t = torch.sin(ctheta) * torch.cos(r) + torch.cos(ctheta) * sinc * dy
    merid = torch.cos(ctheta) * torch.cos(r) - torch.sin(ctheta) * sinc * dy
    return cphi + torch.atan2(-sinc * dx, merid), torch.asin(torch.clamp(sin_t, -1.0, 1.0))


def phi_theta_to_offsets(phi, theta, cphi, ctheta):
    """The azimuthal-equidistant projection about (cphi, ctheta), numbers
    or tensors broadcasting against the points: (phi, theta) to
    tangent-plane offsets (dx, dy), the inverse of
    ``offsets_to_phi_theta``."""
    ctheta = torch.as_tensor(ctheta, dtype=theta.dtype, device=theta.device)
    sin_c, cos_c = torch.sin(ctheta), torch.cos(ctheta)
    dphi = phi - cphi
    cos_t = torch.cos(theta)
    u = torch.sin(dphi) * cos_t
    v = torch.cos(dphi) * cos_t * sin_c - torch.sin(theta) * cos_c
    w = torch.cos(dphi) * cos_t * cos_c + torch.sin(theta) * sin_c
    sin_r = torch.sqrt(u**2 + v**2)
    scale = torch.where(sin_r > 0, torch.atan2(sin_r, w) / torch.where(sin_r > 0, sin_r, 1.0), 1.0)
    return -u * scale, -v * scale


def bilinear_uniform(values, x, y, x0: float, dx: float, y0: float, dy: float):
    """Bilinear value of the (ny, nx) grid with cell (i, j) at (x0 + j dx,
    y0 + i dy) at the points (x, y); zero outside the grid."""
    ny, nx = values.shape
    fx, fy = (x - x0) / dx, (y - y0) / dy
    inside = (fx >= 0) & (fx <= nx - 1) & (fy >= 0) & (fy <= ny - 1)
    ix = torch.clamp(torch.floor(fx), 0, nx - 2)
    iy = torch.clamp(torch.floor(fy), 0, ny - 2)
    wx, wy = fx - ix, fy - iy
    base = (iy * nx + ix).to(torch.int64)
    flat = values.reshape(-1)
    out = (flat[base] * (1 - wy) * (1 - wx) + flat[base + 1] * (1 - wy) * wx
           + flat[base + nx] * wy * (1 - wx) + flat[base + nx + 1] * wy * wx)
    return torch.where(inside, out, 0.0)


def grid_coordinate(side, x):
    """The fractional index of x on the ascending grid ``side``, clipped
    to it: arithmetic on a uniform axis, on log(x) on a log-uniform one,
    piecewise linear otherwise (the table's own interpolation axis)."""
    side = np.asarray(side, dtype=np.float64)
    d = np.diff(side)
    if np.ptp(d) <= 1e-5 * np.abs(d).mean():
        f = (x - side[0]) / d.mean()
    elif (side > 0).all() and np.ptp(np.diff(np.log(side))) <= 1e-5 * np.abs(np.diff(np.log(side))).mean():
        f = (torch.log(x) - math.log(side[0])) / np.diff(np.log(side)).mean()
    else:
        s = torch.as_tensor(side, dtype=F64, device=x.device)
        i = torch.clamp(torch.searchsorted(s, x.contiguous(), right=True) - 1, 0, len(side) - 2)
        f = i + (x - s[i]) / (s[i + 1] - s[i])
    return torch.clamp(f, 0.0, len(side) - 1.0)


def table_bilinear(x_side, y_side, table, x, y):
    """Bilinear value of the (len(x_side), len(y_side)) table at (x, y),
    clipped to its domain."""
    nx, ny = table.shape
    u, v = grid_coordinate(x_side, x), grid_coordinate(y_side, y)
    i = torch.clamp(torch.floor(u), 0, nx - 2)
    j = torch.clamp(torch.floor(v), 0, ny - 2)
    wu, wv = u - i, v - j
    base = (i * ny + j).to(torch.int64)
    flat = table.reshape(-1)
    return (flat[base] * (1 - wu) * (1 - wv) + flat[base + 1] * (1 - wu) * wv
            + flat[base + ny] * wu * (1 - wv) + flat[base + ny + 1] * wu * wv)


def catmull_rom_upsample(values, ratio: int, n_fine: int):
    """(..., n_c) coarse samples to n_fine samples at ``ratio`` fine
    samples a coarse step: the Catmull-Rom spline through them, the end
    samples repeated as its outer knots, and the last coarse value held
    past the last knot."""
    n_c = values.shape[-1]
    s = torch.arange(ratio, dtype=F64, device=values.device) / ratio
    pad = torch.cat([values[..., :1], values, values[..., -1:]], dim=-1)
    p0, p1, p2, p3 = (pad[..., k:k + n_c - 1, None] for k in range(4))
    out = 0.5 * (2 * p1 + (p2 - p0) * s + (2 * p0 - 5 * p1 + 4 * p2 - p3) * s**2
                 + (3 * p1 - p0 - 3 * p2 + p3) * s**3)
    out = out.reshape(*values.shape[:-1], (n_c - 1) * ratio)
    if out.shape[-1] < n_fine:
        out = torch.cat([out, values[..., -1:].expand(*values.shape[:-1], n_fine - out.shape[-1])], dim=-1)
    return out[..., :n_fine]


def white_half_spectrum(draw):
    """The complex (..., ny, nx//2 + 1) half-spectrum of a real white
    (ny, nx) field of unit variance a cell, from its (..., ny, nx//2 + 1,
    2) unit normals: each bin of variance ny nx, the self-conjugate
    columns kx = 0 and kx = nx/2 made Hermitian along ky."""
    ny, nxr = draw.shape[-3], draw.shape[-2]
    nx = 2 * (nxr - 1)
    g = math.sqrt(ny * nx / 2) * draw.to(F64)
    z = torch.complex(g[..., 0], g[..., 1])
    cols = z[..., :, [0, nxr - 1]]
    rev = torch.roll(torch.flip(cols, dims=(-2,)), 1, dims=-2)
    sym = (cols + torch.conj(rev)) / math.sqrt(2)
    z = z.clone()
    z[..., :, 0] = sym[..., 0]
    z[..., :, nxr - 1] = sym[..., 1]
    return z


def fft_size(n: int) -> int:
    """The noise process's FFT length: the smallest m 2^k >= n with odd
    part m in {1, 3, 5, 9} (n at least 16)."""
    n = max(int(n), 16)
    best = 1 << (n - 1).bit_length()
    for m in (3, 5, 9):
        size = m << max(0, (-(-n // m) - 1).bit_length()) if n > m else m
        while size < n:
            size *= 2
        best = min(best, size)
    return best


def knee_spectrum(sample_rate: float, knee: float, n_fft: int, white: float, pink: float):
    """(n_fft//2 + 1,) amplitude of a noise process's spectral draw:
    sqrt(white * fs + pink * 2 fs (knee / 2) / f) at the rfft frequencies
    (no pink power at f = 0), times the rfft of unit white noise's scale
    (sqrt(n/2) inside, sqrt(n) at the real DC and Nyquist bins)."""
    f = np.fft.rfftfreq(n_fft, d=1 / sample_rate)
    with np.errstate(divide="ignore"):
        pink_psd = np.where(f != 0, 2 * sample_rate * (knee / 2) / np.abs(f), 0.0)
    scale = np.full(len(f), np.sqrt(n_fft / 2))
    scale[0] = np.sqrt(n_fft)
    if n_fft % 2 == 0:
        scale[-1] = np.sqrt(n_fft)
    return np.sqrt(white * sample_rate + pink * pink_psd) * scale
