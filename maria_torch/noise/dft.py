"""One-matmul banded noise fused with the TOD accumulate
(maria_tpu/noise/dft.py).

The whole banded noise stage (every band, the NEP scales, the correlated
focal-plane modes) and the final accumulate are one matrix product with
an elementwise epilogue:

    total = A + row_scale * (V @ B)
    A = signal * gains                              (n_det, n)
    V = [ c * z  |  sqrt(cp) * basis ]              (n_det, 2(m+1) + K)
    B = [ C ; S ; mode time series ]                (2(m+1) + K, n)

with z ~ N(0, 1) the frequency-domain white draw (n_det, 2, m+1), c the
half-spectrum amplitude, C/S the inverse-rfft cosine/sine bases at the n
kept samples, and one row of B per correlated mode. When every band
shares one normalized spectral shape (as all nine AtLAST bands do), c is
that shape, V is drawn by kernel K3 (``ops/shared_v.py``) straight into
the product's left operand, and the NEP is the per-row ``row_scale``;
otherwise each band's rows carry its NEP-scaled c and ``row_scale`` is
None.

Types, as in the JAX package: V and B in bfloat16, the product
accumulated and returned in float32. The product itself is a plain large
matrix product (the JAX package's ``jnp.dot``), left to the library: on
the card ``torch.mm(V, B, out_dtype=torch.float32)``, or, where torch
lacks that overload, the float32 product of the bf16-valued operands
(TF32 is off, ``device.py``); on the CPU, which has no kernel for the
overload, the float32 product.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..device import resolve_device
from ..ops.shared_v import draw_key, shared_v, shared_v_plain
from . import band_half_spectrum

__all__ = ["NoiseBandSpec", "band_half_spectrum", "gemm_form", "irfft_cos_sin_basis", "noise_total_matmul"]


@lru_cache(maxsize=16)
def irfft_cos_sin_basis(n_fft: int, n: int):
    """(C, S) float32 numpy bases, each (n_fft//2 + 1, n), such that
    numpy.fft.irfft(Z, n=n_fft)[:, :n] == Re(Z) @ C + Im(Z) @ S."""
    m = n_fft // 2
    k = np.arange(m + 1)[:, None]
    t = np.arange(n)[None, :]
    ang = 2 * np.pi * k * t / n_fft
    a = np.full(m + 1, 2.0)
    a[0] = 1.0
    if n_fft % 2 == 0:
        a[m] = 1.0
    C = (a[:, None] * np.cos(ang) / n_fft).astype(np.float32)
    S = (-(a[:, None]) * np.sin(ang) / n_fft).astype(np.float32)
    return C, S


@dataclass(frozen=True)
class NoiseBandSpec:
    """Static per-band inputs of ``noise_total_matmul``: the band's
    contiguous detector rows ``start:stop``, its NEP-scaled half-spectrum
    amplitude ``c`` (m+1,), its number of correlated modes and their
    unscaled pink half-spectrum ``mode_c``, and ``key_index``, the band's
    position in the program's band list (it indexes injected draws)."""

    start: int
    stop: int
    c: np.ndarray
    k_modes: int = 0
    mode_c: np.ndarray = None
    key_index: int = None


@lru_cache(maxsize=8)
def _basis_tensors(n_fft: int, n: int, device: str):
    """[C; S] (2(m+1), n) on ``device``, float32 and bfloat16."""
    C, S = irfft_cos_sin_basis(n_fft, n)
    cs = torch.as_tensor(np.concatenate([C, S], axis=0), device=device)
    return cs, cs.to(torch.bfloat16)


def _f32(x, device):
    """A float32 tensor on ``device`` from a tensor or an array."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def gemm_form(device) -> str:
    """Which form of the bf16 x bf16 -> f32 product runs on ``device``:
    "mm_out_dtype" (torch.mm with out_dtype) or "f32_of_bf16"."""
    if torch.device(device).type == "cuda" and hasattr(torch.ops.aten.mm, "dtype"):
        return "mm_out_dtype"
    return "f32_of_bf16"


def _gemm(V, B):
    if V.dtype == torch.bfloat16 and gemm_form(V.device) == "mm_out_dtype":
        return torch.mm(V, B, out_dtype=torch.float32)
    return V.float() @ B.float()


def noise_total_matmul(A, specs, n: int, n_fft: int, corr_cols=None, shared_c=None, row_scale=None,
                       generator=None, z=None, mode_z=None, basis_dtype=torch.bfloat16, device=None, rows=None):
    """total = A + banded noise, (n_det, n) float32 (module docstring).

    ``A`` is the gained signal sum, (n_det, n) float32 or a scalar;
    ``specs`` NoiseBandSpecs whose slices partition [0, n_det);
    ``corr_cols`` (n_det, K) the per-band scaled basis columns, aligned
    with the specs' ``k_modes`` (None without correlated modes); both
    may be arrays or tensors (tensors on the device skip a copy). With
    ``shared_c`` (m+1,) and ``row_scale`` (n_det, 1) the bands share one
    spectral shape and, in bfloat16, V comes from kernel K3.
    ``basis_dtype`` float32 keeps V and B in float32 (for draw-exact
    tests).

    Draws come from ``generator`` unless injected: ``z`` the white draw,
    (n_det, 2, m+1) float32 normals (per band, rows start:stop of it,
    when the shape is not shared), and ``mode_z`` a list indexed by
    ``key_index`` of (k, 2, m+1) mode normals. It computes on ``device``,
    else on ``A``'s device when ``A`` is a tensor, else on the card.

    ``rows`` (start, stop) computes only those detector rows of the
    unsharded total, bit for bit in every draw: ``A``, ``corr_cols`` and
    ``row_scale`` then hold those rows, ``specs`` and ``z`` stay global.
    The generator is consumed as the unsharded call consumes it: the
    modes are drawn whole (every rank needs them), V by kernel K3 at
    ``row0 = start`` (no other row is drawn), and a band of its own
    shape draws its whole (n_band, 2, m+1) white block and keeps its rows.
    """
    device = A.device if device is None and torch.is_tensor(A) else resolve_device(device)
    m1 = n_fft // 2 + 1
    row0, row1 = (0, specs[-1].stop) if rows is None else (int(rows[0]), int(rows[1]))
    n_det = row1 - row0
    cs, cs_bf16 = _basis_tensors(n_fft, n, str(device))

    mode_rows = []
    for sp in specs:
        if sp.k_modes:
            zm = (torch.randn((sp.k_modes, 2, m1), generator=generator, device=device) if mode_z is None
                  else mode_z[sp.key_index].to(device=device, dtype=torch.float32))
            # the per-realization mode time series, (k, n)
            mode_rows.append((zm * _f32(sp.mode_c, device)).reshape(sp.k_modes, 2 * m1) @ cs)
    K = sum(sp.k_modes for sp in specs)

    V = torch.empty((n_det, 2 * m1 + K), dtype=basis_dtype, device=device)
    if shared_c is not None and basis_dtype == torch.bfloat16:
        if z is None:
            shared_v(draw_key(generator, device), shared_c, n_det, out=V[None], row0=row0)
        else:
            shared_v_plain(c=shared_c, out=V[None], z=z[row0:row1].to(device))
    else:
        blocks = ([(0, specs[-1].stop, shared_c)] if shared_c is not None
                  else [(sp.start, sp.stop, sp.c) for sp in specs])
        for start, stop, c in blocks:
            zb = (torch.randn((stop - start, 2, m1), generator=generator, device=device) if z is None
                  else z[start:stop].to(device=device, dtype=torch.float32))
            lo, hi = max(start, row0), min(stop, row1)
            if lo >= hi:
                continue
            zb = zb[lo - start:hi - start]
            V[lo - row0:hi - row0, : 2 * m1] = (zb * _f32(c, device)).reshape(hi - lo, 2 * m1).to(basis_dtype)

    B = cs if basis_dtype == torch.float32 else cs_bf16
    if mode_rows:
        V[:, 2 * m1:] = _f32(corr_cols, device).to(basis_dtype)
        B = torch.cat([B, torch.cat(mode_rows, dim=0).to(basis_dtype)], dim=0)
    noise = _gemm(V, B)
    if row_scale is not None:
        noise.mul_(_f32(row_scale, device))
    # A + noise, in place (the same sum: float addition commutes)
    return noise.add_(A)
