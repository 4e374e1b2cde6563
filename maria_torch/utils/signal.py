"""Signal tools for TOD processing and the ML mapper's noise model
(maria_tpu/utils/signal.py).

The B-spline bases, ``grouper`` and the Bessel IIR filters run on the
host in numpy and scipy (float64), as the reference's do. ``decompose``,
``detrend``, ``remove_slope``, ``fast_downsample``, ``median`` and the
FFT filters (``lowpass``, ``highpass``, ``bandpass``: a Butterworth
magnitude applied once, linear in phase, with ``torch.fft``) take tensors
and compute on their device.
"""

from __future__ import annotations

import numpy as np
import scipy as sp
import torch

__all__ = [
    "bandpass",
    "bessel_highpass",
    "bessel_lowpass",
    "bspline_basis",
    "bspline_basis_domain",
    "bspline_basis_from_knots",
    "bspline_knots",
    "cross_basis",
    "decompose",
    "detrend",
    "fast_downsample",
    "fit_bspline",
    "grouper",
    "highpass",
    "lowpass",
    "median",
    "remove_slope",
]


def median(x, dim: int = -1, keepdim: bool = False):
    """The median along ``dim`` as numpy and jax take it: the mean of the
    two middle values of an even count, (low + high) * 0.5 in the input's
    dtype (``torch.median`` returns the lower one)."""
    n = x.shape[dim]
    ordered = torch.sort(x, dim=dim).values
    low = ordered.narrow(dim, (n - 1) // 2, 1)
    high = ordered.narrow(dim, n // 2, 1)
    out = (low + high) * 0.5
    return out if keepdim else out.squeeze(dim)


def decompose(data, k: int = None, downsample_rate: int = 1, mode: str = "uv"):
    """The top-k singular modes of (n_det, n_t) float32 ``data`` on its
    device: (a, b) with data ~ a @ b, a = u_k s_k (n_det, k) and b
    (k, n_t) the least-squares mode time series, u_k^T data / s_k (v_k^T
    when ``downsample_rate`` is 1). The modes of data[:, ::downsample_rate]
    come from the eigenvectors of its float64 Gram matrix (n_det x n_det),
    so the long axis is read once; maria_tpu takes a float32 host SVD
    (signal/__init__.py:59). A singular vector's sign is arbitrary on both
    sides; a @ b is not. ``mode`` is kept for maria_tpu's signature,
    which reads it nowhere either."""
    x = data.to(torch.float64)
    xs = x[:, ::downsample_rate]
    evals, evecs = torch.linalg.eigh(xs @ xs.T)
    k = k or min(xs.shape)
    evals, evecs = evals.flip(0)[:k], evecs.flip(1)[:, :k]
    s = torch.sqrt(torch.clamp(evals, min=0.0))
    live = s > 0
    b = torch.where(live[:, None], (evecs.T @ x) / torch.where(live, s, 1.0)[:, None], 0.0)
    return (evecs * s).to(data.dtype), b.to(data.dtype)


def detrend(data, order: int = 1):
    """Remove the least-squares polynomial of ``order`` along the last
    axis, on the tensor's device (the projection in float64)."""
    n = data.shape[-1]
    V = np.polynomial.polynomial.polyvander(np.linspace(-1, 1, n), order)
    Q = torch.as_tensor(np.linalg.qr(V)[0], device=data.device)
    x = data.to(torch.float64)
    return (x - (x @ Q) @ Q.T).to(data.dtype)


def bspline_basis(n: int, spacing: int = None, n_knots: int = None, order: int = 3):
    """(n_basis, n) cubic B-spline basis over n samples, float64 on the host."""
    if spacing is None and n_knots is None:
        raise ValueError("supply either 'spacing' (in samples) or 'n_knots'")
    n_knots = n_knots or max(int(n / spacing) + 1, 2)
    t = np.linspace(0, n - 1, n_knots)
    t = np.r_[[t[0]] * order, t, [t[-1]] * order]
    x = np.arange(n)
    k = len(t) - order - 1
    B = np.stack(
        [sp.interpolate.BSpline.basis_element(t[i : i + order + 2], extrapolate=False)(x) for i in range(k)],
        axis=0,
    )
    return np.nan_to_num(B)


def bspline_knots(t, spacing, order: int = 3):
    """Uniform knot vector straddling the domain of t, padded by ``order``
    knots on each side."""
    t = np.asarray(t, dtype=float)
    tmin, tmax = t.min(), t.max()
    n_bins = max(int((tmax - tmin) // spacing), 1)
    k = spacing * np.arange(n_bins, dtype=float)
    k += (tmax + tmin) / 2 - k.mean()
    return np.r_[k[0] + spacing * np.arange(-order - 1, 0), k, k[-1] + spacing * np.arange(1, order + 2)]


def bspline_basis_from_knots(t, k, order: int = 3):
    """(n_basis, len(t)) B-spline basis by the Cox-de Boor recursion over
    the knot vector ``k``."""
    t = np.asarray(t, dtype=float)
    k = np.asarray(k, dtype=float)
    n_basis = len(k) - order - 1
    B = np.zeros((len(k) + 1, order + 1, len(t)))
    B[np.digitize(t, k) - 1, 0, np.arange(len(t))] = 1
    for p in range(1, order + 1):
        for i in range(len(k) - p - 1):
            left = (t - k[i]) / (k[i + p] - k[i])
            right = (k[i + p + 1] - t) / (k[i + p + 1] - k[i + 1])
            B[i, p] = B[i, p - 1] * left + B[i + 1, p - 1] * right
    return B[:n_basis, -1]


def bspline_basis_domain(t, spacing, order: int = 3):
    """The basis at sample positions t with a knot ``spacing`` in t's units."""
    return bspline_basis_from_knots(t, bspline_knots(t, spacing, order), order)


def fit_bspline(y, x, spacing, order: int = 3):
    """The least-squares B-spline fit of y(x), as a curve of y's shape."""
    B = bspline_basis_domain(np.asarray(x, dtype=float), spacing=spacing, order=order)
    B = B[B.sum(axis=-1) > 0]
    coeffs, *_ = np.linalg.lstsq(B.T, np.asarray(y, dtype=float).T, rcond=None)
    return (coeffs.T @ B).reshape(np.shape(y))


def cross_basis(X: list, spacing: list, order: list):
    """Tensor-product basis over several coordinates, empty products pruned."""
    basis = np.ones((1, 1))
    for dim, x in enumerate(X):
        x_basis = bspline_basis_domain(np.asarray(x, dtype=float), spacing[dim], order[dim])
        basis = (x_basis[:, None] * basis).reshape(-1, len(np.asarray(x)))
        basis = basis[basis.sum(axis=-1) > 0]
    return basis


def fast_downsample(data, r: int = 1):
    """Block means of r samples along the last axis, by one cumsum, on
    the tensor's device."""
    cs = torch.cumsum(data, dim=-1)
    return (cs[..., r::r] - cs[..., :-r:r]) / r


def remove_slope(data):
    """Subtract the line through each row's first and last samples."""
    n = data.shape[-1]
    ramp = torch.linspace(0.0, 1.0, n, dtype=data.dtype, device=data.device)
    return data - (data[..., :1] + (data[..., -1:] - data[..., :1]) * ramp)


def grouper(iterable, min_length: int = 1, max_length: float = np.inf, overlap: bool = False):
    """Yield (start, stop) half-open index pairs of the True runs, runs
    longer than ``max_length`` split (``overlap`` is kept for maria_tpu's
    signature, which reads it nowhere either)."""
    start = np.inf
    prev_value = False
    index = -1
    for index, this_value in enumerate(iterable):
        if this_value:
            if not prev_value:
                start = index
            elif index - start >= max_length:
                yield (start, index)
                start = index
        elif prev_value and index - start >= min_length:
            yield (start, index)
        prev_value = this_value
    if prev_value and index + 1 - start >= min_length:
        yield (start, index + 1)


def bessel_lowpass(data, fc, sample_rate, order: int = 1, axis: int = -1):
    """Causal Bessel IIR low-pass (scipy SOS on the host, float64)."""
    sos = sp.signal.bessel(2 * (order + 1), 2 * fc / sample_rate, analog=False, btype="low", output="sos")
    return sp.signal.sosfilt(sos, data, axis=axis)


def bessel_highpass(data, fc, sample_rate, order: int = 1, axis: int = -1):
    """Causal Bessel IIR high-pass (scipy SOS on the host, float64)."""
    sos = sp.signal.bessel(2 * (order + 1), 2 * fc / sample_rate, analog=False, btype="high", output="sos")
    return sp.signal.sosfilt(sos, data, axis=axis)


def _fft_filter(data, sample_rate, transfer):
    n = data.shape[-1]
    f = torch.fft.rfftfreq(n, d=1 / sample_rate, dtype=data.dtype, device=data.device)
    return torch.fft.irfft(torch.fft.rfft(data, dim=-1) * transfer(f), n=n, dim=-1)


def _rolloff(f, cutoff, order):
    # |H| of an order-n Butterworth, applied once: a linear-phase FFT filter
    return 1.0 / torch.sqrt(1.0 + (f / cutoff) ** (2 * order))


def lowpass(data, cutoff, sample_rate, order: int = 4):
    return _fft_filter(data, sample_rate, lambda f: _rolloff(f, cutoff, order))


def highpass(data, cutoff, sample_rate, order: int = 4):
    return _fft_filter(data, sample_rate, lambda f: 1.0 - _rolloff(f, cutoff, order))


def bandpass(data, f_lower, f_upper, sample_rate, order: int = 4):
    return _fft_filter(data, sample_rate, lambda f: (1.0 - _rolloff(f, f_lower, order)) * _rolloff(f, f_upper, order))
