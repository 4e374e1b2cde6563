"""TOD signal tools for conditioning real detector data
(maria_tpu/tod/signal.py): glitch cuts, phase templates, downsampling,
circular statistics and contiguous runs.

Host numpy, vectorized over detectors; no simulation or mapper path
calls them. The Fourier filters and ``decompose`` are re-exported from
``utils.signal`` and run on the device of the tensors they are given.
"""

from __future__ import annotations

import numpy as np

from ..utils.signal import bandpass, decompose, highpass, lowpass  # noqa: F401

__all__ = [
    "weighted_binned_mean",
    "get_kernel",
    "unwrap_angle",
    "downsample",
    "get_phase_template",
    "contiguous_runs",
    "make_cuts",
    "apply_cuts",
    "decompose",
    "lowpass",
    "highpass",
    "bandpass",
]


def weighted_binned_mean(x, y, bins, ignore_nan: bool = True, weights=None):
    """The weighted mean of y in the bins of x; NaNs in y are dropped
    with ``ignore_nan`` (they would poison whole bins)."""
    x = np.asarray(x).ravel()
    y = np.asarray(y).ravel()
    w = np.ones_like(y) if weights is None else np.asarray(weights, dtype=float).ravel()
    if ignore_nan:
        good = ~np.isnan(y)
        x, y, w = x[good], y[good], w[good]
    bins = np.asarray(bins)
    idx = np.digitize(x, bins) - 1
    in_range = (idx >= 0) & (idx < len(bins) - 1)
    idx, y, w = idx[in_range], y[in_range], w[in_range]
    numer = np.bincount(idx, weights=w * y, minlength=len(bins) - 1)
    denom = np.bincount(idx, weights=w, minlength=len(bins) - 1)
    with np.errstate(invalid="ignore", divide="ignore"):
        return numer / denom


def get_kernel(n: int, kind: str = "triangle") -> np.ndarray:
    """A normalized triangular smoothing kernel of half-width n."""
    if kind != "triangle":
        raise ValueError(f"Unknown kernel kind '{kind}'.")
    k = 1.0 - np.abs(np.arange(1 - n, n)) / n
    return k / k.sum()


def unwrap_angle(angle: np.ndarray) -> np.ndarray:
    """Angles lifted off the +-pi branch cut so that a contiguous sweep is
    continuous: centred on the circular mean, then on the midrange of the
    centred values."""
    angle = np.asarray(angle)
    z = np.exp(1j * angle)
    center = np.angle(z.mean())
    rel = np.angle(z * np.exp(-1j * center)) + center
    mid = 0.5 * (rel.max() + rel.min())
    return np.angle(z * np.exp(-1j * mid)) + mid


def downsample(data, rate: int, axis: int = -1, method: str = "triangle"):
    """``data`` downsampled by an integer ``rate`` along ``axis``:
    method="flat" averages consecutive windows of ``rate`` samples,
    method="triangle" applies a triangular kernel of support 2 rate - 1
    at stride ``rate``."""
    data = np.asarray(data)
    if rate == 1:
        return data
    if rate < 1 or rate != int(rate):
        raise ValueError("downsample rate must be an integer >= 1")
    rate = int(rate)
    d = np.moveaxis(data, axis, -1)
    n = d.shape[-1]
    if method == "flat":
        cs = np.cumsum(d, axis=-1)
        out = (cs[..., rate::rate] - cs[..., :-rate:rate]) / rate
    else:
        kernel = get_kernel(rate, kind=method)
        n_kern = len(kernel)
        starts = np.arange(0, n - n_kern, rate)
        windows = np.lib.stride_tricks.sliding_window_view(d, n_kern, axis=-1)
        out = windows[..., starts, :] @ kernel
    return np.moveaxis(out, -1, axis)


def get_phase_template(data, phase, n_phase_bins: int, discriminator=None):
    """Each detector's template of a phase-locked systematic (a chopper,
    an elevation-scan synchronous signal): the mean timestream of each
    ``discriminator`` group regressed by least squares onto smoothed
    phase-bin indicators times a quadratic envelope, scaled onto each
    detector by its gain."""
    data = np.atleast_2d(np.asarray(data, dtype=float))
    phase = np.asarray(phase, dtype=float)
    n_det, n_t = data.shape
    disc = np.ones(n_det) if discriminator is None else np.asarray(discriminator)
    template = np.zeros((n_det, n_t))

    # linear-interpolation assignment matrix onto circular phase bins
    frac = phase * (n_phase_bins / (2 * np.pi))
    lo = np.floor(frac).astype(int) % n_phase_bins
    hi = np.ceil(frac).astype(int) % n_phase_bins
    P = np.zeros((n_t, n_phase_bins))
    P[np.arange(n_t), lo] = 1 - frac % 1
    P[np.arange(n_t), hi] = frac % 1
    # circular gaussian smoothing of the bin profile (sigma = 1 bin)
    kb = np.exp(-0.5 * ((np.arange(n_phase_bins) + n_phase_bins // 2) % n_phase_bins - n_phase_bins // 2) ** 2)
    P = np.real(np.fft.ifft(np.fft.fft(P, axis=1) * np.fft.fft(kb / kb.sum())[None], axis=1))

    degree = 2
    envelope = np.vander(np.linspace(-1, 1, n_t), degree + 1, increasing=True)
    design = np.concatenate([P * envelope[:, i : i + 1] for i in range(degree + 1)], axis=1)

    for group in np.unique(disc):
        mask = disc == group
        mean_ts = data[mask].mean(axis=0)
        coeffs, *_ = np.linalg.lstsq(design, mean_ts, rcond=None)
        fitted = design @ coeffs
        gains = (data[mask] @ fitted) / np.square(fitted).sum()
        template[mask] = np.outer(gains, fitted)
    return template


def contiguous_runs(mask, tol: int = 1):
    """(start, stop) index pairs (stop included) of the True runs of a
    boolean mask, runs apart by at most ``tol`` False samples merged."""
    idx = np.flatnonzero(np.asarray(mask))
    if idx.size == 0:
        return []
    breaks = np.flatnonzero(np.diff(idx) > tol + 1)
    starts = idx[np.r_[0, breaks + 1]]
    stops = idx[np.r_[breaks, idx.size - 1]]
    return list(zip(starts.tolist(), stops.tolist()))


def make_cuts(data, n_filt: int = 3, downsample_rate: int = 4, max_cuts: int = 256):
    """Each detector's glitch intervals: the downsampled timestream
    high-passed by a difference filter, samples whose squared residual
    exceeds 100 x the median flagged and grouped into intervals at the
    native rate. A detector with more than ``max_cuts`` is cut whole."""
    data = np.atleast_2d(np.asarray(data, dtype=float))
    ds = downsample(data, rate=downsample_rate, method="triangle")

    filt = -np.ones(n_filt) / (n_filt - 1)
    filt[(n_filt - 1) // 2] = 1.0
    # vectorized same-length convolution over all detectors at once
    pad = n_filt // 2
    padded = np.pad(ds, ((0, 0), (pad, pad)), mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(padded, n_filt, axis=-1)
    residual = windows @ filt[::-1]

    n_t = data.shape[1]
    sq = np.square(residual)
    med = np.median(sq[:, ::4], axis=1, keepdims=True)
    is_bad = (sq > 1e2 * med) | np.isnan(sq)

    cuts = []
    for det_bad in is_bad:
        det_cuts = [
            (downsample_rate * s - 1, downsample_rate * e + 1)
            for s, e in contiguous_runs(det_bad, tol=2)
            if s - 1 >= 0 and e + 1 <= len(det_bad) - 1
        ]
        cuts.append([(0, n_t - 1)] if len(det_cuts) > max_cuts else det_cuts)
    return cuts


def apply_cuts(data, cuts, tol: int = 4, method: str | None = None):
    """The data with its cut intervals repaired: method="splice" bridges
    each linearly, method="flatten" also removes the step across it
    (the median levels either side). An interval over 1,024 samples
    marks the detector bad (NaN at its first sample)."""
    out = np.array(data, dtype=float, copy=True)
    n_t = out.shape[1]
    for i, det_cuts in enumerate(cuts):
        for s, e in det_cuts:
            if e - s > 1024:
                out[i, 0] = np.nan
                continue
            if method == "splice":
                t0, t1 = max(s - 1, 0), min(e, n_t - 1)
                out[i, t0:t1] = np.linspace(out[i, t0], out[i, t1], t1 - t0)
            elif method == "flatten":
                i0, i1, i2, i3 = max(s - tol, 0), s, e, min(e + tol, n_t - 1)
                if not i0 < i1 < i2 < i3:
                    continue
                level_before = np.median(out[i, i0:i1])
                level_after = np.median(out[i, i2:i3])
                out[i, i2:] -= level_after - level_before
                out[i, i1:i2] = level_before
    return out
