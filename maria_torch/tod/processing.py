"""TOD processing (maria_tpu/tod/processing.py): ordered, validated
operations on a TOD's signal and weights, on the TOD's device.

The ops run in ``PROCESS_ORDER``: ``despike`` (flag and repair glitches),
``remove_slope``, ``remove_spline`` (a least-squares B-spline baseline,
optionally with polynomials in elevation), ``window`` (into the data and
the weights), ``filter`` (the FFT Butterworth magnitude, or the host's
Bessel IIR with ``method="bessel"``) and ``remove_modes`` (the strongest
SVD common modes). The B-spline basis and the window are host numpy and
scipy in float64; every op computes with torch on the data's device, the
spline fit in float64, the rest in float32.
"""

from __future__ import annotations

import logging

import numpy as np
import scipy as sp
import torch

from ..utils.signal import bandpass, bessel_highpass, bessel_lowpass, bspline_basis, highpass, lowpass, median

__all__ = ["OPERATION_KWARGS", "PROCESS_ORDER", "apply_filter", "despike", "process_operation_kwargs", "process_tod",
           "remove_modes", "remove_slope", "remove_spline", "validate_process_config", "window"]

logger = logging.getLogger("maria_torch")

PROCESS_ORDER = ["despike", "remove_slope", "remove_spline", "window", "filter", "remove_modes"]

# each op's parameters: the type a value is coerced to, and the flat
# keyword aliases that process_operation_kwargs takes
OPERATION_KWARGS = {
    "despike": {
        "threshold": {"dtype": float, "aliases": ["despike_threshold"]},
        "window": {"dtype": int, "aliases": ["despike_window"]},
        "pad": {"dtype": int, "aliases": ["despike_pad"]},
    },
    "remove_slope": {},
    "window": {
        "name": {"dtype": str, "aliases": ["window"]},
        "kwargs": {"dtype": dict, "aliases": ["window_kwargs"]},
    },
    "filter": {
        "f_lower": {"dtype": float, "aliases": ["f_lower"]},
        "f_upper": {"dtype": float, "aliases": ["f_upper"]},
        "order": {"dtype": int, "aliases": ["filter_order"]},
        "method": {"dtype": str, "aliases": ["filter_method"]},
    },
    "remove_modes": {
        "n": {"dtype": int, "aliases": ["modes_to_remove", "n_modes"]},
    },
    "remove_spline": {
        "knot_spacing": {"dtype": float, "aliases": ["remove_spline_knot_spacing"]},
        "remove_el_gradient": {"dtype": bool, "aliases": ["remove_el_gradient"]},
        "remove_el_gradient_order": {"dtype": int, "aliases": ["remove_el_gradient_order"]},
    },
}


def process_operation_kwargs(**kwargs):
    """Regroup flat, alias-named keywords (``f_upper=2.0, window="hann"``)
    into the nested per-op config that ``process_tod`` takes."""
    config = {}
    for operation, params in OPERATION_KWARGS.items():
        subconfig = {}
        for key, param in params.items():
            for kwarg in list(kwargs):
                if kwarg in param["aliases"]:
                    subconfig[key] = kwargs.pop(kwarg)
        if subconfig:
            config[operation] = subconfig
    if kwargs:
        raise ValueError(f"Invalid kwargs for TOD processing: {kwargs}.")
    return config


def validate_process_config(config):
    """Check op and parameter names, turn alias names into the canonical
    ones and coerce values to their types, in place. A boolean per op
    (``remove_slope=True``) passes through."""
    for operation, params in config.items():
        if operation not in OPERATION_KWARGS:
            raise ValueError(f"Invalid operation '{operation}'. Valid operations are {list(OPERATION_KWARGS)}.")
        if not isinstance(params, dict):
            continue
        for key, value in list(params.items()):
            if key == "el":  # put in by process_tod
                continue
            if key not in OPERATION_KWARGS[operation]:
                canonical = next((c for c, p in OPERATION_KWARGS[operation].items() if key in p["aliases"]), None)
                if canonical is None:
                    raise ValueError(f"Invalid param '{key}' for operation '{operation}'. Valid parameters "
                                     f"are {list(OPERATION_KWARGS[operation])}.")
                config[operation][canonical] = config[operation].pop(key)
                key = canonical
            dtype = OPERATION_KWARGS[operation][key]["dtype"]
            if not isinstance(value, dtype):
                try:
                    config[operation][key] = dtype(value)
                except Exception:
                    raise TypeError(f"Could not convert param {{{key}: {value}}} for operation "
                                    f"'{operation}' to type '{dtype.__name__}'.") from None
    return config


def _check_nan(name, data):
    if bool(torch.isnan(data).any()):
        raise RuntimeError(f"Processing op '{name}' introduced NaNs.")


def _boxcar_sum(x, w: int):
    """The zero-padded "same" boxcar sum of w samples along the last axis,
    equal to np.convolve(row, ones(w), "same") a row, by prefix sums."""
    n = x.shape[-1]
    csum = torch.cat([torch.zeros((*x.shape[:-1], 1), dtype=x.dtype, device=x.device), torch.cumsum(x, dim=-1)],
                     dim=-1)
    i = torch.arange(n, device=x.device)
    hi = torch.clamp(i + (w - 1) // 2 + 1, 0, n)
    lo = torch.clamp(i - w // 2, 0, n)
    return csum[..., hi] - csum[..., lo]


def despike(data, weight, threshold: float = 10.0, window: int = 16, pad: int = 2):
    """Flag and repair glitches: a sample further than ``threshold``
    robust sigmas from a boxcar baseline of ``window`` samples, and
    ``pad`` samples on either side, take the baseline of their good
    neighbours (the row's mean where the window has none) and weight
    zero. The prefix sums run on mean-subtracted rows, since those of the
    raw signal lose float32 precision."""
    n = data.shape[-1]
    w = int(min(window, max(3, n // 4)))
    mu = data.mean(dim=-1, keepdim=True)
    xc = data - mu
    edge = _boxcar_sum(torch.ones(n, dtype=data.dtype, device=data.device), w) / w  # below 1 near the edges
    baseline = _boxcar_sum(xc, w) / w + mu * edge
    resid = data - baseline
    sigma = 1.4826 * median(resid.abs(), dim=-1, keepdim=True)
    bad = resid.abs() > threshold * torch.clamp(sigma, min=1e-30)
    if pad > 0:
        bad = _boxcar_sum(bad.to(torch.float32), 2 * pad + 1) > 0
    # repair with a masked boxcar: the plain baseline holds the spike's own power
    good = (~bad).to(data.dtype)
    den = _boxcar_sum(good, w)
    repair = (_boxcar_sum(xc * good, w) + mu * den) / torch.clamp(den, min=1e-6)
    # a window with no good sample takes the row's mean (maria_tpu divides
    # the prefix sums' rounding by 1e-6 there)
    repair = torch.where(den > 0.5, repair, mu)
    return torch.where(bad, repair, data), torch.where(bad, torch.zeros_like(weight), weight)


def remove_slope(data, **kwargs):
    """Subtract each row's mean and its least-squares slope in time."""
    n = data.shape[-1]
    t = torch.linspace(-1.0, 1.0, n, dtype=data.dtype, device=data.device)
    slope = (data @ t) / (t @ t)
    return data - data.mean(dim=-1, keepdim=True) - slope[..., None] * t


def remove_spline(data, sample_rate, knot_spacing: float = 10.0, remove_el_gradient: bool = False,
                  remove_el_gradient_order: int = 0, el=None, **kwargs):
    """Subtract each row's least-squares B-spline baseline with knots
    ``knot_spacing`` seconds apart; ``remove_el_gradient_order`` (1 with
    ``remove_el_gradient``) adds powers of the standardised mean elevation
    ``el`` (n_det, n_t) as regressors. A scan at constant elevation has no
    gradient to remove. The ridge 1e-6 x the mean diagonal guards bases
    that are degenerate, as a knot spacing longer than the scan gives.
    The fit runs in float64 on the data's device: the elevation regressors
    make the normal matrix ill-conditioned (~5e4 for a 20 s daisy), and
    maria_tpu's float32 solve there is good to ~1e-3 of the input."""
    n = data.shape[-1]
    B = bspline_basis(n, spacing=max(int(knot_spacing * sample_rate), 2))
    order = max(int(remove_el_gradient_order), 1 if remove_el_gradient else 0)
    if order and el is not None:
        el_mean = el.to(torch.float64).mean(dim=0, keepdim=True).cpu().numpy()
        if el_mean.std() > 1e-12 * max(abs(el_mean.mean()), 1e-12):
            el_mean = (el_mean - el_mean.mean()) / el_mean.std()
            B = np.concatenate([B, *[el_mean**p for p in range(1, order + 1)]], axis=0)
    B = torch.as_tensor(B, dtype=torch.float64, device=data.device)
    x = data.to(torch.float64)
    gram = B @ B.T
    gram = gram + 1e-6 * torch.trace(gram) / gram.shape[0] * torch.eye(gram.shape[0], dtype=gram.dtype,
                                                                       device=gram.device)
    coeffs = torch.linalg.solve(gram, B @ x.T).T
    return (x - coeffs @ B).to(data.dtype)


def window(data, weight, name: str = "tukey", kwargs: dict = None, **extra):
    """Multiply the data and the weights by scipy's window ``name``
    (Tukey with alpha 0.1 by default)."""
    if kwargs is None:
        kwargs = {"alpha": 0.1} if name == "tukey" else {}
    w = sp.signal.get_window((name, *kwargs.values()) if kwargs else name, data.shape[-1])
    w = torch.as_tensor(w, dtype=data.dtype, device=data.device)
    return data * w, weight * w


def apply_filter(data, sample_rate, f_lower: float = None, f_upper: float = None, order: int = 4,
                 method: str = "fft", **kwargs):
    """High-, low- or band-pass between ``f_lower`` and ``f_upper`` Hz:
    the Butterworth magnitude of ``order`` by FFT on the device
    (``method="fft"``), or the host's causal Bessel SOS filters in float64
    (``method="bessel"``)."""
    if method == "bessel":
        out = data.cpu().numpy()
        if f_lower is not None:
            out = bessel_highpass(out, f_lower, sample_rate, order=order)
        if f_upper is not None:
            out = bessel_lowpass(out, f_upper, sample_rate, order=order)
        return torch.as_tensor(out, dtype=torch.float32, device=data.device)
    if f_lower is not None and f_upper is not None:
        return bandpass(data, f_lower, f_upper, sample_rate, order=order)
    if f_lower is not None:
        return highpass(data, f_lower, sample_rate, order=order)
    if f_upper is not None:
        return lowpass(data, f_upper, sample_rate, order=order)
    return data


def remove_modes(data, n: int = 1, **kwargs):
    """Remove the ``n`` strongest SVD common modes."""
    u, s, vh = torch.linalg.svd(data, full_matrices=False)
    s = torch.cat([torch.zeros_like(s[:n]), s[n:]])
    return (u * s) @ vh


def process_tod(tod, **config):
    """A new TOD whose one field, "signal", is ``tod``'s signal after the
    ops of ``config`` in ``PROCESS_ORDER``, with their weights."""
    from .tod import TOD

    for key in config:
        if key not in PROCESS_ORDER:
            raise ValueError(f"Invalid processing op '{key}' (valid: {PROCESS_ORDER}).")
    validate_process_config(config)

    def op_kwargs(op):
        return dict(config[op]) if isinstance(config[op], dict) else {}

    data, weight, fs = tod.signal, tod.weight, tod.fs
    if config.get("despike"):
        weight_before = weight
        data, weight = despike(data, weight, **op_kwargs("despike"))
        _check_nan("despike", data)
        if logger.isEnabledFor(logging.INFO):  # a device read only when someone listens
            logger.info(f"despike: flagged {int(((weight == 0) & (weight_before != 0)).sum())} samples.")
    if config.get("remove_slope"):
        data = remove_slope(data)
        _check_nan("remove_slope", data)
    if "remove_spline" in config:
        kw = op_kwargs("remove_spline")
        if kw.get("remove_el_gradient") or kw.get("remove_el_gradient_order"):
            kw["el"] = tod.el
        data = remove_spline(data, sample_rate=fs, **kw)
        _check_nan("remove_spline", data)
    if "window" in config:
        data, weight = window(data, weight, **op_kwargs("window"))
        _check_nan("window", data)
    if "filter" in config:
        data = apply_filter(data, sample_rate=fs, **op_kwargs("filter"))
        _check_nan("filter", data)
    if "remove_modes" in config:
        data = remove_modes(data, **op_kwargs("remove_modes"))
        _check_nan("remove_modes", data)
    return TOD(data={"signal": data}, pointing=tod.pointing, weight=weight, units=tod.units, dets=tod.dets,
               metadata=tod.metadata, spectrum=tod._spectrum)
