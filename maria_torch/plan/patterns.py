"""Scan patterns (maria_tpu/plan/patterns.py): each generator maps
relative times in seconds to boresight offsets (2, n_t) in the units of
its throws. The patterns are a behavioural contract: the same named plan
gives the same boresight track in both packages, so their formulas and
constants (the daisy's petals sqrt(e) and its speed-normalizing loop, the
smooth sawtooth of the raster and the back-and-forth, the lissajous and
double-circle frequency ratios) are maria_tpu's to the letter."""

from __future__ import annotations

import numpy as np
import scipy as sp

from ..utils import rotation_matrix_2d

__all__ = ["SCAN_PATTERNS", "all_patterns", "get_scan_pattern_generator", "parse_scan_kwargs"]

VALID_SCAN_KWARGS = [
    "time", "radius", "width", "height", "x_throw", "y_throw", "speed", "n",
    "petals", "ratio", "freq_ratio", "miss_factor", "miss_freq",
    "rotation_period", "smoothness",
]


def parse_scan_kwargs(scan_kwargs: dict, default_radius: float = 1.0) -> dict:
    """The scan options with the throws and the speed filled in: a
    ``radius``, ``width`` or ``height`` becomes ``x_throw``/``y_throw``, and
    the speed defaults to a quarter of the larger throw."""
    scan_kwargs = dict(scan_kwargs)
    for kwarg in scan_kwargs:
        if kwarg not in VALID_SCAN_KWARGS:
            raise ValueError(f"Invalid scan kwarg '{kwarg}'.")

    size_kwargs = ["radius", "width", "x_throw", "height", "y_throw"]
    if not any(k in scan_kwargs for k in size_kwargs):
        scan_kwargs["radius"] = default_radius

    if "x_throw" not in scan_kwargs:
        if "radius" in scan_kwargs:
            scan_kwargs["x_throw"] = scan_kwargs.pop("radius")
        elif "width" in scan_kwargs:
            scan_kwargs["x_throw"] = 0.5 * scan_kwargs.pop("width")
        elif "y_throw" in scan_kwargs:
            scan_kwargs["x_throw"] = scan_kwargs["y_throw"]
        else:
            scan_kwargs["x_throw"] = 0.5 * scan_kwargs.pop("height")

    if "y_throw" not in scan_kwargs:
        if "height" in scan_kwargs:
            scan_kwargs["y_throw"] = 0.5 * scan_kwargs.pop("height")
        else:
            scan_kwargs["y_throw"] = scan_kwargs["x_throw"]

    if "speed" not in scan_kwargs:
        scan_kwargs["speed"] = max(scan_kwargs["x_throw"], scan_kwargs["y_throw"]) / 4

    return scan_kwargs


def stare(time, **extra):
    return np.zeros((2, *np.shape(time)))


def lissajous(time, x_throw, y_throw, speed, freq_ratio=1.193, **extra):
    freq = speed / np.sqrt((x_throw * freq_ratio) ** 2 + y_throw**2)
    x = x_throw * np.cos(freq_ratio * freq * time)
    y = y_throw * np.sin(freq * time)
    return np.stack([x, y])


def double_circle(time, x_throw, y_throw, speed, ratio=0.5, freq_ratio=1.7, **extra):
    radius = x_throw
    a = radius / (1 + 1 / ratio)
    b = a / ratio
    phase = time * speed / max(a + b * freq_ratio, 1e-16)
    x = a * np.sin(phase) + b * np.sin(phase * freq_ratio)
    y = a * np.cos(phase) + b * np.cos(phase * freq_ratio)
    return np.stack([x, (y_throw / x_throw) * y])


def _daisy_from_phase(phase, a, b, petals, miss_freq):
    x = a * np.cos(petals * phase) * np.sin(phase) + b * np.sin(petals * phase) * np.cos(miss_freq * phase)
    y = a * np.cos(petals * phase) * np.cos(phase) + b * np.sin(petals * phase) * np.sin(miss_freq * phase)
    X = np.stack([x, y])
    return (a + b) * X / np.sqrt(np.square(X).sum(axis=0).max())


def daisy(time, x_throw, y_throw, speed, petals=np.sqrt(np.e), miss_factor=0.2, miss_freq=0.1, **extra):
    """Petal-curve daisy, its phase rate rescaled (at most four times)
    until the peak speed is within 1% of ``speed``."""
    radius = x_throw
    if radius <= 0:
        return np.zeros((2, len(time)))
    a = radius / (1 + miss_factor)
    b = a * miss_factor
    dp = (speed / radius) * np.gradient(time)
    for _ in range(4):
        phase = np.cumsum(dp)
        tx, ty = _daisy_from_phase(phase, a=a, b=b, petals=petals, miss_freq=miss_freq)
        v = np.sqrt((np.gradient(tx) / np.gradient(time)) ** 2 + (np.gradient(ty) / np.gradient(time)) ** 2)
        max_speed = v.max()
        if abs(np.log(max_speed / speed)) > 0.01:
            dp *= speed / max_speed
        else:
            break
    x, y = _daisy_from_phase(np.cumsum(dp), a=a, b=b, petals=petals, miss_freq=miss_freq)
    return np.stack([x, (y_throw / x_throw) * y])


def _smooth_sawtooth(p, delta=0.01):
    norm = 1 / (2 * np.arccos(delta - 1) / np.pi - 1)
    return norm * (1 - 2 * np.arccos((delta - 1) * np.cos(p)) / np.pi)


def back_and_forth(time, radius=1.0, x_throw=None, y_throw=0.0, speed=1.0, max_accel=np.inf, d=0.01, **extra):
    x_throw = x_throw if x_throw is not None else radius
    factor = 1 / (1 - 2 * np.arccos(1 - d) / np.pi)
    throw = factor * np.sqrt(x_throw**2 + y_throw**2)
    a = np.pi * speed / (2 * throw * (1 - d))
    b = np.sqrt(np.pi * max_accel * np.sqrt(2 * d - d**2) / (2 * throw * (1 - d))) if np.isfinite(max_accel) else np.inf
    dp_dt = min(a, b)
    x = factor * x_throw * _smooth_sawtooth(dp_dt * time, delta=d)
    y = factor * y_throw * _smooth_sawtooth(dp_dt * time, delta=d)
    return np.stack([x, y])


def raster(
    time,
    x_throw,
    y_throw,
    speed,
    n=((11, 1), (1, 11)),
    d=1e-1,
    rotation_period=np.inf,
    samples_per_period=10000,
    **extra,
):
    """Alternating multi-period raster, with an optional slow rotation."""
    total_duration = 0.0
    period = 0
    times_list, offsets_list = [], []
    direction = np.array([1.0, -1.0])

    while total_duration < np.ptp(time):
        nx, ny = n[period % len(n)]
        phase = np.linspace(0, np.pi, samples_per_period)
        period_offsets = np.stack(
            [x_throw * _smooth_sawtooth(nx * phase, delta=d), y_throw * _smooth_sawtooth(ny * phase, delta=d)],
            axis=-1,
        )
        max_step = np.sqrt(np.sum(np.diff(period_offsets, axis=0) ** 2, axis=-1)).max()
        period_duration = max_step * samples_per_period / speed
        times_list.append(total_duration + np.linspace(0, period_duration, samples_per_period)[:-1])
        offsets_list.append(direction * period_offsets[:-1])
        total_duration += period_duration
        direction = -np.sign(offsets_list[-1][-1])
        period += 1

    t_samples = np.concatenate(times_list)
    o_samples = np.concatenate(offsets_list)
    offsets = sp.interpolate.interp1d(t_samples, o_samples, axis=0, kind="linear")(time - time.min())

    if np.isfinite(rotation_period):
        rot_phase = (2 * np.pi * (time - time[0]) / rotation_period) % (2 * np.pi)
        offsets = np.einsum("ti,tij->tj", offsets, np.swapaxes(rotation_matrix_2d(rot_phase), -2, -1))

    return offsets.T


SCAN_PATTERNS = {
    "stare": {"aliases": [], "generator": stare},
    "daisy": {"aliases": ["daisy_scan"], "generator": daisy},
    "lissajous": {"aliases": ["lissajous_box"], "generator": lissajous},
    "raster": {"aliases": [], "generator": raster},
    "back_and_forth": {"aliases": ["back-and-forth"], "generator": back_and_forth},
    "double_circle": {"aliases": [], "generator": double_circle},
}

all_patterns = list(SCAN_PATTERNS)


def get_scan_pattern_generator(pattern: str):
    for key, entry in SCAN_PATTERNS.items():
        if pattern == key or pattern in entry["aliases"]:
            return entry["generator"]
    raise ValueError(f"Invalid scan pattern '{pattern}'. Valid patterns are {all_patterns}.")


# maria_tpu's public names of the pattern helpers
def daisy_from_phase(phase, a, b, petals, miss_freq):
    return _daisy_from_phase(phase, a, b, petals, miss_freq)


def smooth_sawtooth(p, delta=0.01):
    return _smooth_sawtooth(p, delta)


def generate_scan_offsets(time, pattern: str, **scan_kwargs):
    """(2, n_t) offsets of the pattern named ``pattern`` with raw scan
    keywords (``parse_scan_kwargs``)."""
    return get_scan_pattern_generator(pattern)(np.asarray(time, dtype=float), **parse_scan_kwargs(scan_kwargs))
