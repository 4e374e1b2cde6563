"""Scan plans (maria_tpu/plan): the daisy pattern in the az/el frame.

The pattern is the reference's petal-curve daisy with its
speed-normalizing fixed-point loop, reproduced so the same named plan
gives the same boresight track as maria_tpu.
"""

from __future__ import annotations

import time as _time

import numpy as np

from ..coords import Coordinates, check_frame, offsets_to_phi_theta
from ..io import read_config

__all__ = ["Plan", "get_plan", "daisy"]


def _daisy_from_phase(phase, a, b, petals, miss_freq):
    x = a * np.cos(petals * phase) * np.sin(phase) + b * np.sin(petals * phase) * np.cos(miss_freq * phase)
    y = a * np.cos(petals * phase) * np.cos(phase) + b * np.sin(petals * phase) * np.sin(miss_freq * phase)
    X = np.stack([x, y])
    return (a + b) * X / np.sqrt(np.square(X).sum(axis=0).max())


def daisy(time, x_throw, y_throw, speed, petals=np.sqrt(np.e), miss_factor=0.2, miss_freq=0.1):
    """(2, n_t) daisy offsets in the units of the throws."""
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


def _daisy_kwargs(scan_options: dict) -> dict:
    o = dict(scan_options)
    allowed = {"radius", "x_throw", "y_throw", "speed", "petals", "miss_factor", "miss_freq"}
    if set(o) - allowed:
        raise NotImplementedError(f"daisy options {sorted(set(o) - allowed)} (ROADMAP queue 1, item 13)")
    if "x_throw" not in o:
        o["x_throw"] = o.pop("radius", 1.0)
    o.pop("radius", None)
    o.setdefault("y_throw", o["x_throw"])
    o.setdefault("speed", max(o["x_throw"], o["y_throw"]) / 4)
    return o


class Plan:
    """Time-ordered boresight pointing in az/el."""

    def __init__(self, time, az, el, roll: float = 0.0, description: str = ""):
        self.coords = Coordinates(az, el, time)
        self.roll = roll
        self.description = description

    @classmethod
    def generate(cls, start_time=None, duration: float = 60.0, sample_rate: float = 50.0,
                 frame: str = "ra/dec", degrees: bool = True, scan_center=(0.0, 0.0),
                 scan_pattern: str = "daisy", scan_options: dict = {}, description: str = "",
                 roll: float = 0.0) -> "Plan":
        check_frame(frame)
        if scan_pattern != "daisy":
            raise NotImplementedError(f"scan pattern '{scan_pattern}' (ROADMAP queue 1, item 13)")
        if not isinstance(start_time, (int, float, type(None))):
            raise NotImplementedError("start_time as a date string (ROADMAP queue 1, item 13)")
        t0 = float(_time.time() if start_time is None else start_time)
        time = np.arange(t0, t0 + float(duration), 1 / float(sample_rate))
        scan_offsets = daisy(time - time[0], **_daisy_kwargs(scan_options))
        scan_center = np.asarray(scan_center, dtype=float)
        if degrees:
            scan_offsets = np.radians(scan_offsets)
            scan_center = np.radians(scan_center)
        pt = offsets_to_phi_theta(scan_offsets.T, float(scan_center[0]), float(scan_center[1]))
        return cls(time=time, az=pt[..., 0], el=pt[..., 1], roll=roll, description=description)

    @property
    def time(self):
        return self.coords.t

    @property
    def az(self):
        return self.coords.az

    @property
    def el(self):
        return self.coords.el

    @property
    def sample_rate(self) -> float:
        return 1 / float(np.mean(np.gradient(self.time)))

    def __repr__(self):
        return f"Plan({self.description or 'custom'}: az/el, n={len(self.time)})"


def get_plan(plan_name: str, **kwargs) -> Plan:
    plans = read_config("plans")
    if plan_name not in plans:
        raise NotImplementedError(f"plan '{plan_name}' (ROADMAP queue 1, item 13); supported: {sorted(plans)}")
    return Plan.generate(**{**plans[plan_name], **kwargs})
