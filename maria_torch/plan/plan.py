"""Scan plans (maria_tpu/plan/plan.py): time-ordered boresight tracks in
az/el, ra/dec or galactic, made from a scan pattern of ``patterns``
around a scan centre."""

from __future__ import annotations

import time as _time
from datetime import datetime, timezone

import numpy as np

from ..coords import Coordinates, EarthLocation, offsets_to_phi_theta
from ..site import get_site
from ..units import Quantity
from .patterns import get_scan_pattern_generator, parse_scan_kwargs

__all__ = ["Plan", "PlanList", "parse_time"]


def parse_time(t) -> float:
    """Unix seconds of a number, an ISO date string (UTC unless it says
    otherwise) or a datetime; now for None."""
    if t is None:
        return _time.time()
    if isinstance(t, (int, float)):
        return float(t)
    if isinstance(t, str):
        dt = datetime.fromisoformat(t.replace("Z", "+00:00"))
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=timezone.utc)
        return dt.timestamp()
    if isinstance(t, datetime):
        return t.timestamp()
    raise ValueError(f"Cannot parse time {t!r}.")


class Plan:
    """Time-ordered boresight pointing (phi, theta) in ``frame``, radians."""

    @classmethod
    def generate(cls, site=None, description: str = "", start_time=None, duration: float = 60.0,
                 sample_rate: float = 50.0, frame: str = "ra/dec", degrees: bool = True, jitter: float = 0.0,
                 roll: float = 0.0, scan_center=(0.0, 0.0), scan_pattern: str = "daisy", scan_options: dict = {}) -> "Plan":
        t0 = parse_time(start_time)
        time = np.arange(t0, t0 + float(duration), 1 / float(sample_rate))
        scan_offsets = get_scan_pattern_generator(scan_pattern)(time - time[0], **parse_scan_kwargs(scan_options))
        if np.isnan(scan_offsets).any():
            raise RuntimeError(f"Scan pattern '{scan_pattern}' produced NaNs.")
        scan_center = np.asarray(scan_center, dtype=float)
        if degrees:
            scan_offsets = np.radians(scan_offsets)
            scan_center = np.radians(scan_center)
        if jitter:
            jitter_rng = np.random.default_rng(np.uint64(int(t0 * 1e3)))
            scan_offsets = scan_offsets + np.radians(jitter) * jitter_rng.standard_normal(scan_offsets.shape)
        pt = offsets_to_phi_theta(scan_offsets.T, float(scan_center[0]), float(scan_center[1]))
        return cls(time=time, phi=pt[..., 0], theta=pt[..., 1], roll=roll, frame=frame, site=site,
                   description=description)

    def __init__(self, time, phi, theta, roll: float = 0.0, frame: str = "ra/dec", site=None,
                 latitude: float = None, longitude: float = None, altitude: float = 0.0, description: str = ""):
        self.site = get_site(site) if isinstance(site, str) else site
        if self.site is not None:
            earth_location = self.site.earth_location
        elif latitude is not None and longitude is not None:
            earth_location = EarthLocation(lat_deg=latitude, lon_deg=longitude, height_m=altitude)
        else:
            earth_location = EarthLocation()
        self.coords = Coordinates(phi, theta, time, earth_location=earth_location, frame=frame)
        self.roll = roll
        self.description = description

    @property
    def time(self):
        return self.coords.t

    @property
    def n(self) -> int:
        return len(self.time)

    @property
    def frame(self):
        return self.coords.frame

    @property
    def earth_location(self):
        return self.coords.earth_location

    @property
    def sample_rate(self) -> float:
        return 1 / float(np.mean(np.gradient(self.time)))

    @property
    def duration(self) -> float:
        return float(np.ptp(self.time))

    @property
    def start_time(self) -> float:
        return float(self.time[0])

    @property
    def end_time(self) -> float:
        return float(self.time[-1])

    def __getattr__(self, attr):
        coords = self.__dict__.get("coords")
        if coords is not None and attr in ("az", "el", "ra", "dec", "l", "b"):
            return getattr(coords, attr)
        raise AttributeError(attr)

    @property
    def max_vel(self):
        """The largest scan speed on the sky, a Quantity in rad/s."""
        offsets = self.coords.offsets(frame=self.frame)
        speed = np.sqrt(np.square(np.gradient(offsets, axis=0)).sum(axis=1)) / np.gradient(self.time)
        return Quantity(speed.max(), "rad/s")

    def offsets(self, frame=None, center=None):
        return self.coords.offsets(frame=frame or self.frame, center=center)

    def __add__(self, other: "Plan") -> "Plan":
        """The two plans one after the other, in this plan's frame."""
        if other.start_time < self.end_time:
            raise ValueError("Plans overlap in time.")
        return Plan(
            time=np.concatenate([self.time, other.time]),
            phi=np.concatenate([getattr(self, self.frame.phi_name), getattr(other, self.frame.phi_name)]),
            theta=np.concatenate([getattr(self, self.frame.theta_name), getattr(other, self.frame.theta_name)]),
            roll=self.roll, frame=self.frame.name, site=self.site,
        )

    def plot(self, frames=None, ax_size: float = 4.0, **kwargs):
        """The boresight's track in a panel a frame (az/el and ra/dec by
        default; "galactic", "glon/glat"), tangent-plane offsets in
        degrees (needs matplotlib). Returns the axes."""
        import matplotlib.pyplot as plt

        frames = ["az/el", "ra/dec"] if frames is None else [frames] if isinstance(frames, str) else list(frames)
        alias = {"glon/glat": "galactic", "gal": "galactic"}
        _, axes = plt.subplots(1, len(frames), figsize=(ax_size * len(frames) * 1.15, ax_size),
                               constrained_layout=True, squeeze=False)
        for ax, frame in zip(axes[0], frames):
            offs = np.degrees(np.asarray(self.coords.offsets(frame=alias.get(frame, frame))))
            ax.plot(offs[..., 0], offs[..., 1], lw=0.5, **kwargs)
            ax.set_xlabel(r"$\Delta x$ [deg]")
            ax.set_ylabel(r"$\Delta y$ [deg]")
            ax.set_title(frame)
            ax.set_aspect("equal", adjustable="datalim")
        return axes[0]

    def plot_hits(self, instrument=None, x_bins: int = 100, y_bins: int = 100):
        """A 2-D histogram of the boresight's offsets in the plan's frame
        (needs matplotlib). Returns the axes."""
        import matplotlib.pyplot as plt

        offsets = np.degrees(self.offsets())
        _, ax = plt.subplots(1, 1)
        ax.hist2d(offsets[..., 0].ravel(), offsets[..., 1].ravel(), bins=(x_bins, y_bins))
        ax.set_xlabel("dx [deg]")
        ax.set_ylabel("dy [deg]")
        return ax

    def __repr__(self):
        cphi, ctheta = np.degrees(self.coords.center())
        return (f"Plan({self.description or 'custom'}: {self.frame.name}, centre ({cphi:.2f}, {ctheta:.2f}) deg, "
                f"{self.duration:.0f} s at {self.sample_rate:.0f} Hz, n={self.n})")


class PlanList:
    """Plans in a list, with the grouping of those that follow closely."""

    def __init__(self, plans):
        if isinstance(plans, PlanList):
            plans = plans.plans
        if isinstance(plans, Plan):
            plans = [plans]
        self.plans = list(plans)

    def __iter__(self):
        return iter(self.plans)

    def __len__(self):
        return len(self.plans)

    def __getitem__(self, i):
        return self.plans[i]

    @property
    def start_time(self):
        return min(p.start_time for p in self.plans)

    @property
    def end_time(self):
        return max(p.end_time for p in self.plans)

    def plan_groups(self, max_gap: float = 60.0):
        """Indices of plans separated by less than ``max_gap`` seconds."""
        order = np.argsort([p.start_time for p in self.plans])
        groups = [[int(order[0])]] if len(order) else []
        for i in order[1:]:
            prev = self.plans[groups[-1][-1]]
            if self.plans[int(i)].start_time - prev.end_time < max_gap:
                groups[-1].append(int(i))
            else:
                groups.append([int(i)])
        return groups

    def group_plans(self, max_gap: float = 60.0) -> "PlanList":
        merged = []
        for group in self.plan_groups(max_gap=max_gap):
            plan = self.plans[group[0]]
            for i in group[1:]:
                plan = plan + self.plans[i]
            merged.append(plan)
        return PlanList(merged)

    def __repr__(self):
        return f"PlanList({len(self.plans)} plans)"
