"""Constraint-based observation planner (maria_tpu/plan/planner.py).

Scans a time horizon for windows where a target satisfies elevation,
azimuth, local-hour and sun-distance constraints, and emits a PlanList
of scans covering the feasible chunks.
"""

from __future__ import annotations

import logging
import time as _time

import numpy as np

from ..coords import Coordinates, ephemeris as eph
from ..errors import NoSuitablePlansError
from ..site import get_site
from .plan import Plan, PlanList, parse_time

logger = logging.getLogger("maria_torch")

CONSTRAINT_KEYS = ["az", "el", "hour", "min_sun_distance"]
SIDEREAL_DAY_SECONDS = 86164.0905


def sun_ra_dec(t):
    """Low-precision apparent solar RA/dec (radians) from the same solar
    ephemeris used for aberration."""
    T = eph.julian_centuries_tt(np.asarray(t, dtype=float))
    deg = np.pi / 180
    L0 = (280.46646 + 36000.76983 * T) * deg
    M = (357.52911 + 35999.05029 * T) * deg
    C = ((1.914602 - 0.004817 * T) * np.sin(M) + 0.019993 * np.sin(2 * M)) * deg
    lam = L0 + C
    epsilon = eph.mean_obliquity(T)
    ra = np.arctan2(np.cos(epsilon) * np.sin(lam), np.cos(lam)) % (2 * np.pi)
    dec = np.arcsin(np.sin(epsilon) * np.sin(lam))
    return ra, dec


class Planner:
    def __init__(
        self,
        target,
        site,
        frame: str = "ra/dec",
        constraints: dict = None,
        start_time=None,
    ):
        """``target`` is (phi, theta) in degrees in ``frame``, or a
        ProjectionMap, whose centre and frame are used. Constraints may
        include el_range and az_range (degrees), local_hour_range, and
        min_sun_distance (degrees); the aliases "el", "az" and "hour"
        are accepted."""
        from ..map import ProjectionMap

        self.site = get_site(site) if isinstance(site, str) else site
        self.start_time = start_time  # default horizon start for generate_plans
        if isinstance(target, ProjectionMap):
            frame = target.frame
            target = np.degrees(target.center)
        self.target = np.radians(np.asarray(target, dtype=float))
        self.frame = frame
        aliases = {"el": "el_range", "az": "az_range", "hour": "local_hour_range"}
        constraints = {aliases.get(k, k): v for k, v in (constraints or {}).items()}
        self.constraints = {
            "el_range": (30.0, 85.0),
            "min_sun_distance": 20.0,
            **constraints,
        }

    def _target_azel(self, t):
        coords = Coordinates(
            phi=np.full(len(t), self.target[0]),
            theta=np.full(len(t), self.target[1]),
            t=t,
            earth_location=self.site.earth_location,
            frame=self.frame,
        )
        return coords.az, coords.el

    def feasible(self, t: np.ndarray) -> np.ndarray:
        az, el = self._target_azel(t)
        ok = np.ones(len(t), dtype=bool)

        el_lo, el_hi = np.radians(self.constraints["el_range"])
        ok &= (el >= el_lo) & (el <= el_hi)

        if "az_range" in self.constraints:
            az_lo, az_hi = np.radians(self.constraints["az_range"])
            ok &= (az >= az_lo) & (az <= az_hi)

        if "local_hour_range" in self.constraints:
            lo, hi = self.constraints["local_hour_range"]
            hours = (t / 3600 + float(self.site.longitude) / 15) % 24
            ok &= ((hours - lo) % 24) <= ((hi - lo) % 24)

        min_sun = np.radians(self.constraints.get("min_sun_distance", 0.0))
        if min_sun > 0:
            sra, sdec = sun_ra_dec(t)
            if self.frame == "ra/dec":
                tra, tdec = self.target
            else:
                c = Coordinates(
                    phi=[self.target[0]], theta=[self.target[1]],
                    t=[float(t[0])], earth_location=self.site.earth_location, frame=self.frame,
                )
                tra, tdec = float(c.ra[0]), float(c.dec[0])
            cos_d = np.sin(sdec) * np.sin(tdec) + np.cos(sdec) * np.cos(tdec) * np.cos(sra - tra)
            ok &= np.arccos(np.clip(cos_d, -1, 1)) >= min_sun

        return ok

    def generate_plan(self, total_duration: float = 600.0, **kwargs) -> "Plan":
        """One feasible Plan of ``total_duration`` seconds; chunking is
        disabled."""
        plans = self.generate_plans(
            total_duration=total_duration, chunk_duration=total_duration, **kwargs
        )
        got = plans[0].duration
        if got < 0.95 * total_duration:
            logger.warning(
                f"Longest feasible window is {got:.0f} s of the requested "
                f"{total_duration:.0f} s; consider generate_plans for a chunked PlanList."
            )
        return plans[0]

    def generate_plans(
        self,
        start_time=None,
        horizon_days: float = 7.0,
        total_duration: float = 3600.0,
        chunk_duration: float = None,
        max_chunk_duration: float = None,
        sample_rate: float = 20.0,
        scan_pattern: str = "daisy",
        scan_options: dict = {},
        check_every: float = 60.0,
    ) -> PlanList:
        # max_chunk_duration is an alias of chunk_duration
        chunk_duration = chunk_duration if chunk_duration is not None else (max_chunk_duration or 600.0)
        if start_time is None:
            start_time = self.start_time
        if isinstance(start_time, str):
            start_time = parse_time(start_time)
        t0 = float(start_time if start_time is not None else _time.time())
        t_check = np.arange(t0, t0 + horizon_days * 86400, check_every)
        ok = self.feasible(t_check)

        plans = []
        accumulated = 0.0
        i = 0
        while i < len(ok) and accumulated < total_duration:
            if not ok[i]:
                i += 1
                continue
            # extend a feasible chunk
            j = i
            while j < len(ok) and ok[j] and (t_check[j] - t_check[i]) < chunk_duration:
                j += 1
            remaining = total_duration - accumulated
            duration = min(t_check[min(j, len(ok) - 1)] - t_check[i], chunk_duration, remaining)
            if duration >= min(chunk_duration, 60.0, total_duration):
                plans.append(
                    Plan.generate(
                        site=self.site,
                        start_time=t_check[i],
                        duration=min(duration, total_duration - accumulated),
                        sample_rate=sample_rate,
                        frame=self.frame,
                        degrees=True,
                        scan_center=np.degrees(self.target),
                        scan_pattern=scan_pattern,
                        scan_options=scan_options,
                    )
                )
                accumulated += plans[-1].duration
            i = j + 1

        if not plans:
            raise NoSuitablePlansError()
        logger.info(f"Planned {len(plans)} scans totalling {accumulated:.0f} s.")
        return PlanList(plans)
