"""A single observation: instrument x plan x site (maria_tpu/sim/observation.py).

The pointing stays factorized: the boresight track in the plan's frame
(host float64), static detector offsets in the az/el frame, and the
frame-rotation angle q(t) between az/el and ra/dec. Per-detector
coordinates are made on the device, never on the host.
"""

from __future__ import annotations

import logging

import numpy as np

from ..atmosphere import Atmosphere
from ..coords import Coordinates, phi_theta_to_offsets
from ..utils import rotation_matrix_2d

logger = logging.getLogger("maria_torch")

MIN_ELEVATION_WARN = 20.0  # deg
MIN_ELEVATION_ERROR = 10.0  # deg


class Observation:
    def __init__(self, instrument, plan, site, atmosphere=None, atmosphere_kwargs: dict = {}):
        self.instrument = instrument
        self.plan = plan
        self.site = site
        # the boresight in the plan's frame, tied to the site
        self.boresight = Coordinates(
            getattr(plan, plan.frame.phi_name), getattr(plan, plan.frame.theta_name), plan.time,
            earth_location=site.earth_location, frame=plan.frame.name,
        )

        el_deg = np.degrees(self.boresight.el)
        if el_deg.min() < MIN_ELEVATION_ERROR:
            raise ValueError(
                f"Observation dips below {MIN_ELEVATION_ERROR} deg elevation (min={el_deg.min():.1f} deg)."
            )
        if el_deg.min() < MIN_ELEVATION_WARN:
            logger.warning(f"Observation dips below {MIN_ELEVATION_WARN} deg elevation.")

        t = np.asarray(plan.time, dtype=float)
        dt = np.gradient(t)
        az_vel = np.gradient(np.degrees(np.unwrap(self.boresight.az))) / dt
        el_vel = np.gradient(np.degrees(self.boresight.el)) / dt
        for name, value, limit in (
            ("az velocity", np.abs(az_vel).max(), instrument.az_vel_limit),
            ("el velocity", np.abs(el_vel).max(), instrument.el_vel_limit),
            ("az acceleration", np.abs(np.gradient(az_vel) / dt).max(), instrument.az_acc_limit),
            ("el acceleration", np.abs(np.gradient(el_vel) / dt).max(), instrument.el_acc_limit),
        ):
            if limit is not None and value > float(limit):
                logger.warning(f"The maximum {name} of the plan ({value:.1f}) exceeds the instrument's limit ({limit}).")

        offsets = instrument.dets.offsets
        if plan.roll:
            offsets = offsets @ rotation_matrix_2d(plan.roll).T
        self.offsets = offsets

        # frame-rotation angle q(t): tangent-plane offsets in az/el map to
        # offsets rotated by q in ra/dec (the frame transform is a rigid
        # rotation). A probe a small step up in elevation lands at angle q
        # from the dec direction: offsets_radec = R(q) @ offsets_azel
        probe = self.boresight.broadcast(np.array([[0.0, 1e-5]]), frame="az/el")
        probe_offsets = phi_theta_to_offsets(
            np.stack([probe.ra, probe.dec], axis=-1), self.boresight.ra, self.boresight.dec
        )[0]  # (n_t, 2)
        self.q = np.arctan2(-probe_offsets[:, 0], probe_offsets[:, 1])

        self.t = plan.time
        self.sample_rate = float(plan.sample_rate)

        if atmosphere is not None:
            self.atmosphere = atmosphere if isinstance(atmosphere, Atmosphere) else Atmosphere(
                model=atmosphere,
                timestamp=float(np.mean(plan.time)),
                region=site.region,
                altitude=float(site.altitude),
                **atmosphere_kwargs,
            )

    @property
    def shape(self):
        return (self.instrument.dets.n, len(self.t))

    @property
    def n_samples(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def coords(self):
        """The detectors' (n_det, n_t) Coordinates in az/el, made on the
        host when asked for (the simulation never asks)."""
        return self.boresight.broadcast(self.offsets, frame="az/el")

    def __repr__(self):
        return f"Observation(instrument={self.instrument.name}, site={self.site.name}, shape={self.shape})"
