"""Time-tagged pointing in the az/el frame (maria_tpu/coords).

The port supports the az/el frame only: the frame rotation to ra/dec
needs the ephemeris (ROADMAP queue 1, item 13).
"""

from __future__ import annotations

import numpy as np
import scipy as sp

from .transforms import get_center_phi_theta, offsets_to_phi_theta, phi_theta_to_offsets

__all__ = ["Coordinates", "check_frame", "offsets_to_phi_theta", "phi_theta_to_offsets"]

_AZEL_ALIASES = ("az/el", "altaz", "alt_az", "az_el")


def check_frame(frame: str) -> str:
    if frame in _AZEL_ALIASES:
        return "az/el"
    raise NotImplementedError(
        f"frame '{frame}': only az/el is ported; ra/dec and galactic need the ephemeris "
        "and the frame-rotation angle q (ROADMAP queue 1, item 13)"
    )


class Coordinates:
    """Boresight az/el (radians, host float64) with time as the last axis."""

    def __init__(self, az, el, t, earth_location=None):
        self.az, self.el, t = np.broadcast_arrays(
            np.asarray(az, dtype=np.float64), np.asarray(el, dtype=np.float64),
            np.asarray(t, dtype=np.float64),
        )
        self.t = np.atleast_1d(t)
        self.earth_location = earth_location

    @property
    def shape(self):
        return self.az.shape

    @property
    def timestep(self):
        return float(np.mean(np.gradient(self.t))) if len(self.t) > 1 else None

    def downsample(self, timestep: float) -> "Coordinates":
        ds_t = np.arange(self.t.min(), self.t.max(), timestep)
        interp = sp.interpolate.interp1d(
            self.t, np.stack([self.az, self.el]), axis=-1, bounds_error=False, fill_value="extrapolate"
        )(ds_t)
        return Coordinates(interp[0], interp[1], ds_t, earth_location=self.earth_location)

    def center(self, frame: str = "az/el"):
        """(az, el) of the spherical mean, in radians."""
        check_frame(frame)
        return get_center_phi_theta(self.az, self.el)

    def offsets(self, frame: str = "az/el", center=None):
        check_frame(frame)
        cphi, ctheta = self.center() if center is None else center
        return phi_theta_to_offsets(np.stack([self.az, self.el], axis=-1), cphi, ctheta)

    def __repr__(self):
        return f"Coordinates(shape={self.shape}, frame='az/el')"
