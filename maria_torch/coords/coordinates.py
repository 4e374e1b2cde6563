"""Time-tagged pointing with lazy frame transforms
(maria_tpu/coords/coordinates.py): a ``Coordinates`` holds angles in one
native frame (az/el, ra/dec or galactic) and computes the others on
demand, on the host in float64."""

from __future__ import annotations

import functools
import time as _time

import numpy as np
import scipy as sp

from . import ephemeris as eph
from .earth import DEFAULT_EARTH_LOCATION, EarthLocation
from .frame import FRAMES, Frame
from .transforms import (
    get_center_phi_theta,
    offsets_to_phi_theta,
    phi_theta_to_offsets,
    phi_theta_to_xyz,
    xyz_to_phi_theta,
)

__all__ = ["Coordinates"]


def _normalize(v):
    return v / np.sqrt(np.sum(v**2, axis=-1, keepdims=True))


class Coordinates:
    """Pointing of shape (..., n_t) in radians, host float64: time is the
    last axis. ``frame`` names the frame of ``phi`` and ``theta``; the
    attributes az/el, ra/dec and l/b give the pointing in every frame."""

    def __init__(self, phi=0.0, theta=0.0, t=None, earth_location: EarthLocation = DEFAULT_EARTH_LOCATION,
                 frame: str = "az/el", dtype=np.float64):
        self.earth_location = earth_location
        self.frame = Frame(frame)
        self.dtype = dtype
        t = _time.time() if t is None else t
        phi, theta, t = np.broadcast_arrays(
            np.asarray(phi, dtype=dtype), np.asarray(theta, dtype=dtype), np.asarray(t, dtype=np.float64)
        )
        self._phi, self._theta = phi, theta
        self.t = t[(0,) * (t.ndim - 1)] if t.ndim > 1 else np.atleast_1d(t)
        if t.ndim > 1 and np.ptp(t.reshape(-1, t.shape[-1]), axis=0).max() > 0:
            raise ValueError("Only the last axis can vary in time.")
        self._frames = {self.frame.name: (phi, theta)}  # computed frames: name -> (phi, theta)
        self.centers = {}

    # -- the transforms ------------------------------------------------------------
    @functools.cached_property
    def _icrs_to_tod(self):
        return eph.icrs_to_tod_matrix(self.t)

    @functools.cached_property
    def _enu_to_tod(self):
        return eph.enu_to_tod_matrix(self.t, self.earth_location.lat, self.earth_location.lon)

    @functools.cached_property
    def _beta(self):
        return eph.earth_velocity_over_c(self.t)

    def _azel_to_icrs(self, az, el):
        # ENU unit vector: x = East, y = North, z = Up; az from North through East
        cos_el = np.cos(el)
        v_enu = np.stack([np.sin(az) * cos_el, np.cos(az) * cos_el, np.sin(el)], axis=-1)
        v_tod = np.einsum("tij,...tj->...ti", self._enu_to_tod, v_enu)
        v_icrs_apparent = np.einsum("tji,...tj->...ti", self._icrs_to_tod, v_tod)
        return xyz_to_phi_theta(_normalize(v_icrs_apparent - self._beta))

    def _icrs_to_azel(self, ra, dec):
        v_apparent = _normalize(phi_theta_to_xyz(ra, dec) + self._beta)
        v_tod = np.einsum("tij,...tj->...ti", self._icrs_to_tod, v_apparent)
        v_enu = np.einsum("tji,...tj->...ti", self._enu_to_tod, v_tod)
        az = np.arctan2(v_enu[..., 0], v_enu[..., 1]) % (2 * np.pi)
        el = np.arcsin(np.clip(v_enu[..., 2], -1, 1))
        return az, el

    def _compute_frame(self, name: str):
        if name in self._frames:
            return self._frames[name]
        native = self.frame.name
        if native == "az/el":
            if "ra/dec" not in self._frames:
                self._frames["ra/dec"] = self._azel_to_icrs(self._phi, self._theta)
            if name == "galactic":
                v_gal = np.einsum("ij,...j->...i", eph.ICRS_TO_GAL, phi_theta_to_xyz(*self._frames["ra/dec"]))
                self._frames["galactic"] = xyz_to_phi_theta(v_gal)
        elif native == "ra/dec":
            if name == "az/el":
                self._frames["az/el"] = self._icrs_to_azel(self._phi, self._theta)
            else:
                v_gal = np.einsum("ij,...j->...i", eph.ICRS_TO_GAL, phi_theta_to_xyz(self._phi, self._theta))
                self._frames["galactic"] = xyz_to_phi_theta(v_gal)
        else:  # galactic
            v_icrs = np.einsum("ji,...j->...i", eph.ICRS_TO_GAL, phi_theta_to_xyz(self._phi, self._theta))
            self._frames["ra/dec"] = xyz_to_phi_theta(v_icrs)
            if name == "az/el":
                self._frames["az/el"] = self._icrs_to_azel(*self._frames["ra/dec"])
        return self._frames[name]

    def __getattr__(self, attr):
        for name, config in FRAMES.items():
            if attr in (config["phi_name"], config["theta_name"]):
                phi, theta = self._compute_frame(name)
                return phi if attr == config["phi_name"] else theta
        raise AttributeError(attr)

    # -- structure -----------------------------------------------------------------
    @property
    def shape(self):
        return self._phi.shape

    @property
    def ndim(self):
        return self._phi.ndim

    def __getitem__(self, idx):
        """A subset along the leading (non-time) axes."""
        sub = Coordinates.__new__(Coordinates)
        sub.earth_location, sub.frame, sub.t, sub.dtype = self.earth_location, self.frame, self.t, self.dtype
        sub._phi, sub._theta = self._phi[idx], self._theta[idx]
        sub._frames = {name: (p[idx], th[idx]) for name, (p, th) in self._frames.items()}
        sub.centers = {}
        for cached in ("_icrs_to_tod", "_enu_to_tod", "_beta"):
            if cached in self.__dict__:
                sub.__dict__[cached] = self.__dict__[cached]
        return sub

    @property
    def timestep(self):
        return float(np.mean(np.gradient(self.t))) if len(self.t) > 1 else None

    def downsample(self, timestep: float = None, factor: int = None) -> "Coordinates":
        if timestep is None and factor is None:
            raise ValueError("You must supply either 'timestep' or 'factor'.")
        timestep = timestep or factor * self.timestep
        ds_t = np.arange(self.t.min(), self.t.max(), timestep)
        interp = sp.interpolate.interp1d(
            self.t, np.stack([self._phi, self._theta]), axis=-1, bounds_error=False, fill_value="extrapolate"
        )(ds_t)
        return Coordinates(interp[0], interp[1], ds_t, earth_location=self.earth_location, frame=self.frame.name,
                           dtype=self.dtype)

    def boresight(self) -> "Coordinates":
        """The spherical mean over every axis but time: (n_t,)."""
        cphi, ctheta = get_center_phi_theta(self._phi, self._theta, keep_dims=(-1,))
        return Coordinates(cphi, ctheta, self.t, earth_location=self.earth_location, frame=self.frame.name,
                           dtype=self.dtype)

    def broadcast(self, offsets, frame: str = "az/el") -> "Coordinates":
        """Boresight (n_t,) x detector offsets (n_det, 2) -> (n_det, n_t)."""
        frame = Frame(frame)
        pt = offsets_to_phi_theta(
            np.asarray(offsets)[..., None, :], getattr(self, frame.phi_name), getattr(self, frame.theta_name)
        )
        return Coordinates(pt[..., 0], pt[..., 1], self.t, earth_location=self.earth_location, frame=frame.name,
                           dtype=self.dtype)

    def project(self, z, frame: str = "az/el"):
        """Where each line of sight meets the horizontal plane at height
        z above the observer: (..., n_t, 3) of (East, North, Up) metres."""
        az, el = self.az, self.el
        cot_el = 1 / np.tan(el)
        scale = np.asarray(z) - 0.0
        return np.stack([scale * np.sin(az) * cot_el, scale * np.cos(az) * cot_el, scale * np.ones_like(az)], axis=-1)

    def center(self, frame=None):
        """(phi, theta) of the spherical mean in ``frame`` (the native
        one by default), in radians."""
        frame = Frame(frame or self.frame)
        if frame.name not in self.centers:
            self.centers[frame.name] = get_center_phi_theta(
                getattr(self, frame.phi_name), getattr(self, frame.theta_name)
            )
        return self.centers[frame.name]

    def offsets(self, frame=None, center=None):
        """(..., n_t, 2) tangent-plane offsets in ``frame`` from ``center``
        (radians; the pointing's own centre by default)."""
        frame = Frame(frame or self.frame)
        cphi, ctheta = self.center(frame=frame) if center is None else center
        pt = np.stack([getattr(self, frame.phi_name), getattr(self, frame.theta_name)], axis=-1)
        return phi_theta_to_offsets(pt, float(cphi), float(ctheta))

    def hull(self, frame, center=None, max_samples: int = 20000):
        """The convex hull's vertices (n, 2) of the pointing's offsets in
        ``frame`` (of a seeded subsample past ``max_samples`` points)."""
        offsets = self.offsets(frame=frame, center=center).reshape(-1, 2)
        if len(offsets) > max_samples:
            offsets = offsets[np.random.default_rng(0).choice(len(offsets), size=max_samples)]
        return offsets[sp.spatial.ConvexHull(offsets).vertices]

    def __repr__(self):
        phi, theta = np.degrees(self._phi), np.degrees(self._theta)
        return (
            f"Coordinates(shape={self.shape}, frame='{self.frame.name}', "
            f"{self.frame.phi_name}=[{phi.min():.3f}, {phi.max():.3f}] deg, "
            f"{self.frame.theta_name}=[{theta.min():.3f}, {theta.max():.3f}] deg, "
            f"duration={self.t.max() - self.t.min():.1f} s)"
        )
