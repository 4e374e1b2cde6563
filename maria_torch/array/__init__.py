"""Detector arrays (maria_tpu/array): per-detector focal-plane offsets,
polarization angles and band assignment, as numpy columns instead of a
pandas table."""

from __future__ import annotations

import numpy as np
import scipy as sp

from ..band import get_band
from ..constants import c
from ..io import read_config
from ..utils import compute_diameter

__all__ = ["Array", "get_array", "generate_2d_pattern", "compute_angular_fwhm"]

NGONS = {"triangle": 3, "square": 4, "hexagon": 6, "octagon": 8, "circle": 1024}


def compute_angular_fwhm(fwhm_0, z=np.inf, n=1.0, nu=None):
    """Angular FWHM of a Gaussian beam from an aperture of diameter
    ``fwhm_0`` at distance z (maria_tpu/beam)."""
    w_0 = fwhm_0 / 2
    z_r = np.pi * w_0**2 * n / (c / nu)
    z = np.asarray(z, dtype=float)
    with np.errstate(divide="ignore"):
        inv_z = np.where(np.isinf(z), 0.0, 1.0 / np.where(np.isinf(z), 1.0, z))
    return 2 * w_0 * np.sqrt(inv_z**2 + 1 / z_r**2)


def _triangular_packing(n_col: int, n_row: int) -> np.ndarray:
    col, row = np.meshgrid(np.arange(n_col, dtype=float), np.arange(n_row, dtype=float))
    x = col - n_col // 2 + (n_col + 1) % 2
    y = row - n_row // 2 + (n_row + 1) % 2 - 0.5 * x
    x = x * np.sqrt(3) / 2
    return np.stack([x.ravel(), y.ravel()], axis=-1)


def _scaled_distance(x, y, shape: str):
    r = np.sqrt(x**2 + y**2)
    p = np.arctan2(y, x)
    n_sides = NGONS[shape]
    d = r * np.cos(np.arcsin(np.sin(n_sides / 2 * p)) * 2 / n_sides)
    return d + 1e-3 * (r.max() if r.size else 1.0) * p


def generate_2d_pattern(n: int, max_diameter: float, shape: str = "hexagon") -> np.ndarray:
    """(n, 2) detector offsets: the n points of a triangular packing
    nearest the centre under the shape's metric, scaled to
    ``max_diameter``."""
    if shape not in NGONS:
        raise NotImplementedError(f"array shape '{shape}' (ROADMAP queue 1, item 13)")
    side = int(np.ceil(2.5 * np.sqrt(n))) | 1
    offsets = _triangular_packing(side, side)
    d = _scaled_distance(offsets[:, 0], offsets[:, 1], shape=shape)
    offsets = offsets[np.argsort(d)[:n]]
    diameter = compute_diameter(offsets)
    if diameter > 0:
        offsets = offsets * (max_diameter / diameter)
    return offsets


class Array:
    def __init__(self, name: str, offsets, band_name, gamma, primary_size, bands):
        self.name = name
        self.offsets = np.asarray(offsets, dtype=float)
        self.band_name = np.asarray(band_name)
        self.gamma = np.asarray(gamma, dtype=float)
        self.primary_size = np.asarray(primary_size, dtype=float)
        self.bands = [b for b in bands if b.name in set(self.band_name)]

    @classmethod
    def from_config(cls, config: dict) -> "Array":
        c = dict(config)
        name = c.pop("name")
        known = {"n", "field_of_view", "shape", "bands", "bath_temp", "primary_size", "description",
                 "degrees"}
        if set(c) - known:
            raise NotImplementedError(
                f"array options {sorted(set(c) - known)} (ROADMAP queue 1, item 13)"
            )
        to_rad = np.pi / 180 if c.get("degrees", True) else 1.0
        bands = [get_band(b) for b in c["bands"]]
        offsets = generate_2d_pattern(
            n=int(c["n"]),
            max_diameter=float(c["field_of_view"]) * to_rad,
            shape=c.get("shape", "hexagon"),
        )
        n = len(offsets)
        # one copy of the focal plane per band, sorted by (band, index)
        order = sorted(range(len(bands)), key=lambda i: bands[i].name)
        return cls(
            name=name,
            offsets=np.concatenate([offsets] * len(bands)),
            band_name=np.concatenate([np.full(n, bands[i].name, dtype=object) for i in order]),
            gamma=np.full(n * len(bands), np.nan),
            primary_size=np.full(n * len(bands), float(np.mean(c["primary_size"]))),
            bands=bands,
        )

    @property
    def n(self) -> int:
        return len(self.offsets)

    def take(self, idx) -> "Array":
        idx = np.atleast_1d(idx)
        return Array(self.name, self.offsets[idx], self.band_name[idx], self.gamma[idx],
                     self.primary_size[idx], self.bands)

    @property
    def field_of_view(self) -> float:
        """Diameter of the focal plane, in radians."""
        return compute_diameter(self.offsets)

    def _per_det_band_attr(self, attr: str) -> np.ndarray:
        values = np.zeros(self.n)
        for band in self.bands:
            values[self.band_name == band.name] = getattr(band, attr)
        return values

    @property
    def band_center(self) -> np.ndarray:
        return self._per_det_band_attr("center")

    @property
    def gain_error(self) -> np.ndarray:
        return self._per_det_band_attr("gain_error")

    def mueller(self) -> np.ndarray:
        a = self.gamma
        m = np.stack(
            [
                np.where(np.isnan(a), np.sqrt(2), 1),
                np.where(np.isnan(a), 0, np.cos(2 * a)),
                np.where(np.isnan(a), 0, np.sin(2 * a)),
                np.zeros_like(a),
            ],
            axis=1,
        )
        return 0.5 * m[..., None] * m[..., None, :]

    def stokes_weight(self) -> np.ndarray:
        return self.mueller()[:, 0]

    def angular_fwhm(self, z=np.inf) -> np.ndarray:
        """Beam FWHM in radians at distance z."""
        return compute_angular_fwhm(fwhm_0=self.primary_size, z=z, n=1, nu=self.band_center)

    def physical_fwhm(self, z) -> np.ndarray:
        """Beam FWHM in meters at distance z."""
        return np.asarray(z) * self.angular_fwhm(z)

    def one_detector_from_each_band(self) -> "Array":
        return self.take([int(np.argmax(self.band_name == band.name)) for band in self.bands])

    def outer(self) -> "Array":
        """The detectors on the convex hull of the focal plane."""
        if self.n < 4 or compute_diameter(self.offsets) == 0:
            return self
        return self.take(sp.spatial.ConvexHull(self.offsets).vertices)

    def __repr__(self):
        return f"Array({self.name}: n={self.n}, bands={[b.name for b in self.bands]})"


def get_array(key: str) -> Array:
    if key != "m2":
        raise NotImplementedError(f"array '{key}' (ROADMAP queue 1, item 13)")
    return Array.from_config({"name": key, **read_config("array_m2")})
