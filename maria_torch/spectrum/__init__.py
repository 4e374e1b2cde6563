"""Atmospheric spectra: the (base_temperature, zenith_pwv, elevation, nu)
emission, opacity and excess-path grids (maria_tpu/spectrum/__init__.py),
and their lookup at any samples: ``emission``, ``opacity``,
``path_delay`` and ``transmission`` interpolate the 4-D grid in float32
on the device of the coordinate tensors they are given (``device``, the
card by default, when all are arrays or numbers).

The grids are generated by ``spectrum.synth`` and cached as .npz under
the package cache directory. A write goes through a private temporary
file and an atomic rename, and a cache hit is validated on load and
regenerated if it is unreadable or malformed.
"""

from __future__ import annotations

import logging
import os
import zipfile

import numpy as np
import torch

from ..io import atomic_save_npz, get_cache_dir
from ..ops.interp import RegularGridInterpolator
from ..site import get_region
from ..units import Quantity
from . import synth

logger = logging.getLogger("maria_torch")

SPECTRUM_SOURCE = "synthetic/v1"
_KEYS = (
    "side_base_temperature_K",
    "side_zenith_pwv_mm",
    "side_elevation_rad",
    "side_nu_Hz",
    "rayleigh_jeans_temperature_K",
    "opacity_nepers",
    "excess_path_m",
)


def _load_valid(path: str):
    """The cached grids, or None when the file is missing or fails
    validation (unreadable, a key missing, shapes inconsistent, values
    not finite)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as f:
            grids = {k: f[k] for k in _KEYS}
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None
    shape = tuple(len(grids[k]) for k in _KEYS[:4])
    for k in _KEYS[4:]:
        if grids[k].shape != shape or not np.isfinite(grids[k]).all():
            return None
    return grids


class AtmosphericSpectrum:
    """Emission, opacity and path-delay lookup grids for one region. The
    grids are made for the region's altitude; ``altitude`` is kept as the
    site's, as maria_tpu does, and ``refresh_cache`` makes the cached
    grids anew."""

    def __init__(self, region: str, altitude: float = None, source: str = SPECTRUM_SOURCE,
                 refresh_cache: bool = False):
        if source != SPECTRUM_SOURCE:
            raise NotImplementedError(
                f"spectrum source '{source}' (ROADMAP queue 1, item 13: other scene sources)"
            )
        self.region = region
        region_altitude = float(get_region(region)["altitude"])
        self.altitude = altitude or region_altitude
        self.source = source
        self.cache_path = os.path.join(
            get_cache_dir(), "atmosphere", "spectra", *source.split("/"), f"{region}.npz"
        )
        grids = None if refresh_cache else _load_valid(self.cache_path)
        if grids is None:
            logger.info(f"Generating the synthetic atmospheric spectrum for '{region}' (cached).")
            full = synth.generate_spectrum_grids(base_altitude_m=region_altitude)
            grids = {k: full[k] for k in _KEYS}
            atomic_save_npz(self.cache_path, **grids)

        self.side_base_temperature = grids["side_base_temperature_K"].astype(float)
        self.side_zenith_pwv = grids["side_zenith_pwv_mm"].astype(float)
        self.side_elevation = grids["side_elevation_rad"].astype(float)
        self.side_nu = grids["side_nu_Hz"].astype(float)
        self._emission = grids["rayleigh_jeans_temperature_K"]
        self._opacity = grids["opacity_nepers"]
        self._path_delay = grids["excess_path_m"]
        self._interpolators = {}

    @property
    def points(self):
        return (
            self.side_base_temperature,
            self.side_zenith_pwv,
            self.side_elevation,
            self.side_nu,
        )

    @property
    def nu_min(self):
        return Quantity(self.side_nu.min(), "Hz")

    @property
    def nu_max(self):
        return Quantity(self.side_nu.max(), "Hz")

    def _interp(self, quantity, nu, pwv=None, base_temperature=None, elevation=None, device=None):
        """The grid of ``quantity`` at (base_temperature, pwv, elevation,
        nu): the grid's median temperature and pwv and 45 deg elevation
        where not given."""
        pwv = pwv if pwv is not None else np.median(self.side_zenith_pwv)
        if base_temperature is None:
            base_temperature = np.median(self.side_base_temperature)
        elevation = elevation if elevation is not None else np.radians(45.0)
        if quantity not in self._interpolators:
            self._interpolators[quantity] = RegularGridInterpolator(self.points, getattr(self, f"_{quantity}"))
        return self._interpolators[quantity]((base_temperature, pwv, elevation, nu), device=device)

    def emission(self, nu, pwv=None, base_temperature=None, elevation=None, device=None):
        """Rayleigh-Jeans brightness temperature of the atmosphere [K]."""
        return self._interp("emission", nu, pwv, base_temperature, elevation, device)

    def opacity(self, nu, pwv=None, base_temperature=None, elevation=None, device=None):
        """Opacity along the line of sight [nepers]."""
        return self._interp("opacity", nu, pwv, base_temperature, elevation, device)

    def path_delay(self, nu, pwv=None, base_temperature=None, elevation=None, device=None):
        """Excess optical path along the line of sight [m]."""
        return self._interp("path_delay", nu, pwv, base_temperature, elevation, device)

    def transmission(self, nu, pwv=None, base_temperature=None, elevation=None, device=None):
        """exp(-opacity)."""
        return torch.exp(-self.opacity(nu, pwv, base_temperature, elevation, device))

    def __repr__(self):
        return f"AtmosphericSpectrum(region={self.region})"
