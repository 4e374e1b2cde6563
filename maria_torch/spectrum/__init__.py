"""Atmospheric spectra: the (base_temperature, zenith_pwv, elevation, nu)
emission and opacity grids (maria_tpu/spectrum/__init__.py).

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

from ..io import atomic_save_npz, get_cache_dir
from ..site import get_region
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
    """Emission/opacity lookup grids for one region."""

    def __init__(self, region: str, source: str = SPECTRUM_SOURCE):
        if source != SPECTRUM_SOURCE:
            raise NotImplementedError(
                f"spectrum source '{source}' (ROADMAP queue 1, item 13: other scene sources)"
            )
        self.region = region
        self.altitude = float(get_region(region)["altitude"])
        self.source = source
        self.cache_path = os.path.join(
            get_cache_dir(), "atmosphere", "spectra", *source.split("/"), f"{region}.npz"
        )
        grids = _load_valid(self.cache_path)
        if grids is None:
            logger.info(f"Generating the synthetic atmospheric spectrum for '{region}' (cached).")
            full = synth.generate_spectrum_grids(base_altitude_m=self.altitude)
            grids = {k: full[k] for k in _KEYS}
            atomic_save_npz(self.cache_path, **grids)

        self.side_base_temperature = grids["side_base_temperature_K"].astype(float)
        self.side_zenith_pwv = grids["side_zenith_pwv_mm"].astype(float)
        self.side_elevation = grids["side_elevation_rad"].astype(float)
        self.side_nu = grids["side_nu_Hz"].astype(float)
        self._emission = grids["rayleigh_jeans_temperature_K"]
        self._opacity = grids["opacity_nepers"]

    @property
    def points(self):
        return (
            self.side_base_temperature,
            self.side_zenith_pwv,
            self.side_elevation,
            self.side_nu,
        )

    def __repr__(self):
        return f"AtmosphericSpectrum(region={self.region})"
