"""The map base (maria_tpu/map/base.py): units and their conversion.

A map's units name one of ``VALID_MAP_QUANTITIES``: the temperatures,
the flux densities, the spectral radiance, compton y, and (for the
mappers' maps of TODs in pW) power. ``to`` converts through the
calibration graph, one call per frequency channel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..units import parse_units

__all__ = ["Map", "VALID_MAP_QUANTITIES", "check_map_units"]

VALID_MAP_QUANTITIES = [
    "rayleigh_jeans_temperature",
    "cmb_temperature_anisotropy",
    "brightness_temperature",
    "spectral_flux_density_per_pixel",
    "spectral_flux_density_per_beam",
    "spectral_radiance",
    "compton_y",
    "power",
]


def check_map_units(units: str) -> str:
    u = parse_units(units)
    if u.quantity not in VALID_MAP_QUANTITIES:
        raise ValueError(f"Invalid map units '{units}' (quantity '{u.quantity}').")
    return units


class Map:
    """What the map classes share: ``data`` and ``weight`` tensors of
    shape (stokes, nu, t, *map dims), ``nu`` in Hz and ``units``."""

    def _calibration_kwargs(self) -> dict:
        return {}

    def _replace(self, **kwargs):
        raise NotImplementedError

    def to(self, units: str, band=None):
        """The map in ``units``, converted per frequency channel with the
        channel's ``nu``, the pixel area and ``band``. The weights are
        inverse variances, so they scale by 1/slope^2 of the conversion:
        the factor of a linear chain, else the finite-difference slope at
        each pixel (maria_tpu/map/base.py:173-203)."""
        new, old = parse_units(units), parse_units(self.units)
        if new.dims == old.dims and new.factor == old.factor:
            return self
        from ..calibration import Calibration

        weight = self.weight
        new_data, new_weight = [], []
        for i, nu in enumerate(self.nu):
            cal = Calibration(f"{self.units} -> {units}", nu=float(nu), band=band, **self._calibration_kwargs())
            if cal.linear():
                factor = float(np.asarray(cal(1.0)))
                new_data.append(self.data[:, i] * factor)
                new_weight.append(None if weight is None else weight[:, i] / factor**2)
                continue
            # a non-linear chain on the host in float64, back onto the map's device
            x = self.data[:, i].double().cpu().numpy()
            y = np.asarray(cal(x))
            new_data.append(torch.as_tensor(y, dtype=torch.float32, device=self.data.device))
            if weight is not None:
                eps = 1e-6 * max(float(np.abs(x).max()), 1e-30)
                slope = (np.asarray(cal(x + eps)) - y) / eps
                w = weight[:, i].double().cpu().numpy() / (slope**2 + 1e-300)
                new_weight.append(torch.as_tensor(w, dtype=torch.float32, device=weight.device))
        return self._replace(
            data=torch.stack(new_data, dim=1),
            weight=None if weight is None else torch.stack(new_weight, dim=1),
            units=units,
        )
