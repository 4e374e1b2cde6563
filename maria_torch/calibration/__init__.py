"""The calibration graph (maria_tpu/calibration/__init__.py): a directed
graph whose nodes are physical quantities and whose edges are the
radiometric maps of ``functions``, each with the keyword arguments it
needs; a breadth-first search takes the first chain whose keywords are
all given, so the order of ``conversions`` decides the route.

``Calibration("pW -> K_CMB", band=..., spectrum=..., elevation=...)(x)``
runs the chain. Scalars and host arrays are converted in float64 on the
host; a tensor ``x`` or ``elevation`` keeps its device (the
band-integrated edges interpolate their elevation tables there, see
``functions``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import IncompatibleQuantityError, MissingCalibrationKwargsError
from ..units import parse_units
from . import functions as F
from .functions import transmission_integral  # noqa: F401

__all__ = [
    "Calibration", "KWARGS_UNITS", "QUANTITY_UNITS", "VALID_CALIBRATION_KWARGS", "compute_quantities_chain",
    "conversions", "parse_calibration_signature", "transmission_integral",
]

# canonical unit for each physical quantity
QUANTITY_UNITS = {
    "power": "W",
    "rayleigh_jeans_temperature": "K_RJ",
    "cmb_temperature_anisotropy": "K_CMB",
    "brightness_temperature": "K_b",
    "spectral_flux_density_per_pixel": "Jy/pixel",
    "spectral_flux_density_per_beam": "Jy/beam",
    "spectral_radiance": "Jy/sr",
    "compton_y": "y",
}

conversions = {
    "brightness_temperature": {
        "power": {"f": F.brightness_temperature_to_power, "linear": False, "required_kwargs": ["band"]},
        "cmb_temperature_anisotropy": {"f": F.brightness_temperature_to_cmb_temperature_anisotropy, "linear": False},
        "rayleigh_jeans_temperature": {
            "f": F.brightness_temperature_to_rayleigh_jeans_temperature,
            "linear": False,
            "required_kwargs": ["nu"],
        },
    },
    "power": {
        "rayleigh_jeans_temperature": {
            "f": F.power_to_rayleigh_jeans_temperature, "linear": True, "required_kwargs": ["band"],
        },
        "cmb_temperature_anisotropy": {
            "f": F.power_to_cmb_temperature_anisotropy, "linear": True, "required_kwargs": ["band"],
        },
        "brightness_temperature": {
            "f": F.power_to_brightness_temperature, "linear": False, "required_kwargs": ["band"],
        },
    },
    "rayleigh_jeans_temperature": {
        "power": {"f": F.rayleigh_jeans_temperature_to_power, "linear": True, "required_kwargs": ["band"]},
        "cmb_temperature_anisotropy": {
            "f": F.rayleigh_jeans_temperature_to_cmb_temperature_anisotropy,
            "linear": False,
            "required_kwargs": ["nu"],
        },
        "brightness_temperature": {
            "f": F.rayleigh_jeans_temperature_to_brightness_temperature,
            "linear": False,
            "required_kwargs": ["nu"],
        },
        "spectral_flux_density_per_pixel": {
            "f": F.rayleigh_jeans_temperature_to_spectral_flux_density_per_pixel,
            "linear": True,
            "required_kwargs": ["nu", "pixel_area"],
        },
        "spectral_flux_density_per_beam": {
            "f": F.rayleigh_jeans_temperature_to_spectral_flux_density_per_beam,
            "linear": True,
            "required_kwargs": ["nu", "beam_area"],
        },
    },
    "cmb_temperature_anisotropy": {
        "power": {"f": F.cmb_temperature_anisotropy_to_power, "linear": True, "required_kwargs": ["band"]},
        "brightness_temperature": {"f": F.cmb_temperature_anisotropy_to_brightness_temperature, "linear": False},
        "rayleigh_jeans_temperature": {
            "f": F.cmb_temperature_anisotropy_to_rayleigh_jeans_temperature,
            "linear": False,
            "required_kwargs": ["nu"],
        },
        "compton_y": {"f": F.cmb_temperature_anisotropy_to_compton_y, "linear": False, "required_kwargs": ["nu"]},
    },
    "spectral_flux_density_per_pixel": {
        "rayleigh_jeans_temperature": {
            "f": F.spectral_flux_density_per_pixel_to_rayleigh_jeans_temperature,
            "linear": False,
            "required_kwargs": ["nu", "pixel_area"],
        },
        "spectral_radiance": {
            "f": F.spectral_flux_density_per_pixel_to_spectral_radiance,
            "linear": True,
            "required_kwargs": ["nu"],
        },
        "spectral_flux_density_per_beam": {
            "f": F.spectral_flux_density_per_pixel_to_spectral_flux_density_per_beam,
            "linear": True,
            "required_kwargs": ["beam_area", "pixel_area"],
        },
    },
    "spectral_flux_density_per_beam": {
        "rayleigh_jeans_temperature": {
            "f": F.spectral_flux_density_per_beam_to_rayleigh_jeans_temperature,
            "linear": False,
            "required_kwargs": ["nu", "beam_area"],
        },
        "spectral_flux_density_per_pixel": {
            "f": F.spectral_flux_density_per_beam_to_spectral_flux_density_per_pixel,
            "linear": True,
            "required_kwargs": ["beam_area", "pixel_area"],
        },
    },
    "spectral_radiance": {
        "spectral_flux_density_per_pixel": {
            "f": F.spectral_radiance_to_spectral_flux_density_per_pixel,
            "linear": True,
            "required_kwargs": ["nu", "pixel_area"],
        },
    },
    "compton_y": {
        "cmb_temperature_anisotropy": {
            "f": F.compton_y_to_cmb_temperature_anisotropy, "linear": False, "required_kwargs": ["nu"],
        },
    },
}

VALID_CALIBRATION_KWARGS = [
    "nu", "polarized", "pixel_area", "beam_area", "band",
    "spectrum", "zenith_pwv", "base_temperature", "elevation",
]


def compute_quantities_chain(start_quantity, end_quantity, max_steps: int = 6, kwargs: dict = {},
                             enforce_kwargs: bool = True):
    """BFS over the conversion graph; the first chain whose required kwargs
    are all present wins, else the missing kwargs of the first chain
    found raise."""
    if start_quantity == end_quantity:
        return [start_quantity]
    shortest_missing = None
    walks = [([start_quantity], set())]
    for _ in range(max_steps):
        extended = []
        for walk, walk_kwargs in walks:
            for quantity, config in conversions.get(walk[-1], {}).items():
                required = set(config.get("required_kwargs", [])) | walk_kwargs
                chain = [*walk, quantity]
                if quantity == end_quantity:
                    missing = [k for k in required if kwargs.get(k) is None] if enforce_kwargs else []
                    if not missing:
                        return chain
                    if shortest_missing is None:
                        shortest_missing = missing
                if quantity not in walk:
                    extended.append((chain, required))
        walks = extended
    if shortest_missing is not None:
        raise MissingCalibrationKwargsError(shortest_missing)
    raise IncompatibleQuantityError(
        f"Cannot convert from quantity '{start_quantity}' to quantity '{end_quantity}'.",
    )


class Calibration:
    """cal = Calibration("pW -> K_RJ", band=..., spectrum=...); y = cal(x)

    ``linear()`` says whether every edge of the chain is linear, so that
    the conversion is one factor, ``cal(1.0)`` (a tensor of the
    elevation's shape where the factor varies by sample)."""

    def __init__(self, signature: str, spectrum=None, **kwargs):
        if "->" not in signature:
            raise ValueError("Calibration must have signature 'units1 -> units2'.")
        in_units, out_units = (s.strip() for s in signature.split("->"))
        self.signature = signature
        self.in_unit = parse_units(in_units)
        self.out_unit = parse_units(out_units)
        if self.in_unit.quantity is None or self.out_unit.quantity is None:
            raise ValueError(f"'{signature}' does not map between known physical quantities.")
        for key in kwargs:
            if key not in VALID_CALIBRATION_KWARGS:
                raise ValueError(f"Invalid calibration kwarg '{key}'.")
        self.kwargs = {"spectrum": spectrum, **kwargs}

    @property
    def in_quantity(self):
        return self.in_unit.quantity

    @property
    def out_quantity(self):
        return self.out_unit.quantity

    def linear(self) -> bool:
        chain = compute_quantities_chain(self.in_quantity, self.out_quantity, enforce_kwargs=False)
        return all(conversions[q1][q2]["linear"] for q1, q2 in zip(chain[:-1], chain[1:]))

    def __call__(self, x, **kwargs):
        call_kwargs = {**self.kwargs, **kwargs}
        chain = compute_quantities_chain(self.in_quantity, self.out_quantity, kwargs=call_kwargs)
        canonical_in = parse_units(QUANTITY_UNITS[self.in_quantity])
        canonical_out = parse_units(QUANTITY_UNITS[self.out_quantity])
        y = (x if isinstance(x, torch.Tensor) else np.asarray(x, dtype=np.float64)) * self.in_unit.to(canonical_in)
        for q1, q2 in zip(chain[:-1], chain[1:]):
            y = conversions[q1][q2]["f"](y, **call_kwargs)
        return y * canonical_out.to(self.out_unit)

    def __repr__(self):
        return f"Calibration('{self.signature}')"


def parse_calibration_signature(s: str) -> dict:
    """Split 'units1 -> units2' into parsed in/out units."""
    if s.count("->") == 1:
        items = [u.strip() for u in s.split("->")]
        if len(items) == 2:
            return {"in": parse_units(items[0]), "out": parse_units(items[1])}
    raise ValueError("Calibration must have signature 'units1 -> units2'.")


# canonical units of every calibration kwarg
KWARGS_UNITS = {
    "nu": "Hz",
    "pixel_area": "sr",
    "beam_area": "sr",
    "zenith_pwv": "mm",
    "base_temperature": "K",
    "elevation": "rad",
}
