"""Radiometric spectra and the K_RJ <-> W kernel of a band
(maria_tpu/functions/radiometry.py and calibration/functions.py
``rayleigh_jeans_temperature_to_power``). A leaf module, so that both
``band`` (the NET_RJ setter) and ``calibration`` take them from one
place. The spectra are elementwise on floats, numpy arrays and tensors."""

from __future__ import annotations

import numpy as np
import torch

from ..constants import c, h, k_B

__all__ = [
    "inverse_planck_spectrum",
    "inverse_rayleigh_jeans_spectrum",
    "planck_spectrum",
    "rayleigh_jeans_kernel",
    "rayleigh_jeans_spectrum",
]


def _xp(*args):
    return torch if any(isinstance(a, torch.Tensor) for a in args) else np


def rayleigh_jeans_spectrum(T_RJ, nu):
    """Spectral radiance (W m^-2 Hz^-1 sr^-1) of a Rayleigh-Jeans source."""
    return 2 * k_B * nu**2 * T_RJ / c**2


def inverse_rayleigh_jeans_spectrum(I_nu, nu):
    """Rayleigh-Jeans temperature of a spectral radiance."""
    return I_nu * c**2 / (2 * k_B * nu**2)


def planck_spectrum(T_b, nu):
    """Spectral radiance of a blackbody at brightness temperature T_b."""
    return 2 * h * nu**3 / (c**2 * _xp(T_b, nu).expm1(h * nu / (k_B * T_b)))


def inverse_planck_spectrum(I_nu, nu):
    """Brightness temperature of a spectral radiance."""
    return (h * nu / k_B) / _xp(I_nu, nu).log1p(2 * h * nu**3 / (I_nu * c**2))


def rayleigh_jeans_kernel(integral, polarized: bool = False):
    """W per K_RJ from the band's ∫ passband e^-opacity dnu [Hz] (a float,
    an array or a tensor): (1/2 if polarized) k_B ∫."""
    return (0.5 if polarized else 1.0) * k_B * integral
