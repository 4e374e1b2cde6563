"""The K_RJ <-> W kernel of a band (maria_tpu/calibration/functions.py
``rayleigh_jeans_temperature_to_power``): P = f k_B T ∫ passband(nu)
e^-opacity dnu, with f = 1/2 for polarized detectors. A leaf module, so
that both ``band`` (the NET_RJ setter) and ``calibration`` (``TOD.to``)
take it from one place."""

from __future__ import annotations

from .constants import k_B

__all__ = ["rayleigh_jeans_kernel"]


def rayleigh_jeans_kernel(integral, polarized: bool = False):
    """W per K_RJ from the band's ∫ passband e^-opacity dnu [Hz] (a float,
    an array or a tensor): (1/2 if polarized) k_B ∫."""
    return (0.5 if polarized else 1.0) * k_B * integral
