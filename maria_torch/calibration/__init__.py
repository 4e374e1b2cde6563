"""The power <-> Rayleigh-Jeans temperature calibration of one band
(the subset of maria_tpu/calibration that ``TOD.to`` needs).

With an atmosphere the band integral ∫ passband e^-opacity dnu depends
on the detector's elevation, so the factor is per sample: the host
interpolates the (base_temperature, pwv, elevation) grid at the
observation's temperature and pwv, and the device interpolates the
remaining elevation axis, multilinear like maria_tpu's
RegularGridInterpolator.
"""

from __future__ import annotations

import numpy as np
import torch

from ..band import axis_transform, fractional_index, interp_grid_np
from ..constants import k_B

__all__ = ["transmission_integral", "UNITS"]

# unit -> (quantity, factor to the canonical unit: W or K)
UNITS = {"W": ("power", 1.0), "pW": ("power", 1e-12), "K_RJ": ("rayleigh_jeans_temperature", 1.0)}


def transmission_integral(band, spectrum, zenith_pwv: float, base_temperature: float, elevation):
    """∫ passband(nu) e^-opacity dnu [Hz] at each elevation (a tensor)."""
    grid = band.transmission_integral_grid(spectrum)  # (T, pwv, el), float64
    el_side = spectrum.side_elevation
    # (T, pwv) at the observation's scalars; the el axis stays trailing
    table = np.asarray(interp_grid_np(spectrum.points[:2], grid, (base_temperature, zenith_pwv)))
    n = len(el_side)
    tab = torch.as_tensor(table.astype(np.float32), device=elevation.device)
    f = torch.clamp(fractional_index(axis_transform(el_side), elevation, torch), 0.0, n - 1.0)
    i = torch.clamp(torch.floor(f).to(torch.int64), 0, n - 2)
    w = f - i
    return tab[i] * (1 - w) + tab[i + 1] * w


def conversion_factor(in_units: str, out_units: str, band, polarized: bool, spectrum,
                      zenith_pwv: float, base_temperature: float, elevation):
    """Per-sample factor taking a field in ``in_units`` to ``out_units``."""
    for u in (in_units, out_units):
        if u not in UNITS:
            raise NotImplementedError(f"units '{u}' (ROADMAP queue 1, item 13: the calibration graph)")
    (q_in, s_in), (q_out, s_out) = UNITS[in_units], UNITS[out_units]
    if q_in == q_out:
        return s_in / s_out
    kernel = (0.5 if polarized else 1.0) * k_B * transmission_integral(
        band, spectrum, zenith_pwv, base_temperature, elevation
    )
    if q_in == "power":  # W -> K_RJ
        return (s_in / s_out) / kernel
    return (s_in / s_out) * kernel  # K_RJ -> W
