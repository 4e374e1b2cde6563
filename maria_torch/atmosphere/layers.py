"""Atmospheric layer table for the 2-D model (maria_tpu/atmosphere/layers.py),
as a dict of numpy columns instead of a DataFrame."""

from __future__ import annotations

import numpy as np

MIN_RES, MIN_RES_PER_BEAM, MIN_RES_PER_FOV = 2.0, 0.1, 0.02
H_BOUNDARIES_2D = np.array([0.0, 500.0, 1000.0, 1500.0, 2000.0, 3000.0, 5000.0, 8000.0, 12000.0])


def boundary_layer_profile(h, h_0: float = 1e3, alpha: float = 1 / 7):
    return np.exp(-h / h_0) * h**alpha


def generate_layers(instrument, boresight, weather, site, min_height: float = None,
                    pwv_rms_frac: float = 3e-2) -> dict:
    """Layer columns (process_index, h, dh, res, z, weather fields,
    total_water, pwv_rms), parameterized at the minimum scan elevation."""
    min_el = float(np.min(boresight.el))
    sin_el = np.sin(min_el)
    fov = float(instrument.dets.field_of_view)

    def res_func(h):
        h = np.asarray(h, dtype=float)
        z = h / sin_el
        fwhm = instrument.dets.one_detector_from_each_band().physical_fwhm(z[..., None] + 1e-16)
        r2 = MIN_RES_PER_BEAM * np.min(fwhm, axis=-1)
        r3 = MIN_RES_PER_FOV * z * fov
        return np.minimum(1e3, np.maximum.reduce([MIN_RES * np.ones_like(h), r2, r3]))

    h_boundaries = H_BOUNDARIES_2D.copy()
    if min_height:
        h_boundaries = np.unique(np.maximum(h_boundaries, min_height))
    h_centers = (h_boundaries[1:] + h_boundaries[:-1]) / 2

    layers = dict(weather(altitude=site.altitude + h_centers))
    layers["process_index"] = np.arange(len(h_boundaries) - 1)
    layers["h"] = h_centers
    layers["dh"] = np.diff(h_boundaries)
    layers["res"] = res_func(h_centers)
    layers["z"] = h_centers / sin_el

    mid_bounds = np.array([0.0, *(h_centers[:-1] + h_centers[1:]) / 2, 1e5])
    total_water = np.empty(len(h_centers))
    for i, (h1, h2) in enumerate(zip(mid_bounds[:-1], mid_bounds[1:])):
        hh = site.altitude + np.linspace(h1, h2, 256)
        w = np.interp(hh, weather.altitude, weather.absolute_humidity)
        total_water[i] = np.trapezoid(w, x=hh)
    layers["total_water"] = total_water

    rel_var = boundary_layer_profile(h_centers) ** 2
    pwv_var = (weather.pwv * pwv_rms_frac) ** 2 * rel_var / rel_var.sum()
    layers["pwv_rms"] = np.sqrt(pwv_var)
    return layers
