"""Atmospheric layer table (maria_tpu/atmosphere/layers.py), as a dict of
numpy columns instead of a DataFrame."""

from __future__ import annotations

import numpy as np

MIN_RES = {"2d": 2.0, "3d": 15.0}
MIN_RES_PER_BEAM = {"2d": 0.1, "3d": 0.5}
MIN_RES_PER_FOV = {"2d": 0.02, "3d": 0.1}
H_BOUNDARIES_2D = np.array([0.0, 500.0, 1000.0, 1500.0, 2000.0, 3000.0, 5000.0, 8000.0, 12000.0])


def boundary_layer_profile(h, h_0: float = 1e3, alpha: float = 1 / 7):
    return np.exp(-h / h_0) * h**alpha


def generate_layers(instrument, boresight, weather, site, mode: str = "2d", max_height: float = 5e3,
                    min_res: float = None, min_res_per_beam: float = None, min_res_per_fov: float = None,
                    pwv_rms_frac: float = 3e-2, n_layers: int = 12, min_height: float = None) -> dict:
    """Layer columns (process_index, h, dh, res, z, weather fields,
    total_water, pwv_rms), parameterized at the minimum scan elevation.

    "2d": fixed slabs, one process each. "3d": one process, ``n_layers``
    log-spaced slabs from one resolution above the base up to
    ``max_height`` (the Fourier 3-D model carries the vertical
    correlation in its cross-spectra, so the layers only discretize the
    pwv-variance integral). A layer's resolution is the largest of
    ``min_res`` m, ``min_res_per_beam`` beams and ``min_res_per_fov``
    fields of view at its distance (the mode's defaults where not given),
    at most 1 km."""
    if mode not in MIN_RES:
        raise ValueError(f"Invalid atmosphere model '{mode}' (supported: '2d', '3d').")
    min_res = min_res or MIN_RES[mode]
    min_res_per_beam = min_res_per_beam or MIN_RES_PER_BEAM[mode]
    min_res_per_fov = min_res_per_fov or MIN_RES_PER_FOV[mode]
    min_el = float(np.min(boresight.el))
    sin_el = np.sin(min_el)
    fov = float(instrument.dets.field_of_view)

    def res_func(h):
        h = np.asarray(h, dtype=float)
        z = h / sin_el
        fwhm = instrument.dets.one_detector_from_each_band().physical_fwhm(z[..., None] + 1e-16)
        r2 = min_res_per_beam * np.min(fwhm, axis=-1)
        r3 = min_res_per_fov * z * fov
        return np.minimum(1e3, np.maximum.reduce([min_res * np.ones_like(h), r2, r3]))

    if mode == "2d":
        h_boundaries = H_BOUNDARIES_2D.copy()
        if min_height:
            h_boundaries = np.unique(np.maximum(h_boundaries, min_height))
        process_index = np.arange(len(h_boundaries) - 1)
    else:
        base = min_height or 0.0
        # the first slab starts one resolution above the base, so no slab
        # has zero thickness
        h0 = base + float(res_func(base))
        h_boundaries = np.concatenate([[base], np.geomspace(h0, max_height, n_layers)])
        process_index = np.zeros(len(h_boundaries) - 1, dtype=int)
    h_centers = (h_boundaries[1:] + h_boundaries[:-1]) / 2

    layers = dict(weather(altitude=site.altitude + h_centers))
    layers["process_index"] = process_index
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
