"""The edges of the calibration graph (maria_tpu/calibration/functions.py).

Every edge takes and returns values in canonical units: W (power), K
(temperatures), Jy (flux densities), rad and sr (angles and areas), Hz.
Where the arguments are floats or host arrays an edge computes in
float64 on the host; a tensor argument keeps its device.

The band-integrated edges with an atmosphere (``spectrum``) depend on
the detector's elevation. Given ``elevation`` as a tensor, the host
reduces the spectrum's (base_temperature, pwv, elevation) grid to an
elevation table at the observation's base temperature and pwv, combines
the band powers it needs on that table in float64 (dP/dT_CMB is the
difference of two powers 1e-5 K apart), and only then interpolates the
elevation axis on the device. Interpolation is linear in the table, so
the difference of the interpolations is the interpolation of the
difference, without float32 cancellation; maria_tpu takes the difference
after a float32 interpolation (ROADMAP queue 3, hazard 9).
"""

from __future__ import annotations

import numpy as np
import torch

from ..band import axis_transform, fractional_index, interp_grid_np
from ..constants import T_CMB, h, k_B
from ..errors import ShapeError
from ..functions.radiometry import (
    inverse_planck_spectrum,
    inverse_rayleigh_jeans_spectrum,
    planck_spectrum,
    rayleigh_jeans_kernel,
    rayleigh_jeans_spectrum,
)

JY = 1e-26  # W m^-2 Hz^-1


def identity(x, **kwargs):
    return x


def _min(x) -> float:
    return float(x.min()) if isinstance(x, torch.Tensor) else float(np.min(x))


# -- the elevation tables of a band -----------------------------------------------------------------


def elevation_interp(spectrum, table, elevation):
    """``table`` (n_el, ...) float64 on the spectrum's elevation side,
    interpolated linearly at the ``elevation`` tensor on its device with
    maria_tpu's axis transform, clamped to the side: elevation.shape +
    table.shape[1:], float32."""
    el_side = spectrum.side_elevation
    n = len(el_side)
    tab = torch.as_tensor(np.asarray(table, dtype=np.float32), device=elevation.device)
    f = torch.clamp(fractional_index(axis_transform(el_side), elevation, torch), 0.0, n - 1.0)
    i = torch.clamp(torch.floor(f).to(torch.int64), 0, n - 2)
    w = (f - i).reshape(*f.shape, *([1] * (tab.ndim - 1)))
    return tab[i] * (1 - w) + tab[i + 1] * w


def transmission_integral(band, spectrum, zenith_pwv: float, base_temperature: float, elevation):
    """∫ passband(nu) e^-opacity dnu [Hz] at each elevation (a tensor):
    the (T, pwv) axes of the band's float64 grid interpolated on the
    host at the observation's scalars, the elevation axis on the device."""
    grid = band.transmission_integral_grid(spectrum)  # (T, pwv, el), float64
    table = np.asarray(interp_grid_np(spectrum.points[:2], grid, (base_temperature, zenith_pwv)))
    return elevation_interp(spectrum, table, elevation)


def _band_integral(band, spectrum=None, zenith_pwv=None, base_temperature=None, elevation=None, **kwargs):
    if spectrum is None:
        return band.compute_transmission_integral(spectrum=None)
    if isinstance(elevation, torch.Tensor):
        return transmission_integral(band, spectrum, zenith_pwv, base_temperature, elevation)
    return band.compute_transmission_integral(
        spectrum=spectrum, zenith_pwv=zenith_pwv, base_temperature=base_temperature, elevation=elevation
    )


def band_powers(T_b, band, polarized=False, spectrum=None, zenith_pwv=None, base_temperature=None,
                elevation=None, combine=None, **kwargs):
    """The band powers [W] of blackbodies at the temperatures ``T_b``
    (n_T,), on a trailing axis, put through ``combine`` (a function of
    that axis, such as a difference) on the host in float64. Without a
    spectrum through the passband alone; with one through the
    atmosphere's transmission at ``elevation`` too: a float64 array of
    elevation.shape + the combination's shape, or float32 on the device
    of an elevation tensor, the combination taken on the host's
    elevation table before the interpolation."""
    T_b = np.atleast_1d(np.asarray(T_b, dtype=np.float64))
    combine = combine or (lambda P: P)
    scale = (0.5 if polarized else 1.0) * k_B
    if spectrum is None:
        nu = band.nu[:, None]
        T_RJ = inverse_rayleigh_jeans_spectrum(planck_spectrum(T_b[None], nu), nu)  # (n_nu, n_T)
        return combine(scale * np.trapezoid(T_RJ * band.passband(nu), x=band.nu, axis=-2))
    nu = spectrum.side_nu[:, None]
    weighted = inverse_rayleigh_jeans_spectrum(planck_spectrum(T_b[None], nu), nu) * band.passband(nu)  # (n_nu, n_T)
    trans = np.exp(-spectrum._opacity)  # (T_base, pwv, el, nu)
    if isinstance(elevation, torch.Tensor):
        # every step is linear in e^-opacity: reduce its (T_base, pwv) axes first
        table = np.asarray(interp_grid_np(spectrum.points[:2], trans, (base_temperature, zenith_pwv)))  # (el, nu)
        table = scale * np.trapezoid(table[..., None] * weighted, x=spectrum.side_nu, axis=-2)  # (el, n_T)
        return elevation_interp(spectrum, combine(table), elevation)
    grid = np.trapezoid(trans[..., None] * weighted, x=spectrum.side_nu, axis=-2)  # (T, pwv, el, n_T)
    return combine(scale * np.asarray(
        interp_grid_np(spectrum.points[:3], grid, (base_temperature, zenith_pwv, elevation))))


# -- edges without a band ----------------------------------------------------------------------------


def _compton_f(nu):
    x = h * nu / (k_B * T_CMB)
    return x * (np.exp(x) + 1) / (np.exp(x) - 1) - 4


def cmb_temperature_anisotropy_to_compton_y(dT_CMB, nu, **kwargs):
    return dT_CMB / (_compton_f(nu) * T_CMB)


def compton_y_to_cmb_temperature_anisotropy(y, nu, **kwargs):
    return y * _compton_f(nu) * T_CMB


def cmb_temperature_anisotropy_to_brightness_temperature(dT_CMB, **kwargs):
    return dT_CMB + T_CMB


def brightness_temperature_to_cmb_temperature_anisotropy(T_b, **kwargs):
    return T_b - T_CMB


def rayleigh_jeans_temperature_to_brightness_temperature(T_RJ, nu, **kwargs):
    return inverse_planck_spectrum(rayleigh_jeans_spectrum(T_RJ, nu), nu)


def brightness_temperature_to_rayleigh_jeans_temperature(T_b, nu, **kwargs):
    return inverse_rayleigh_jeans_spectrum(planck_spectrum(T_b, nu), nu)


def _drj_dcmb(nu, eps=1e-5):
    hi = inverse_rayleigh_jeans_spectrum(planck_spectrum(T_CMB + eps, nu), nu)
    lo = inverse_rayleigh_jeans_spectrum(planck_spectrum(T_CMB - eps, nu), nu)
    return (hi - lo) / (2 * eps)


def rayleigh_jeans_temperature_to_cmb_temperature_anisotropy(T_RJ, nu, **kwargs):
    """Linearized about the CMB monopole: dT_CMB = T_RJ / (dT_RJ/dT_CMB)."""
    return T_RJ / _drj_dcmb(nu)


def cmb_temperature_anisotropy_to_rayleigh_jeans_temperature(dT_CMB, nu, **kwargs):
    return dT_CMB * _drj_dcmb(nu)


# -- band-integrated power ---------------------------------------------------------------------------


def rayleigh_jeans_temperature_to_power(T_RJ, band, polarized=False, spectrum=None, **kwargs):
    return rayleigh_jeans_kernel(_band_integral(band, spectrum=spectrum, **kwargs), polarized) * T_RJ


def power_to_rayleigh_jeans_temperature(P, band, polarized=False, spectrum=None, **kwargs):
    return P / rayleigh_jeans_kernel(_band_integral(band, spectrum=spectrum, **kwargs), polarized)


def brightness_temperature_to_power_explicit(T_b, band, polarized=False, spectrum=None, **kwargs):
    """The passband integral of the Planck spectrum at each T_b (1-D):
    the band power [W], on a trailing axis of len(T_b)."""
    T_b = np.atleast_1d(T_b)
    if T_b.ndim > 1:
        raise ShapeError("'T_b' must be one-dimensional")
    return band_powers(T_b, band, polarized=polarized, spectrum=spectrum, **kwargs)


def brightness_temperature_to_power(T_b, band, polarized=False, spectrum=None, eps=1e-4, **kwargs):
    """maria_tpu's two-point line about min(T_b): t P(T_hi) + (1 - t)
    P(T_lo), t = (T_b - T_lo) / eps, with T_lo, T_hi = min(T_b) -+ eps/2.
    At an elevation tensor it is P(T_lo) + (T_b - T_lo) (P(T_hi) -
    P(T_lo)) / eps, the slope differenced on the host's elevation table
    before the interpolation."""
    T_min = _min(T_b)
    T_lo, T_hi = T_min - eps / 2, T_min + eps / 2
    if isinstance(kwargs.get("elevation"), torch.Tensor):
        P = band_powers([T_lo, T_hi], band, polarized=polarized, spectrum=spectrum,
                        combine=lambda P: np.stack([P[..., 0], (P[..., 1] - P[..., 0]) / eps], axis=-1), **kwargs)
        return P[..., 0] + (T_b - T_lo) * P[..., 1]
    P = band_powers([T_lo, T_hi], band, polarized=polarized, spectrum=spectrum, **kwargs)
    t = (T_b - T_lo) / eps
    return t * P[..., 1] + (1 - t) * P[..., 0]


def dP_dT_CMB(band, polarized=False, spectrum=None, eps=1e-4, **kwargs):
    """Detector power per unit CMB temperature anisotropy [W/K_CMB]: the
    difference of the band powers at T_CMB -+ eps/2, over eps."""
    return band_powers([T_CMB - eps / 2, T_CMB + eps / 2], band, polarized=polarized, spectrum=spectrum,
                       combine=lambda P: (P[..., 1] - P[..., 0]) / eps, **kwargs)


def cmb_temperature_anisotropy_to_power(dT_CMB, band, polarized=False, spectrum=None, eps=1e-5, **kwargs):
    return dT_CMB * dP_dT_CMB(band, polarized=polarized, spectrum=spectrum, eps=eps, **kwargs)


def power_to_cmb_temperature_anisotropy(P, band, polarized=False, spectrum=None, eps=1e-5, **kwargs):
    return P / dP_dT_CMB(band, polarized=polarized, spectrum=spectrum, eps=eps, **kwargs)


def power_to_brightness_temperature(P, **kwargs):
    raise NotImplementedError("power -> brightness temperature is not invertible in closed form")


def T_RJ_per_T_CMB(band, eps=1e-3, **kwargs):
    """Band-averaged colour correction K_RJ/K_CMB without an atmosphere."""
    test_T_b = T_CMB + np.array([[-eps / 2], [+eps / 2]])
    T_RJ = inverse_rayleigh_jeans_spectrum(planck_spectrum(test_T_b, band.nu), band.nu)
    P = k_B * np.trapezoid(T_RJ * band.passband(band.nu), x=band.nu, axis=-1)
    return power_to_rayleigh_jeans_temperature((P[1] - P[0]) / eps, spectrum=None, band=band)


# -- flux densities ----------------------------------------------------------------------------------


def rayleigh_jeans_temperature_to_spectral_flux_density_per_pixel(T_RJ, nu, pixel_area, **kwargs):
    return rayleigh_jeans_spectrum(T_RJ, nu) * pixel_area / JY


def spectral_flux_density_per_pixel_to_rayleigh_jeans_temperature(E, nu, pixel_area, **kwargs):
    return inverse_rayleigh_jeans_spectrum(E * JY / pixel_area, nu)


def rayleigh_jeans_temperature_to_spectral_flux_density_per_beam(T_RJ, nu, beam_area, **kwargs):
    return rayleigh_jeans_spectrum(T_RJ, nu) * beam_area / JY


def spectral_flux_density_per_beam_to_rayleigh_jeans_temperature(E, nu, beam_area, **kwargs):
    return inverse_rayleigh_jeans_spectrum(E * JY / beam_area, nu)


def spectral_flux_density_per_pixel_to_spectral_radiance(E, nu, pixel_area, **kwargs):
    return E / (pixel_area if pixel_area is not None else 1.0)


def spectral_radiance_to_spectral_flux_density_per_pixel(I, nu, pixel_area, **kwargs):  # noqa: E741
    return I * pixel_area


def spectral_flux_density_per_pixel_to_spectral_flux_density_per_beam(E, beam_area, pixel_area, **kwargs):
    return E * beam_area / pixel_area


def spectral_flux_density_per_beam_to_spectral_flux_density_per_pixel(E, beam_area, pixel_area, **kwargs):
    return E * pixel_area / beam_area
