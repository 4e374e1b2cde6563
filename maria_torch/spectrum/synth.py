"""Offline synthetic atmospheric spectra (numpy port of
maria_tpu/spectrum/synth.py; the same model and constants).

The reference ships 4-D emission/opacity/path-delay grids over
(base_temperature, zenith_pwv, elevation, nu) precomputed with the `am`
radiative-transfer code and fetched from the maria-data repository
(reference: maria/spectrum/atmosphere.py:26-57). With no network, this
module *generates* grids of the same shape from a compact millimeter-wave
absorption model:

  - H2O rotational lines (van Vleck-Weisskopf shapes, pressure-broadened)
    plus empirical foreign/self continuum,
  - the O2 60 GHz complex, 118.75 GHz and submm O2 lines, plus a dry
    (collision-induced) continuum,
  - layered plane-parallel radiative transfer through a standard
    atmosphere anchored to the site altitude and surface temperature.

Line frequencies are exact; strengths and continuum coefficients are
calibrated to reproduce typical published zenith opacities in the mm
windows (e.g. tau_225 ≈ 0.04/mm pwv at 5 km). This is a simulator-grade
approximation, not a spectroscopy product.
"""

from __future__ import annotations

import logging

import numpy as np

from ..constants import c, g, h, k_B

logger = logging.getLogger("maria_torch")

GHz = 1e9

# --- H2O lines: (frequency GHz, relative strength, width GHz at 1 atm, T exponent)
H2O_LINES = np.array(
    [
        # nu0,   S_rel,   w,    x
        [22.235, 0.0011, 2.85, 2.1],
        [183.310, 1.00, 2.93, 0.65],
        [325.153, 0.84, 3.00, 0.65],
        [380.197, 3.45, 3.15, 0.60],
        [448.001, 3.10, 2.80, 0.60],
        [474.689, 0.45, 2.50, 0.60],
        # strengths of the submm lines fold in the super-VVW far-wing excess
        # so the 650/850 GHz windows land on published opacities
        [556.936, 182.0, 3.20, 0.60],
        [620.701, 6.00, 2.90, 0.60],
        [752.033, 98.0, 3.00, 0.60],
        [916.172, 6.00, 2.90, 0.60],
        [970.315, 15.6, 2.80, 0.60],
        [987.927, 45.0, 2.90, 0.60],
        [1097.365, 12.0, 2.90, 0.60],
        [1113.800, 84.0, 2.90, 0.60],
        [1163.014, 36.0, 2.90, 0.60],
    ]
)
# overall scale of the H2O line absorption, Np/m per (g/m^3) at unit shape;
# calibrated against published zenith opacities at a 5 km site:
# tau(183 center) ≈ 15/mm, tau_225 ≈ 0.05/mm, tau_345 ≈ 0.2/mm,
# tau_650 ≈ 1.4/mm, tau_850 ≈ 0.9/mm
H2O_LINE_SCALE = 0.04

# wet continuum: alpha = (CF * rho * p_dry + CS * rho^2) * (nu/300GHz)^2 * theta^x
H2O_CONT_FOREIGN = 2.9e-5  # Np/m per (g/m^3 * atm) at 300 GHz
H2O_CONT_SELF = 2.0e-5  # Np/m per (g/m^3)^2 at 300 GHz

# --- O2 lines (60 GHz complex sampled by its strongest members + isolated lines)
O2_LINES = np.array(
    [
        # nu0, S_rel, w
        [51.503, 0.12, 0.85],
        [52.542, 0.22, 0.85],
        [53.596, 0.36, 0.85],
        [54.671, 0.52, 0.85],
        [55.784, 0.68, 0.85],
        [56.363, 0.40, 0.85],
        [57.612, 0.82, 0.85],
        [58.446, 0.90, 0.85],
        [59.164, 0.95, 0.85],
        [59.591, 0.95, 0.85],
        [60.306, 0.95, 0.85],
        [61.151, 0.90, 0.85],
        [61.800, 0.80, 0.85],
        [62.486, 0.66, 0.85],
        [63.569, 0.50, 0.85],
        [64.678, 0.34, 0.85],
        [65.764, 0.21, 0.85],
        [66.837, 0.11, 0.85],
        [118.750, 0.70, 0.80],
        [368.498, 0.014, 1.50],
        [424.763, 0.070, 1.50],
        [487.249, 0.032, 1.50],
        [715.393, 0.010, 1.50],
        [773.840, 0.030, 1.50],
        [834.146, 0.012, 1.50],
    ]
)
# calibrated so the 60 GHz complex peaks near ~14 dB/km at sea level
O2_LINE_SCALE = 5.2e-4  # Np/m per atm^2-equivalent at unit shape

# dry continuum (N2/O2 collision-induced), ∝ nu^2 p^2
DRY_CONT = 1.4e-10  # Np/m per atm^2 at 300 GHz


def vvw_shape(nu_GHz, nu0_GHz, gamma_GHz):
    """Van Vleck-Weisskopf line profile (1/GHz), broadcastable."""
    d_minus = gamma_GHz / ((nu_GHz - nu0_GHz) ** 2 + gamma_GHz**2)
    d_plus = gamma_GHz / ((nu_GHz + nu0_GHz) ** 2 + gamma_GHz**2)
    return (nu_GHz / nu0_GHz) ** 2 * (d_minus + d_plus) / np.pi


def standard_profile(base_altitude_m: float, base_temperature_K: float, n_layers: int = 40, top_m: float = 4.2e4):
    """Layered standard atmosphere above the site.

    Returns dict of per-layer arrays: altitude (center, m ASL), dh (m),
    temperature (K), pressure (atm), and the *unit* water-vapor density
    profile (g/m^3 per mm of zenith PWV).
    """
    # denser layers near the ground
    edges = base_altitude_m + (top_m - base_altitude_m) * np.linspace(0, 1, n_layers + 1) ** 2
    centers = 0.5 * (edges[1:] + edges[:-1])
    dh = np.diff(edges)

    # temperature: 6.5 K/km tropospheric lapse to the tropopause (11 km), then isothermal
    h_rel = centers - base_altitude_m
    T = np.where(
        centers < 11e3,
        base_temperature_K - 6.5e-3 * h_rel,
        base_temperature_K - 6.5e-3 * np.maximum(11e3 - base_altitude_m, 0.0),
    )
    T = np.maximum(T, 180.0)

    # pressure: hydrostatic with the local temperature (atm)
    M_air = 0.0289644  # kg/mol
    R = 8.31446
    p = np.empty(n_layers)
    p_here = np.exp(-base_altitude_m * M_air * g / (R * 288.15))  # surface pressure at site
    h_prev = base_altitude_m
    for i in range(n_layers):
        p_here *= np.exp(-(centers[i] - h_prev) * M_air * g / (R * T[i]))
        p[i] = p_here
        h_prev = centers[i]

    # water vapor: exponential with 2 km scale height, normalized to 1 mm pwv
    # (1 mm pwv = 1 kg/m^2 of column water)
    w_shape = np.exp(-h_rel / 2000.0)
    column = np.sum(w_shape * dh)  # m * (unitless)
    rho_unit = 1000.0 * w_shape / column  # g/m^3 per mm pwv

    return {"altitude": centers, "dh": dh, "temperature": T, "pressure": p, "rho_unit": rho_unit}


def absorption_grids(nu_Hz: np.ndarray, profile: dict):
    """Per-layer absorption components on the frequency grid.

    Returns (alpha_dry, alpha_wet_unit, alpha_wet_self_unit), each
    (n_layers, n_nu) in Np/m; wet terms are per mm and per mm^2 of pwv.
    """
    nu = nu_Hz / GHz  # GHz
    T = profile["temperature"][:, None]
    p = profile["pressure"][:, None]
    rho1 = profile["rho_unit"][:, None]
    theta = 300.0 / T

    # H2O lines
    alpha_wet = np.zeros((len(profile["altitude"]), len(nu)))
    for nu0, s_rel, w, x in H2O_LINES:
        gamma = w * p * theta**0.7 + 0.012 * rho1 * theta  # pressure + (unit) self broadening
        gamma = np.maximum(gamma, 5e-4)
        strength = s_rel * theta**x * np.exp(2.2 * (1 - 1 / theta))
        alpha_wet += H2O_LINE_SCALE * strength * vvw_shape(nu, nu0, gamma)
    alpha_wet *= rho1

    # wet continuum
    alpha_wet += H2O_CONT_FOREIGN * rho1 * p * (nu / 300.0) ** 2 * theta**3
    alpha_wet_self = H2O_CONT_SELF * rho1**2 * (nu / 300.0) ** 2 * theta**7.5

    # O2 lines (strength ∝ p * theta^3; width ∝ p * theta^0.8)
    alpha_dry = np.zeros_like(alpha_wet)
    for nu0, s_rel, w in O2_LINES:
        gamma = np.maximum(w * p * theta**0.8, 5e-4)
        alpha_dry += O2_LINE_SCALE * s_rel * p * theta**3 * vvw_shape(nu, nu0, gamma)

    # dry continuum
    alpha_dry += DRY_CONT * (nu / 300.0) ** 2 * p**2 * theta**3.5

    return alpha_dry, alpha_wet, alpha_wet_self


def generate_spectrum_grids(
    base_altitude_m: float,
    base_temperature_median_K: float = 280.0,
    n_temperatures: int = 5,
    n_pwv: int = 24,
    n_elevations: int = 14,
    nu_max_Hz: float = 1.25e12,
    d_nu_Hz: float = 0.4e9,
):
    """Emission/opacity grids over (base_temperature, zenith_pwv, elevation, nu).

    Emission is the Rayleigh-Jeans temperature of the downwelling
    atmospheric radiance (CMB background excluded; the simulator adds the
    CMB separately, see reference maria/sim/cmb.py:126-140).
    """
    side_base_temperature = base_temperature_median_K + np.linspace(-18, 18, n_temperatures)
    side_zenith_pwv = np.geomspace(0.05, 100.0, n_pwv)
    side_elevation = np.radians(np.linspace(5.0, 90.1, n_elevations))
    side_nu = np.arange(1.0 * GHz, nu_max_Hz, d_nu_Hz)

    n_nu = len(side_nu)
    emission = np.zeros((n_temperatures, n_pwv, n_elevations, n_nu), dtype=np.float32)
    opacity = np.zeros_like(emission)
    path_delay = np.zeros_like(emission)

    airmass = 1.0 / np.sin(np.clip(side_elevation, np.radians(5.0), None))

    for i_T, T_base in enumerate(side_base_temperature):
        profile = standard_profile(base_altitude_m, T_base)
        alpha_dry, alpha_wet, alpha_wet_self = absorption_grids(side_nu, profile)
        dh = profile["dh"][:, None]
        T_layers = profile["temperature"]
        pwv = side_zenith_pwv[:, None, None]
        # zenith optical depth per layer: (n_pwv, n_layers, n_nu)
        dtau_z = (alpha_dry[None] + pwv * alpha_wet[None] + pwv**2 * alpha_wet_self[None]) * dh[None]

        # excess path: ~6.3 mm per mm pwv (wet) + dry term, roughly achromatic
        wet_delay = 6.3e-3 * side_zenith_pwv  # m per mm pwv
        dry_delay = 2.31 * profile["pressure"][0]  # m, from surface pressure

        for i_el, am in enumerate(airmass):
            dtau = dtau_z * am  # (n_pwv, n_layers, n_nu)
            tau_total = dtau.sum(axis=1)
            opacity[i_T, :, i_el] = tau_total

            # radiative transfer top -> bottom: I_below = I e^-dtau + B(T)(1-e^-dtau)
            I = np.zeros((n_pwv, n_nu))
            for k in range(len(T_layers) - 1, -1, -1):
                trans = np.exp(-dtau[:, k])
                B = planck_radiance(T_layers[k], side_nu)
                I = I * trans + B[None] * (1 - trans)
            emission[i_T, :, i_el] = rj_temperature(I, side_nu)
            path_delay[i_T, :, i_el] = ((wet_delay + dry_delay) * am)[:, None]

    return {
        "side_base_temperature_K": side_base_temperature,
        "side_zenith_pwv_mm": side_zenith_pwv,
        "side_elevation_rad": side_elevation,
        "side_nu_Hz": side_nu,
        "rayleigh_jeans_temperature_K": emission,
        "opacity_nepers": opacity,
        "excess_path_m": path_delay,
    }


def planck_radiance(T, nu):
    return 2 * h * nu**3 / (c**2 * np.expm1(h * nu / (k_B * T)))


def rj_temperature(I_nu, nu):
    return I_nu * c**2 / (2 * k_B * nu**2)
