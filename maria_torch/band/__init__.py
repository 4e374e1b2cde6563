"""Spectral passbands (maria_tpu/band/__init__.py): the passband table,
the noise spec and the host-integrated (pwv, elevation) -> loading
power table that the program interpolates per sample."""

from __future__ import annotations

import numpy as np

from ..constants import MAX_NU_HZ, MIN_NU_HZ, k_B
from ..io import read_config

__all__ = ["Band", "get_band", "BAND_CONFIGS"]


def _band_configs() -> dict:
    # configs/band_<tag>.json holds maria_tpu/band/configs/<tag>.yml,
    # flattened to "<tag>/<name>" keys as maria_tpu does
    return {
        f"{tag}/{name}": cfg for tag in ("atlast", "m2") for name, cfg in read_config(f"band_{tag}").items()
    }


BAND_CONFIGS = _band_configs()


def get_band(band_name: str) -> "Band":
    if band_name not in BAND_CONFIGS:
        raise NotImplementedError(
            f"band '{band_name}' (ROADMAP queue 1, item 13: other instruments and sites); "
            f"supported: {sorted(BAND_CONFIGS)}"
        )
    return Band(name=band_name, **BAND_CONFIGS[band_name])


def generate_passband(center: float, width: float, shape: str, samples: int = 256):
    """(nu, tau) of a parametric passband (maria_tpu/band/__init__.py
    ``generate_passband``); only the gaussian shape is ported."""
    if shape != "gaussian":
        raise NotImplementedError(f"passband shape '{shape}' (ROADMAP queue 1, item 13: other instruments)")
    nu = np.linspace(center - 1.5 * width, center + 1.5 * width, samples)
    return nu, np.exp(np.log(0.5) * (2 * (nu - center) / width) ** 2)


def axis_transform(side):
    """Classify a grid axis as maria_tpu/ops/interp.py does: uniform or
    log-uniform axes index arithmetically; others are 'general'."""
    side = np.asarray(side, dtype=np.float64)
    d = np.diff(side)
    if len(d) == 0:
        return ("uniform", float(side[0]), 1.0)
    if np.ptp(d) <= 1e-5 * np.abs(d).mean():
        return ("uniform", float(side[0]), float(d.mean()))
    if (side > 0).all():
        ld = np.diff(np.log(side))
        if np.ptp(ld) <= 1e-5 * np.abs(ld).mean():
            return ("log", float(np.log(side[0])), float(ld.mean()))
    return ("general", side)


def fractional_index(transform, x, xp=np):
    """Fractional grid index of x under an axis transform (numpy or torch)."""
    kind = transform[0]
    if kind == "uniform":
        return (x - transform[1]) / transform[2]
    if kind == "log":
        return (xp.log(x) - transform[1]) / transform[2]
    raise NotImplementedError("general (non-uniform, non-log) interpolation axes")


def interp_grid_np(points, values, xi):
    """Multilinear interpolation on a regular grid with clipped
    coordinates and the same axis transforms as maria_tpu's
    RegularGridInterpolator; host float64."""
    xi = np.broadcast_arrays(*[np.asarray(x, dtype=np.float64) for x in xi])
    los, ws = [], []
    for side, x in zip(points, xi):
        n = len(side)
        f = np.clip(fractional_index(axis_transform(side), x), 0.0, n - 1.0)
        lo = np.clip(np.floor(f).astype(np.int64), 0, n - 2)
        los.append(lo)
        ws.append(f - lo)
    values = np.asarray(values)
    out = 0.0
    for corner in range(1 << len(points)):
        idx, w = [], 1.0
        for d in range(len(points)):
            hi = (corner >> d) & 1
            idx.append(los[d] + hi)
            w = w * (ws[d] if hi else 1 - ws[d])
        out = out + values[tuple(idx)] * w
    return out


class Band:
    def __init__(self, nu=None, tau=None, name: str = None, center: float = None, width: float = None,
                 shape: str = "gaussian", efficiency: float = 0.5, NEP: float = None,
                 NEP_per_loading: float = 0.0, gain_error: float = 0.0, knee: float = 1.0,
                 time_constant: float = 0.0, **unsupported):
        if unsupported:
            raise NotImplementedError(
                f"band options {sorted(unsupported)} (ROADMAP queue 1, item 13: other instruments)"
            )
        if NEP is None:
            raise NotImplementedError("bands specified by NET (ROADMAP queue 1, item 13)")
        if (center is not None and width is not None) == (nu is not None and tau is not None):
            raise ValueError("Pass either both 'center' and 'width' or both 'nu' and 'tau'.")
        if center is not None:
            # a parametric passband keeps its efficiency as given
            self.nu, self.tau = generate_passband(center, width, shape, samples=1024)
            self.efficiency = efficiency
        else:
            tau = np.asarray(tau, dtype=float)
            tau_max = tau.max()
            self.efficiency = efficiency * tau_max
            self.nu = np.asarray(nu, dtype=float)
            self.tau = tau / tau_max
        if (self.nu < MIN_NU_HZ).any() or (self.nu > MAX_NU_HZ).any():
            raise ValueError("passband frequencies out of bounds")
        self.name = name
        self.NEP = float(NEP)
        self.NEP_per_loading = NEP_per_loading
        self.gain_error = gain_error
        self.knee = knee
        self.time_constant = time_constant

    @property
    def center(self) -> float:
        return float(np.round(np.sum(self.nu * self.tau) / np.sum(self.tau), 2))

    def passband(self, nu):
        return self.efficiency * np.interp(np.asarray(nu, dtype=float), self.nu, self.tau, left=0, right=0)

    def transmission_integral_grid(self, spectrum, nu_min_Hz: float = 0.0, nu_max_Hz: float = np.inf):
        """∫ passband(nu) e^-opacity dnu over [nu_min_Hz, nu_max_Hz) on
        the spectrum's (base_temperature, pwv, elevation) grid — the
        K_RJ <-> W kernel. Kept for the last spectrum and range asked
        for: every TOD conversion of a simulation needs the same grid."""
        key = (id(spectrum), nu_min_Hz, nu_max_Hz)
        cached = getattr(self, "_transmission_grid", None)
        if cached is None or cached[0] != key:
            mask = (spectrum.side_nu >= nu_min_Hz) & (spectrum.side_nu < nu_max_Hz)
            nu = spectrum.side_nu[mask]
            grid = np.trapezoid(self.passband(nu) * np.exp(-spectrum._opacity[..., mask]), x=nu, axis=-1)
            self._transmission_grid = cached = (key, grid, spectrum)  # the spectrum kept alive with its id
        return cached[1]

    def compute_transmission_integral(self, spectrum=None, nu_min_Hz: float = 0.0, nu_max_Hz: float = np.inf,
                                      base_temperature=None, zenith_pwv=None, elevation=None):
        """∫ passband(nu) e^-opacity dnu [Hz] over [nu_min_Hz, nu_max_Hz).
        Without a spectrum, the passband's own integral in a vacuum (a
        float); with one, the grid above interpolated on the host at
        (base_temperature, zenith_pwv, elevation)."""
        if spectrum is None:
            nu = self.nu[(self.nu >= nu_min_Hz) & (self.nu < nu_max_Hz)]
            return float(np.trapezoid(self.passband(nu), x=nu))
        grid = self.transmission_integral_grid(spectrum, nu_min_Hz, nu_max_Hz)
        return np.asarray(interp_grid_np(spectrum.points[:3], grid, (base_temperature, zenith_pwv, elevation)))

    def atmosphere_power_table(self, spectrum, base_temperature: float):
        """(pwv_side, el_side, table): the band-integrated atmospheric
        loading in pW on the (pwv, elevation) grid at one base temperature."""
        values = 1e12 * k_B * np.trapezoid(
            spectrum._emission * self.passband(spectrum.side_nu), spectrum.side_nu, axis=-1
        )
        T_sides = spectrum.side_base_temperature
        i = int(np.clip(np.searchsorted(T_sides, base_temperature) - 1, 0, len(T_sides) - 2))
        w = np.clip((base_temperature - T_sides[i]) / (T_sides[i + 1] - T_sides[i]), 0, 1)
        table = (1 - w) * values[i] + w * values[i + 1]
        return spectrum.side_zenith_pwv, spectrum.side_elevation, table

    def __repr__(self):
        return f"Band({self.name}, center={self.center:.4g} Hz, NEP={self.NEP:.3g} W√s)"
