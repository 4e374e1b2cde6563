"""Spectral passbands (maria_tpu/band/__init__.py): the passband table,
the noise spec (NEP, NET_RJ through the K_RJ <-> W kernel of
``radiometry``, or NET_CMB through the calibration graph) and the
host-integrated (pwv, elevation) -> loading power table that the
program interpolates per sample. The registry holds all
ten of maria_tpu's band files, flattened to "<file>/<name>" keys."""

from __future__ import annotations

import logging
from collections.abc import Mapping

import numpy as np
import torch

from ..constants import MAX_NU_HZ, MIN_NU_HZ, c, k_B
from ..device import as_float32_tensors
from ..io import flatten_config, read_config
from ..functions.radiometry import rayleigh_jeans_kernel

__all__ = ["BAND_CONFIGS", "Band", "BandList", "all_bands", "get_band", "parse_band", "validate_band_config"]

logger = logging.getLogger("maria_torch")

# configs/band_<tag>.json holds maria_tpu/band/configs/<tag>.yml
BAND_TAGS = ("abs", "act", "alma", "apex", "atlast", "m2", "music", "so", "test", "toltec")
BAND_CONFIGS = flatten_config({tag: read_config(f"band_{tag}") for tag in BAND_TAGS})
all_bands = sorted(BAND_CONFIGS)

# the units and type of a band's displayed fields
BAND_FIELD_FORMATS = {
    "name": {"units": "none", "dtype": "str"},
    "center": {"units": "Hz", "dtype": "float"},
    "width": {"units": "Hz", "dtype": "float"},
    "shape": {"units": "none", "dtype": "str"},
    "efficiency": {"units": "none", "dtype": "float"},
    "NEP": {"units": "W√s", "dtype": "float"},
    "NET_RJ": {"units": "K√s", "dtype": "float"},
    "NET_CMB": {"units": "K√s", "dtype": "float"},
}


def get_band(band_name: str) -> "Band":
    if band_name not in BAND_CONFIGS:
        raise ValueError(f"'{band_name}' is not a valid pre-defined band name; known: {all_bands}")
    return Band(name=band_name, **BAND_CONFIGS[band_name])


def parse_band(band) -> "Band":
    """A Band from a Band, a dict of its keywords or a registry name."""
    if isinstance(band, Band):
        return band
    if isinstance(band, Mapping):
        return Band(**band)
    if isinstance(band, str):
        return get_band(band)
    raise ValueError(f"Cannot parse band {band!r}.")


def generate_passband(center: float, width: float, shape: str, samples: int = 256):
    """(nu, tau) of a parametric passband (maria_tpu/band/__init__.py
    ``generate_passband``): "gaussian", "flat" or "top_hat"."""
    if shape == "flat":
        nu_min, nu_max = center - 0.6 * width, center + 0.6 * width
    elif shape == "top_hat":
        nu_min, nu_max = center - width, center + width
    else:
        nu_min, nu_max = center - 1.5 * width, center + 1.5 * width
    nu = np.linspace(nu_min, nu_max, samples)
    if shape == "flat":
        tau = np.where((nu > center - 0.5 * width) & (nu < center + 0.5 * width), 1.0, 0.0)
    elif shape == "gaussian":
        tau = np.exp(np.log(0.5) * (2 * (nu - center) / width) ** 2)
    elif shape == "top_hat":
        tau = np.exp(np.log(0.5) * (2 * (nu - center) / width) ** 8)
    else:
        raise ValueError(f"Invalid passband shape '{shape}'.")
    return nu, tau


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
    """Fractional grid index of x under an axis transform (numpy or torch);
    a "general" axis by a bisection, clipped to its cells."""
    kind = transform[0]
    if kind == "uniform":
        return (x - transform[1]) / transform[2]
    if kind == "log":
        return (xp.log(x) - transform[1]) / transform[2]
    side = transform[1]
    if xp is np:
        i = np.clip(np.searchsorted(side, x, side="right") - 1, 0, len(side) - 2)
    else:
        side = torch.as_tensor(side, dtype=x.dtype, device=x.device)
        i = torch.clamp(torch.searchsorted(side, x.contiguous(), right=True) - 1, 0, len(side) - 2)
    return i + (x - side[i]) / (side[i + 1] - side[i])


def interp_grid_np(points, values, xi):
    """Multilinear interpolation on a regular grid with clipped
    coordinates and the same axis transforms as maria_tpu's
    RegularGridInterpolator; host float64. Dims of ``values`` after the
    grid's are carried along."""
    xi = np.broadcast_arrays(*[np.asarray(x, dtype=np.float64) for x in xi])
    los, ws = [], []
    for side, x in zip(points, xi):
        n = len(side)
        f = np.clip(fractional_index(axis_transform(side), x), 0.0, n - 1.0)
        lo = np.clip(np.floor(f).astype(np.int64), 0, n - 2)
        los.append(lo)
        ws.append(f - lo)
    values = np.asarray(values)
    trailing = (1,) * (values.ndim - len(points))  # the value dims after the grid's
    out = 0.0
    for corner in range(1 << len(points)):
        idx, w = [], 1.0
        for d in range(len(points)):
            hi = (corner >> d) & 1
            idx.append(los[d] + hi)
            w = w * (ws[d] if hi else 1 - ws[d])
        out = out + values[tuple(idx)] * np.reshape(w, np.shape(w) + trailing)
    return out


class Band:
    def __init__(self, center: float = None, width: float = None, nu=None, tau=None, name: str = None,
                 shape: str = "gaussian", efficiency: float = 0.5, NET_RJ: float = None, NET_CMB: float = None,
                 NEP: float = None, NEP_per_loading: float = 0.0, gain_error: float = 0.0, knee: float = 1.0,
                 time_constant: float = 0.0, spectrum_kwargs: dict = {}, sensitivity: float = None):
        if (center is not None and width is not None) == (nu is not None and tau is not None):
            raise ValueError("Pass either both 'center' and 'width' or both 'nu' and 'tau'.")
        if center is not None:
            # a parametric passband keeps its efficiency as given
            self.nu, self.tau = generate_passband(center, width, shape, samples=1024)
        else:
            tau = np.asarray(tau, dtype=float)
            tau_max = tau.max()
            efficiency *= tau_max
            self.nu = np.asarray(nu, dtype=float)
            self.tau = tau / tau_max
            if self.nu.shape != self.tau.shape or self.nu.ndim != 1:
                raise ValueError(f"'nu' and 'tau' have mismatched shapes ({self.nu.shape}, {self.tau.shape}).")
        if (self.nu < MIN_NU_HZ).any() or (self.nu > MAX_NU_HZ).any():
            raise ValueError("passband frequencies out of bounds")
        # e.g. 150 GHz -> "f150"
        self.name = name or f"f{10 ** (np.log10(self.center) % 3):>03.0f}"
        self.shape = shape
        self.efficiency = efficiency
        self.NEP_per_loading = NEP_per_loading
        self.gain_error = gain_error
        self.knee = knee
        self.time_constant = time_constant

        # NET_RJ <-> NEP in a vacuum, or through a spectrum of spectrum_kwargs' region
        self.spectrum = None
        self.spectrum_kwargs = {}
        if spectrum_kwargs:
            from ..spectrum import AtmosphericSpectrum

            self.spectrum = AtmosphericSpectrum(region=spectrum_kwargs["region"])
            self.spectrum_kwargs = {
                "zenith_pwv": spectrum_kwargs.get("pwv", 1.0),
                "base_temperature": spectrum_kwargs.get(
                    "temperature", float(np.mean(self.spectrum.side_base_temperature))),
                "elevation": np.radians(spectrum_kwargs.get("elevation", 45)),
            }

        if sensitivity is not None:
            logger.warning("'sensitivity' is deprecated; use 'NET_RJ' or 'NET_CMB'.")
            NET_RJ = sensitivity

        if NEP is not None:
            self.NEP = float(NEP)
        elif NET_RJ is not None:
            self.NET_RJ = NET_RJ
        elif NET_CMB is not None:
            self.NET_CMB = NET_CMB
        else:
            logger.warning(f"No noise level specified for band {self.name}; assuming 50 uK_RJ√s.")
            self.NET_RJ = 50e-6

    def to_config(self) -> dict:
        """The keywords that make this band again: ``Band(**band.to_config())``
        keeps its passband and its noise and readout parameters."""
        return {
            "name": self.name,
            "nu": np.asarray(self.nu, dtype=float).tolist(),
            "tau": np.asarray(self.tau, dtype=float).tolist(),
            "efficiency": float(self.efficiency),
            "NEP": float(self.NEP),
            "NEP_per_loading": float(self.NEP_per_loading),
            "gain_error": float(self.gain_error),
            "knee": float(self.knee),
            "time_constant": float(self.time_constant),
        }

    def _rj_kernel(self) -> float:
        """W per K_RJ of an unpolarized detector, as the NET_RJ of
        maria_tpu's ``Calibration("K_RJ -> W")`` takes it."""
        integral = self.compute_transmission_integral(spectrum=self.spectrum, **self.spectrum_kwargs)
        return float(rayleigh_jeans_kernel(integral))

    @property
    def NET_RJ(self) -> float:
        return self.NEP / self._rj_kernel()

    @NET_RJ.setter
    def NET_RJ(self, value):
        self.NEP = float(value * self._rj_kernel())

    def cal(self, signature: str, **kwargs):
        """The ``Calibration`` of ``signature`` ("W -> K_CMB", ...) for this band."""
        from ..calibration import Calibration

        return Calibration(signature, band=self, **kwargs)

    @property
    def NET_CMB(self) -> float:
        return float(self.cal("W -> K_CMB", spectrum=self.spectrum, **self.spectrum_kwargs)(self.NEP))

    @NET_CMB.setter
    def NET_CMB(self, value):
        self.NEP = float(self.cal("K_CMB -> W", spectrum=self.spectrum, **self.spectrum_kwargs)(value))

    @property
    def center(self) -> float:
        return float(np.round(np.sum(self.nu * self.tau) / np.sum(self.tau), 2))

    @property
    def width(self) -> float:
        """Full width at half maximum of the passband, in Hz."""
        crossings = np.where((self.tau[1:] > 0.5) != (self.tau[:-1] > 0.5))[0]
        nus = []
        for i in crossings:
            order = np.argsort(self.tau[[i, i + 1]])
            nus.append(np.interp(0.5, self.tau[[i, i + 1]][order], self.nu[[i, i + 1]][order]))
        return float(np.ptp(nus)) if len(nus) > 1 else float(np.ptp(self.nu))

    @property
    def wavelength(self) -> float:
        """Wavelength at the band's center, in metres."""
        return c / self.center

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

    def power_table32(self, spectrum, base_temperature: float):
        """``atmosphere_power_table`` as float32 arrays: the table a
        program's ``TableEval`` reads, as the JAX package stores it, and
        ``atmosphere_power`` with it."""
        return tuple(np.asarray(a, dtype=np.float32) for a in self.atmosphere_power_table(spectrum, base_temperature))

    def atmosphere_power(self, spectrum, base_temperature, zenith_pwv, elevation, method: str = "linear",
                         device=None):
        """Band-integrated atmospheric loading [pW] at (zenith pwv,
        elevation) samples, at the mean ``base_temperature``: the float32
        table and the bilinear ``TableEval`` a TODProgram reads, on the
        device of the coordinate tensors (``device``, the card by default,
        for arrays). ``method`` is kept for maria_tpu's signature; both
        are linear."""
        from ..ops.interp import TableEval

        pwv, el = torch.broadcast_tensors(*as_float32_tensors(zenith_pwv, elevation, device=device))
        return TableEval(*self.power_table32(spectrum, float(np.mean(base_temperature))), device=pwv.device)(pwv, el)

    def transmission(self, region="chajnantor", pwv=1.0, elevation=np.radians(90), device=None):
        """The atmosphere's transmission at the band's center in ``region``,
        a tensor on the device of ``pwv`` or ``elevation`` (``device``, the
        card by default, for numbers); maria_tpu's method keeps that
        region's spectrum as the band's own ``spectrum``: here it is kept
        aside, so the band's noise levels stay where they were set."""
        from ..spectrum import AtmosphericSpectrum

        spectrum = getattr(self, "_transmission_spectrum", None)
        if spectrum is None or spectrum.region != region:
            spectrum = self._transmission_spectrum = AtmosphericSpectrum(region=region)
        return spectrum.transmission(nu=self.center, pwv=pwv, elevation=elevation, device=device)

    def summary(self) -> dict:
        from ..units import Quantity

        return {
            "name": self.name,
            "center": Quantity(self.center, "Hz"),
            "width": Quantity(self.width, "Hz"),
            "efficiency": self.efficiency,
            "NEP": Quantity(self.NEP, "W√s"),
            "NET_RJ": Quantity(self.NET_RJ, "K_RJ√s"),
        }

    def plot(self):
        """The passband against frequency (matplotlib, imported here)."""
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(1, 1)
        ax.plot(self.nu / 1e9, self.tau, label=self.name)
        ax.set_xlabel(r"$\nu$ [GHz]")
        ax.set_ylabel(r"$\tau(\nu)$")
        ax.legend()
        return ax

    def __repr__(self):
        return f"Band({self.name}, center={self.center:.4g} Hz, NEP={self.NEP:.3g} W√s)"


class BandList:
    """Bands in a list, addressed by position or name
    (maria_tpu/band/__init__.py ``BandList``)."""

    def __init__(self, bands):
        self.bands = [parse_band(b) for b in (bands if isinstance(bands, (list, tuple)) else [bands])]

    @property
    def names(self):
        return [band.name for band in self.bands]

    def __getitem__(self, key):
        if isinstance(key, str):
            for band in self.bands:
                if band.name == key:
                    return band
            raise KeyError(key)
        return self.bands[key]

    def __iter__(self):
        return iter(self.bands)

    def __len__(self):
        return len(self.bands)

    def __repr__(self):
        return f"BandList({self.names})"


def validate_band_config(band: dict):
    """A band's configuration needs an explicit passband or a (center,
    width) pair."""
    if "passband" not in band:
        if any(key not in band for key in ("center", "width")):
            raise ValueError("The band's center and width must be specified")
