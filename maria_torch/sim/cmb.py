"""Observing the CMB (maria_tpu/sim/cmb.py).

The CMB is not a Rayleigh-Jeans source: its loading is the Planck
spectrum at T_CMB integrated through the passband (and the atmosphere's
transmission, where there is one), P0, plus the sky's anisotropy times
dP/dT, both by a two-point difference at T_CMB and T_CMB + EPS (1e-6 K).

``cmb_power_tables`` makes the (pwv, elevation) tables of P0 and dP/dT
that the program's CMB stage (``ops/program.py``) evaluates at each
realization's fine-rate pwv; ``compute_cmb_loading`` is the whole chain
outside the program: a scene without an atmosphere runs it every run(),
and with an atmosphere it is the program's cross-check.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import T_CMB, k_B
from ..device import resolve_device
from ..ops.interp import interp_grid
from ..functions.radiometry import inverse_rayleigh_jeans_spectrum, planck_spectrum
from ..tod import Pointing

__all__ = ["DEFAULT_CMB_SIM_KWARGS", "cmb_power_grids", "cmb_power_tables", "compute_cmb_loading", "initialize_cmb"]

DEFAULT_CMB_SIM_KWARGS = {"nside": 1024}
GENERATE = ("spectrum", "power_spectrum", "generate", "generated")
EPS = 1e-6  # K: the step of the two-point dP/dT


def _test_T_RJ(nu, eps: float = EPS):
    """(n_nu, 2): the RJ temperatures of blackbodies at T_CMB and T_CMB +
    eps (the Planck spectrum, inverted as a Rayleigh-Jeans one)."""
    nu = nu[:, None]
    return inverse_rayleigh_jeans_spectrum(planck_spectrum(np.array([T_CMB, T_CMB + eps])[None], nu), nu)


def _det_power_grid(band, spectrum, eps: float = EPS):
    """(T_base, pwv, el, 2) pW of the two blackbodies through the passband
    and the atmosphere's transmission, on the spectrum's grid."""
    from scipy.interpolate import interp1d

    nu = band.nu
    op = interp1d(spectrum.side_nu, spectrum._opacity, axis=-1)(nu)  # (T_base, pwv, el, n_nu)
    return 1e12 * k_B * np.trapezoid(
        _test_T_RJ(nu, eps)[None, None, None] * (np.exp(-op) * band.passband(nu))[..., None], x=nu, axis=-2
    )


def cmb_power_tables(band, spectrum, base_temperature: float, eps: float = EPS):
    """(pwv_side, el_side, P0 (pwv, el) pW, dP/dT (pwv, el) pW/K_CMB), the
    tables at one base temperature, float32 (the T_base axis collapsed
    as ``Band.atmosphere_power_table`` does), dP/dT over a step of ``eps`` K."""
    P_T = _det_power_grid(band, spectrum, eps)
    T_sides = spectrum.side_base_temperature
    i = int(np.clip(np.searchsorted(T_sides, base_temperature) - 1, 0, len(T_sides) - 2))
    w = np.clip((base_temperature - T_sides[i]) / (T_sides[i + 1] - T_sides[i]), 0, 1)
    P = (1 - w) * P_T[i] + w * P_T[i + 1]  # (pwv, el, 2)
    return (
        np.asarray(spectrum.side_zenith_pwv),
        np.asarray(spectrum.side_elevation),
        np.asarray(P[..., 0], dtype=np.float32),
        np.asarray((P[..., 1] - P[..., 0]) / eps, dtype=np.float32),
    )


def initialize_cmb(cmb, seed: int = None, device=None, **cmb_kwargs):
    """The simulation's CMB sky: "generate" (or a synonym) draws one with
    ``generate_cmb(seed=seed, **cmb_kwargs)`` on ``device``, "real" or
    "planck" is ``get_cmb``'s stand-in, and a HEALPixMap is taken as it
    is, converted to K_CMB where it is in other units."""
    from ..cmb import generate_cmb, get_cmb

    if isinstance(cmb, str) and cmb in GENERATE:
        cmb = generate_cmb(seed=seed, device=device, **cmb_kwargs)
    elif isinstance(cmb, str) and cmb in ("real", "planck"):
        cmb = get_cmb(device=device)
    elif not hasattr(cmb, "sample_stokes"):
        raise ValueError(f"Invalid value for cmb '{cmb}'.")
    return cmb if cmb.units == "K_CMB" else cmb.to("K_CMB")


def cmb_power_grids(obs, band, device):
    """The band's (P0, dP/dT) over its detectors' samples, (n_band_det,
    n_t) float32 on ``device``: through the atmosphere at the
    observation's fine-rate pwv (``obs.zenith_scaled_pwv``, which run()
    sets) and its detectors' own elevations, in float64; without an
    atmosphere from the passband alone, (1, 1) each."""
    dets = obs.instrument.dets
    k = dets.bands.names.index(band.name)
    if hasattr(obs, "atmosphere"):
        spectrum = obs.atmosphere.spectrum
        grid = torch.as_tensor(_det_power_grid(band, spectrum), dtype=torch.float64, device=device)
        T0 = torch.tensor(float(obs.atmosphere.weather.temperature[0]), dtype=torch.float64, device=device)
        pwv = torch.as_tensor(obs.zenith_scaled_pwv, device=device)[dets.band_rows_on(device)[k]]
        _, el = Pointing(obs.boresight, obs.offsets, obs.q).det_azel(device=device, idx=dets.band_rows()[k])
        P = interp_grid(spectrum.points[:3], grid, (T0, pwv, torch.clamp(el, max=float(np.pi / 2))))
    else:
        nu = band.nu
        P = 1e12 * k_B * np.trapezoid(_test_T_RJ(nu) * band.passband(nu)[:, None], x=nu, axis=-2)
        P = torch.as_tensor(P, dtype=torch.float64, device=device)[None, None, :]
    return P[..., 0].to(torch.float32), ((P[..., 1] - P[..., 0]) / EPS).to(torch.float32)


def compute_cmb_loading(cmb, obs, device=None):
    """The "cmb" field (n_det, n_t) in pW: per band P0 times the Stokes I
    weight plus dP/dT times the Stokes-weighted sky along the pointing."""
    device = resolve_device(device)
    dets = obs.instrument.dets
    loading = torch.zeros(obs.shape, dtype=torch.float32, device=device)
    stokes_weight = torch.as_tensor(np.asarray(dets.stokes_weight(), dtype=np.float32), device=device)
    for band, band_idx, rows in zip(dets.bands, dets.band_rows(), dets.band_rows_on(device)):
        P0, dP_dT = cmb_power_grids(obs, band, device)
        samples = cmb.sample_stokes(Pointing(obs.boresight, obs.offsets[band_idx], obs.q), stokes_weight[rows])
        loading[rows] = P0 * stokes_weight[rows, 0][:, None] + dP_dT * samples
    return loading
