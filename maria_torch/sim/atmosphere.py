"""The atmosphere stage of the per-stage path, ``Simulation(fused=False)``
(maria_tpu/sim/atmosphere.py): the turbulence at the coarse steps
(``Atmosphere.simulate_pwv``), the fine-rate pwv by linear upsampling,
and the band's (pwv, elevation) loading table evaluated at the coarse
samples and upsampled to the TOD rate by the cubic kernel.

The fused program (``ops/program.py``) computes the same field from the
same draws; it crops the tables to the reachable window and upsamples
by fixed phases, so the two agree to float32 rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.interp import interp_grid, upsample_time

__all__ = ["DEFAULT_ATMOSPHERE_SIM_KWARGS", "compute_atmospheric_loading", "simulate_atmosphere"]

DEFAULT_ATMOSPHERE_SIM_KWARGS = {}


def _times(obs):
    """(t_coarse, t_fine) float32 seconds from the first sample, taken in
    float64 first: absolute times do not fit float32."""
    t0 = float(obs.t[0])
    return tuple(np.asarray(np.asarray(t, np.float64) - t0, np.float32) for t in (obs.atmosphere.boresight.t, obs.t))


def simulate_atmosphere(obs, generator=None, draws: dict = None, device=None):
    """Runs the observation's turbulence (``Atmosphere.simulate_pwv``) and
    sets ``obs.zenith_scaled_pwv`` (n_det, n_t), the pwv upsampled
    linearly to the TOD rate. ``draws`` as ``TODProgram.fields`` takes
    "screens", "groups" and "ar"."""
    pwv_coarse = obs.atmosphere.simulate_pwv(instrument=obs.instrument, generator=generator, draws=draws,
                                             device=device)
    obs.zenith_scaled_pwv = upsample_time(pwv_coarse, *_times(obs), kind="linear")
    return obs.zenith_scaled_pwv


def compute_atmospheric_loading(obs):
    """The "atmosphere" field (n_det, n_t) in pW: each band's loading
    table at the observation's base temperature interpolated at the
    coarse pwv and elevation (clipped at the zenith), times the
    detectors' Stokes I response, then upsampled to the TOD rate by the
    cubic kernel."""
    atm = obs.atmosphere
    pwv = atm.zenith_scaled_pwv
    device = pwv.device
    el = torch.clamp(atm.det_el, max=float(np.pi / 2))
    T_base = float(atm.weather.temperature[0])
    dets = obs.instrument.dets
    stokes_I = torch.as_tensor(np.asarray(dets.mueller()[:, 0, 0], np.float32), device=device)
    loading = torch.zeros(pwv.shape, dtype=torch.float32, device=device)
    for band, rows in zip(dets.bands, dets.band_rows_on(device)):
        pwv_side, el_side, table = band.atmosphere_power_table(atm.spectrum, T_base)
        tab = torch.as_tensor(np.asarray(table, np.float32)[..., None], device=device)
        p = interp_grid((pwv_side, el_side), tab, (pwv[rows], el[rows]))[..., 0]
        loading[rows] = stokes_I[rows, None] * p
    return upsample_time(loading, *_times(obs), kind="cubic")
