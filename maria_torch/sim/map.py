"""Scanning an input sky map (maria_tpu/sim/map.py).

Per band: beam-smooth the input map, take it to K_RJ, sample it along
the detectors' pointing (a Stokes-weighted bilinear gather, blended in
time between the frames of a time-evolving map), calibrate each
frequency channel K_RJ -> pW, and last apply a [1/4, 1/2, 1/4] time
kernel that mimics continuous integration. The order matters: the
kernel does not commute with a calibration that varies in time.

``static_map_samples`` and ``map_transmission_table`` feed the program's
map stage (``ops/program.py``), which calibrates with the realization's
own pwv; ``sample_maps`` is the whole chain outside the program (a
scene without an atmosphere, or the per-stage path). The smoothing and the samples are made on the device and
stay there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..array import compute_angular_fwhm
from ..constants import k_B
from ..coords import phi_theta_to_offsets
from ..device import resolve_device
from ..map import ProjectionMap, get
from ..ops.interp import apply_integration_kernel, interp_grid
from ..tod import Pointing

__all__ = [
    "apply_integration_kernel", "band_fwhm", "check_map_observable", "initialize_map", "map_offsets",
    "map_transmission_table", "sample_maps", "static_map_samples",
]

DEFAULT_MAP_SIM_KWARGS = {"bilinear_sampling": True}


def map_offsets(input_map, pointing, device=None, idx=None):
    """(n_det, n_t, 2) float32 tangent-plane offsets of the detectors
    ``idx`` from the map's centre, in the map's frame, on ``device``."""
    if input_map.frame in ("ra/dec", "icrs"):
        phi, theta = pointing.det_radec(device=device, idx=idx)
    else:  # an az/el map
        phi, theta = pointing.det_azel(device=device, idx=idx)
    return phi_theta_to_offsets(torch.stack([phi, theta], dim=-1), *input_map.center)


def check_map_observable(input_map):
    """Only time-labelled maps interpolate over the scan: a z or v cube
    of several slices cannot be observed."""
    if input_map.axis3_label != "t" and len(input_map.t) > 1:
        raise NotImplementedError(
            f"Observing a multi-slice '{input_map.axis3_label}' cube is not supported; "
            f"pass one slice (e.g. map.data[:, :, i:i+1]) or a time-labeled map."
        )


def initialize_map(map, **map_kwargs) -> ProjectionMap:  # noqa: A002
    """The simulation's input map from a name (``map.get``, with the
    generator's keywords) or a ProjectionMap."""
    if isinstance(map, str):
        map = get(map, **{k: v for k, v in map_kwargs.items() if k not in DEFAULT_MAP_SIM_KWARGS})  # noqa: A001
    elif not isinstance(map, ProjectionMap):
        raise ValueError("'map' must be either a ProjectionMap or a string.")
    check_map_observable(map)
    return map


def band_fwhm(obs, band) -> float:
    """The beam's FWHM in radians that the band's map is smoothed to: the
    mean primary's diffraction limit at the band's centre, in the far field."""
    return float(compute_angular_fwhm(fwhm_0=float(np.mean(obs.instrument.dets.primary_size)), z=np.inf,
                                      nu=band.center))


def _channel_samples(channel_map, offsets, stokes_weight, channel: int, obs, bilinear: bool):
    """One channel's K_RJ samples (n_band_det, n_t) along the pointing;
    between the frames of a time-evolving map, the linear blend of the
    two that bracket each sample."""
    dx, dy = offsets[..., 0], offsets[..., 1]
    n_frames = len(channel_map.t)
    if n_frames == 1:
        return channel_map.sample(dx, dy, stokes_weight=stokes_weight, nu_index=channel, bilinear=bilinear)
    f32 = dict(dtype=torch.float32, device=dx.device)
    t0 = float(obs.t[0])
    t_rel = torch.as_tensor(np.asarray(obs.t, dtype=np.float64) - t0, **f32)
    frame_t = torch.as_tensor(np.asarray(channel_map.t, dtype=np.float64) - t0, **f32)
    fi = torch.clamp(torch.searchsorted(frame_t, t_rel) - 1, 0, n_frames - 2)
    w_hi = torch.clamp((t_rel - frame_t[fi]) / (frame_t[fi + 1] - frame_t[fi]), 0.0, 1.0)
    samples = torch.zeros(dx.shape, **f32)
    for f in range(n_frames):
        w_f = torch.where(fi == f, 1 - w_hi, 0.0) + torch.where(fi + 1 == f, w_hi, 0.0)
        samples = samples + w_f[None, :] * channel_map.sample(
            dx, dy, stokes_weight=stokes_weight, nu_index=channel, t_index=f, bilinear=bilinear
        )
    return samples


def static_map_samples(input_map, band, band_idx, obs, bilinear: bool = True, device=None):
    """The static sky timelines of the program's map stage: a list of
    (channel, samples (n_band_det, n_t) float32 on ``device``), one entry
    for every frequency channel of the map that overlaps the band, the
    beam-smoothed K_RJ map sampled along the pointing. Neither the
    K_RJ -> pW calibration nor the integration kernel is applied here:
    both happen in the program, calibration first."""
    check_map_observable(input_map)
    device = resolve_device(device)
    stokes_weight = torch.as_tensor(
        np.asarray(obs.instrument.dets.stokes_weight()[band_idx], dtype=np.float32), device=device
    )
    channel_map = input_map.smooth(fwhm=band_fwhm(obs, band), device=device).to("K_RJ", band=band)
    offsets = map_offsets(input_map, Pointing(obs.boresight, obs.offsets, obs.q), device=device, idx=band_idx)
    out = []
    for channel, (nu_min, nu_max) in enumerate(input_map.nu_bin_bounds):
        if (band.nu.max() < nu_min) or (nu_max < band.nu.min()):
            continue
        out.append((channel, _channel_samples(channel_map, offsets, stokes_weight, channel, obs, bilinear)))
    return out


def map_transmission_table(band, input_map, channel: int, spectrum, base_temperature: float):
    """(n_pwv, n_el) float32 pW-per-K_RJ calibration table of one map
    channel, on the spectrum's (pwv, elevation) grid."""
    nu_min, nu_max = input_map.nu_bin_bounds[channel]
    PWV, EL = np.meshgrid(spectrum.side_zenith_pwv, spectrum.side_elevation, indexing="ij")
    table = 1e12 * k_B * band.compute_transmission_integral(
        spectrum=spectrum, nu_min_Hz=nu_min, nu_max_Hz=nu_max,
        base_temperature=np.full_like(PWV, base_temperature), zenith_pwv=PWV, elevation=EL,
    )
    return np.asarray(table, dtype=np.float32)


def sample_maps(input_map, obs, bilinear: bool = True, device=None):
    """The "map" field (n_det, n_t) in pW outside the program: each band's
    channels calibrated, summed, then the integration kernel. Without an
    atmosphere the calibration is the passband's integral in a vacuum;
    with one (the per-stage path of ``Simulation(fused=False)``, after the
    atmosphere stage set ``obs.zenith_scaled_pwv``) it is the channel's
    transmission integral at each sample's fine-rate pwv and elevation,
    its (T_base, pwv, el) grid interpolated on the device in float64."""
    device = resolve_device(device)
    map_loading = torch.zeros(obs.shape, dtype=torch.float32, device=device)
    dets = obs.instrument.dets
    atm = getattr(obs, "atmosphere", None)
    for band, band_idx, rows in zip(dets.bands, dets.band_rows(), dets.band_rows_on(device)):
        if atm is not None:
            T0 = torch.tensor(float(atm.weather.temperature[0]), dtype=torch.float64, device=device)
            pwv = torch.as_tensor(obs.zenith_scaled_pwv, device=device)[rows]
            _, el = Pointing(obs.boresight, obs.offsets, obs.q).det_azel(device=device, idx=band_idx)
            xi = (T0, pwv, torch.clamp(el, max=float(np.pi / 2)))
        band_loading = 0.0
        for channel, samples in static_map_samples(input_map, band, band_idx, obs, bilinear=bilinear, device=device):
            nu_min, nu_max = input_map.nu_bin_bounds[channel]
            if atm is None:
                pW_per_K_RJ = float(np.float32(
                    1e12 * k_B * band.compute_transmission_integral(nu_min_Hz=nu_min, nu_max_Hz=nu_max)))
            else:
                grid = torch.as_tensor(band.transmission_integral_grid(atm.spectrum, nu_min, nu_max)[..., None],
                                       dtype=torch.float64, device=device)
                integral = interp_grid(atm.spectrum.points[:3], grid, xi)[..., 0]
                pW_per_K_RJ = (1e12 * k_B * integral).to(torch.float32)
            band_loading = band_loading + pW_per_K_RJ * samples
        map_loading[rows] = band_loading
    return apply_integration_kernel(map_loading)
