"""The scenes that chip_smoke.py, the profilers (``profile_slice``,
``profile_bin``) and the card tests drive, built through the user's entry
points.

"mustang2": MUSTANG-2 at the GBT with the 2-D atmosphere (bench.py's
MUSTANG-2 scene at 60 s; the README's flow at 600 s); "atlast":
AtLAST-50k at ALMA with the 3-D atmosphere (bench.py's ``config_b``).
Both scan the daisy at (150, 41) deg in az/el at 50 Hz, with noise, seed
0, and take the atmosphere's ``method``: "fourier" (the default) or "ar"
(the autoregressive extrusion, ``atmosphere_kwargs={"method": "ar"}``).
``simulation(..., input_map="dust")`` lets the scene observe that family
of ``maria_torch.map``, widened to cover the scan's field in ra/dec.

``sky_simulation`` is the observer's flow: MUSTANG-2 on a Planner-made
ra/dec daisy over the synthetic ``big_cluster`` map at (150, 10) deg, with
or without an atmosphere, noise, the map itself and a CMB; ``sky_mapper``
maps its TODs back in ra/dec on the input map's grid (with BinMapper or
another mapper), and ``sky_recovery`` (``cmb_recovery`` for the CMB) and
``sky_residual_rms`` hold that map against the input.

``cmb_patch_simulation`` is the CMB-camera tutorial of docs/tutorials.md
("A CMB patch with an ACT-like array"): two act/pa5 bands at NET_RJ 10
uK_RJ√s and a 10 s knee, a polarized sunflower array of 1,052 detectors,
a 600 s, 20 Hz back-and-forth at cerro_toco and a CMB; ``cmb_patch_mapper``
is its IQU maximum-likelihood mapper after ``remove_spline``, and
``stokes_recovery`` holds a map's Stokes planes against a CMB's.
``act_simulation`` is the ACT camera (pa4, pa5, pa6: 9,000 polarized
detectors in six bands) at the ACT site on the registry's
back_and_forth_10deg_45el plan with the 2-D atmosphere, a CMB and noise.
"""

from __future__ import annotations

import numpy as np

SCENES = {
    "mustang2": dict(instrument="MUSTANG-2", site="GBT", atmosphere="2d", radius=0.083, speed=0.017),
    "atlast": dict(instrument="AtLAST-50k", site="ALMA", atmosphere="3d", radius=0.5, speed=0.25),
}
START_TIME = 1.75e9
SKY_CENTER = (150.0, 10.0)  # deg, ra/dec


def field_map(family: str, plan, offsets, n: int = 512):
    """The map family ``family`` centred on the plan's mean ra/dec and
    widened (the generator's ``width`` override) to 1.05 x the field that
    the detectors at ``offsets`` sweep, on n x n pixels."""
    import maria_torch

    center = plan.coords.center(frame="ra/dec")
    half = np.abs(plan.offsets(frame="ra/dec", center=center)).max() + np.sqrt((np.asarray(offsets) ** 2).sum(-1)).max()
    return maria_torch.map.get(family, center=tuple(np.degrees(center)), width=float(np.degrees(2.1 * half)), n=n)


def simulation(scene: str, duration: float, device=None, method: str = "fourier", input_map: str = None, cmb=None):
    """The ``Simulation`` of ``scene`` (a key of SCENES) for ``duration``
    seconds on ``device``, with the atmosphere's ``method`` and, with
    ``input_map`` (a family's name), that sky over the scan's field; with
    ``cmb`` a CMB as ``Simulation`` takes it."""
    import maria_torch

    s = SCENES[scene]
    plan = maria_torch.get_plan(
        "daisy_5arcmin_60s", start_time=START_TIME, scan_center=(150.0, 41.0), frame="az/el", duration=duration,
        sample_rate=50.0, scan_options={"radius": s["radius"], "speed": s["speed"]}, site=s["site"],
    )
    instrument = maria_torch.get_instrument(s["instrument"])
    sky = None if input_map is None else field_map(input_map, plan, instrument.dets.offsets)
    return maria_torch.Simulation(instrument=instrument, plans=plan, site=s["site"], atmosphere=s["atmosphere"],
                                  atmosphere_kwargs={"method": method}, map=sky, cmb=cmb, noise=True, seed=0,
                                  device=device)


def sky_simulation(duration: float = 600.0, device=None, atmosphere="2d", noise: bool = True, cmb=None,
                   cmb_kwargs: dict = {}, input_map: bool = True):
    """MUSTANG-2 at the GBT observing ``big_cluster`` at SKY_CENTER on the
    first feasible ``duration`` seconds of a ra/dec daisy that the Planner
    finds from START_TIME on; ``atmosphere`` "2d" or None; ``cmb`` (with
    ``cmb_kwargs``) as ``Simulation`` takes it, "generate" for a CMB of
    the default nside 1024; ``input_map=False`` leaves the cluster out of
    the simulation (the Planner still aims at it)."""
    import maria_torch

    s = SCENES["mustang2"]
    sky = maria_torch.map.get("big_cluster", center=SKY_CENTER)
    plan = maria_torch.Planner(target=sky, site=s["site"]).generate_plans(
        start_time=START_TIME, horizon_days=2, total_duration=duration, chunk_duration=duration,
        scan_pattern="daisy", scan_options={"radius": s["radius"], "speed": s["speed"]}, sample_rate=50,
    )[0]
    return maria_torch.Simulation(s["instrument"], plans=plan, site=s["site"], atmosphere=atmosphere,
                                  map=sky if input_map else None, cmb=cmb, cmb_kwargs=cmb_kwargs, noise=noise,
                                  seed=0, device=device)


def sky_mapper(tods, input_map, mapper=None, **kwargs):
    """A mapper (``mapper``, BinMapper by default) in the input map's
    frame, at its centre, width and resolution, with ``kwargs``."""
    import maria_torch

    return (mapper or maria_torch.BinMapper)(
        tods, center=tuple(np.degrees(input_map.center)), width=float(input_map.width.deg),
        resolution=float(input_map.resolution.deg), frame=input_map.frame, **kwargs,
    )


def _covered_against_truth(sim, out_map, t: int):
    """(map, truth) over the better-covered half of the hit pixels of
    time bin ``t``: the map, and ``sim``'s beam-smoothed input map sampled
    at the mapper's pixel centres, float64."""
    import torch

    from .sim.map import band_fwhm

    if out_map.center != sim.map.center or out_map.frame != sim.map.frame:
        raise ValueError("the binned map is not centred on the input map")
    obs = sim.obs_list[0]
    truth_map = sim.map.smooth(band_fwhm(obs, obs.instrument.dets.bands[0]), device=out_map.data.device)
    X, Y = np.meshgrid(out_map.x_side, out_map.y_side)
    truth = truth_map.sample(torch.as_tensor(X, dtype=torch.float32), torch.as_tensor(Y, dtype=torch.float32))
    w, d = out_map.weight[0, 0, t], out_map.data[0, 0, t]
    covered = w >= w[w > 0].median()
    return d[covered].double(), truth[covered].double()


def sky_recovery(sim, out_map, t: int = 0) -> float:
    """Correlation of a map of ``sim`` (its time bin ``t``) with its
    beam-smoothed input map sampled at the mapper's pixel centres, over
    the better-covered half of the hit pixels."""
    import torch

    d, truth = _covered_against_truth(sim, out_map, t)
    return float(torch.corrcoef(torch.stack([d, truth]))[0, 1])


def sky_residual_rms(sim, out_map) -> float:
    """The rms of a map of ``sim`` less its best-fitting multiple of the
    beam-smoothed input, both less their means, over the better-covered
    half of the hit pixels (tests/test_ml_mapper.py's measure)."""
    d, truth = _covered_against_truth(sim, out_map, 0)
    a, b = d - d.mean(), truth - truth.mean()
    return float(((a - (a @ b) / (b @ b) * b) ** 2).mean().sqrt())


def cmb_recovery(cmb, out_map) -> float:
    """Correlation of a binned ra/dec map with the unsmoothed CMB ``cmb``'s
    Stokes I at the mapper's pixel centres, over the better-covered half
    of the hit pixels."""
    import torch

    from .coords import offsets_to_phi_theta

    device = out_map.data.device
    X, Y = np.meshgrid(out_map.x_side, out_map.y_side)
    offsets = torch.as_tensor(np.stack([X, Y], axis=-1), dtype=torch.float32, device=device)
    radec = offsets_to_phi_theta(offsets, *(torch.tensor(c, dtype=torch.float32, device=device) for c in out_map.center))
    truth = cmb.data[0, 0, 0].to(device)[cmb.radec_pixels(radec[..., 0], radec[..., 1])]
    w, d = out_map.weight[0, 0, 0], out_map.data[0, 0, 0]
    covered = w >= w[w > 0].median()
    return float(torch.corrcoef(torch.stack([d[covered].double(), truth[covered].double()]))[0, 1])


def map_stage_errors(sim, device) -> dict:
    """The map stage of ``sim`` (a scene without an atmosphere) on
    ``device`` against the CPU:

    - "smooth": the beam-smoothed map, float32 on the device, against the
      same smoothing in float64 on the CPU, as a share of its maximum;
    - "offsets_rad": the detectors' offsets from the map's centre, float32
      on both, largest difference in radians;
    - "gather": the device's K_RJ samples against a float64 gather on the
      CPU, of the device's smoothed map at the device's own offsets, as a
      share of the smoothed map's maximum;
    - "field": the calibrated, time-filtered "map" field, device against
      CPU, as a share of its maximum, and "field_limit": what one float32
      ulp of the map centre's phi moves a sample by, twice the map's
      steepest step between neighbouring pixels times the ulp's share of a
      pixel."""
    import torch

    from .map.projection import gaussian_beam_fft_filter
    from .ops.interp import interp_bilinear_grid
    from .sim.map import band_fwhm, map_offsets, sample_maps, static_map_samples
    from .tod import Pointing

    obs = sim.obs_list[0]
    band = obs.instrument.dets.bands[0]
    pointing = Pointing(obs.boresight, obs.offsets, obs.q)
    on_device = map_offsets(sim.map, pointing, device=device)
    on_cpu = map_offsets(sim.map, pointing, device="cpu")
    ((_, samples),) = static_map_samples(sim.map, band, np.arange(obs.shape[0]), obs, device=device)
    fwhm = band_fwhm(obs, band)
    smoothed = sim.map.smooth(fwhm, device=device)
    d = smoothed.data[0, 0, 0].cpu()
    F = gaussian_beam_fft_filter(d.shape, smoothed.y_res, smoothed.x_res, fwhm, dtype=torch.float64)
    smoothed64 = torch.fft.irfft2(torch.fft.rfft2(sim.map.data[0, 0, 0].double()) * F, s=tuple(d.shape))
    exact = interp_bilinear_grid(d.double(), on_device[..., 0].cpu().double(), on_device[..., 1].cpu().double(),
                                 smoothed.x_side, smoothed.y_side)
    scale = float(d.abs().max())
    field, field_cpu = sample_maps(sim.map, obs, device=device).cpu(), sample_maps(sim.map, obs, device="cpu")
    step = max(float((d[:, 1:] - d[:, :-1]).abs().max()), float((d[1:] - d[:-1]).abs().max()))
    return {
        "smooth": float((d.double() - smoothed64).abs().max()) / scale,
        "offsets_rad": float((on_device.cpu() - on_cpu).abs().max()),
        "gather": float((samples.cpu().double() - exact).abs().max()) / scale,
        "field": float((field - field_cpu).abs().max()) / float(field_cpu.abs().max()),
        "field_limit": 2 * step * float(np.spacing(np.float32(sim.map.center[0]))) / smoothed.x_res / scale,
    }


CMB_PATCH_START = "2026-03-05T12:00:00"
CMB_PATCH_PREPROCESSING = {"remove_spline": {"knot_spacing": 60, "remove_el_gradient_order": 3}}


def cmb_patch_instrument():
    """The tutorial's instrument: act/pa5/f090 and f150 at NET_RJ 10
    uK_RJ√s and a 10 s knee, through the NET_RJ setter, on a polarized
    sunflower/circle array of 0.7 deg at 1.5 beams' spacing, 10 m primary."""
    import maria_torch
    from maria_torch.band import get_band

    bands = []
    for name in ("act/pa5/f090", "act/pa5/f150"):
        band = get_band(name)
        band.NET_RJ = 10e-6
        band.knee = 1e1
        bands.append(band)
    return maria_torch.get_instrument(array={
        "field_of_view": 0.7, "beam_spacing": 1.5, "primary_size": 10, "packing": "sunflower", "shape": "circle",
        "polarized": True, "bands": bands})


def cmb_patch_plan(duration: float = 600.0):
    """The tutorial's plan: a back-and-forth of 2 deg throw at 1 deg/s in
    az/el at (45, 45), 20 Hz, at cerro_toco."""
    import maria_torch

    return maria_torch.Plan.generate(duration=duration, sample_rate=20, start_time=CMB_PATCH_START,
                                     scan_center=(45, 45), scan_pattern="back-and-forth",
                                     scan_options={"x_throw": 2, "y_throw": 0, "speed": 1.0}, frame="az/el",
                                     site="cerro_toco")


def cmb_patch_simulation(duration: float = 600.0, device=None, cmb="generate", cmb_kwargs: dict = {"nside": 1024},
                         noise: bool = True, seed: int = 0):
    """The tutorial's Simulation, without an atmosphere: ``cmb`` as
    ``Simulation`` takes it ("generate" with ``cmb_kwargs``, or a drawn
    CMB handed in)."""
    import maria_torch

    return maria_torch.Simulation(cmb_patch_instrument(), plans=[cmb_patch_plan(duration)], site="cerro_toco",
                                  cmb=cmb, cmb_kwargs=cmb_kwargs, noise=noise, seed=seed, device=device)


def cmb_patch_mapper(tods, tod_preprocessing=CMB_PATCH_PREPROCESSING, **kwargs):
    """The tutorial's MaximumLikelihoodMapper: ra/dec at 2 arcmin, IQU
    from the polarized detectors, after ``remove_spline`` with the
    elevation gradient to order 3 (``tod_preprocessing={}`` maps the TODs
    as they are)."""
    import maria_torch

    return maria_torch.MaximumLikelihoodMapper(tods=tods, frame="ra/dec", resolution=2 / 60,
                                               tod_preprocessing=tod_preprocessing, **kwargs)


def without_band_means(tod):
    """The TOD (one field, "signal") less each band's mean over its
    detectors and samples: the CMB's monopole P0 w_I is one number a band
    of polarized detectors without gain errors, and taking it off leaves
    the anisotropy that a mapper should recover."""
    from .tod import TOD

    data = tod.signal.clone()
    for rows in tod.dets.band_rows_on(data.device):
        data[rows] -= data[rows].double().mean().float()
    return TOD(data={"signal": data}, pointing=tod.pointing, weight=tod.weight, units=tod.units, dets=tod.dets,
               metadata=tod.metadata)


def stokes_recovery(cmb, out_map, nu_index: int = 0) -> dict:
    """Correlation of each Stokes plane of a ra/dec map with the CMB's
    plane of the same name at the mapper's pixel centres, over the hit
    pixels: the simulator's own convention, in which a detector sees
    sum_s w_s map_s with the galactic-frame Q and U (no angle rotated
    between frames)."""
    import torch

    from .coords import offsets_to_phi_theta

    device = out_map.data.device
    X, Y = np.meshgrid(out_map.x_side, out_map.y_side)
    offsets = torch.as_tensor(np.stack([X, Y], axis=-1), dtype=torch.float32, device=device)
    radec = offsets_to_phi_theta(offsets, *(torch.tensor(c, dtype=torch.float32, device=device)
                                            for c in out_map.center))
    pix = cmb.radec_pixels(radec[..., 0], radec[..., 1])
    out = {}
    for i, s in enumerate(out_map.stokes):
        hit = out_map.weight[i, nu_index, 0] > 0
        d = out_map.data[i, nu_index, 0][hit].double()
        truth = cmb.data[cmb.stokes.index(s), 0, 0].to(device)[pix][hit].double()
        out[s] = float(torch.corrcoef(torch.stack([d, truth]))[0, 1])
    return out


def act_simulation(duration: float = 600.0, device=None, cmb="generate", cmb_kwargs: dict = {}, noise: bool = True,
                   atmosphere="2d", seed: int = 0):
    """The ACT camera at the ACT site on the registry's
    back_and_forth_10deg_45el plan for ``duration`` seconds (9,000
    detectors x 20 Hz), with the 2-D atmosphere, a CMB and noise."""
    import maria_torch

    plan = maria_torch.get_plan("back_and_forth_10deg_45el", duration=duration, site="ACT")
    return maria_torch.Simulation("ACT", plans=plan, site="ACT", atmosphere=atmosphere, cmb=cmb,
                                  cmb_kwargs=cmb_kwargs, noise=noise, seed=seed, device=device)
