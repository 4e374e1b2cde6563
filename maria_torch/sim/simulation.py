"""The Simulation engine (maria_tpu/sim/simulation.py): one Observation
per plan and TODs out. With an atmosphere every field comes from the
observation's TODProgram (the CMB's and the input map's stages
included), or with ``fused=False`` from the per-stage path: the
atmosphere (``sim/atmosphere.py``), the CMB, the map and the noise one
after another, from the same draws in the same order. Without an
atmosphere, the CMB and the map are sampled and calibrated in a vacuum
every run() and the detector noise is drawn band by band.

Loose keywords (``pwv=1.2``, ``nside=...``) are routed to their
subsystem by ``sim/params.py``. Every random draw comes from the
simulation's ``torch.Generator`` (seeded with ``seed``) unless ``run`` is
handed the draws explicitly.
"""

from __future__ import annotations

import logging
import time as _time

import numpy as np
import torch

from ..device import check_float32, resolve_device
from ..instrument import Instrument, get_instrument
from ..io.logging import span
from ..noise import DEFAULT_NOISE_SIM_KWARGS, generate_noise_with_knee
from ..ops.program import band_noise_basis, band_noise_scale, build_tod_program, gain_errors
from ..plan import Plan, PlanList, get_plan
from ..site import Site, get_site
from ..tod import TOD, Pointing
from .atmosphere import DEFAULT_ATMOSPHERE_SIM_KWARGS, compute_atmospheric_loading, simulate_atmosphere
from .cmb import DEFAULT_CMB_SIM_KWARGS, compute_cmb_loading, initialize_cmb
from .map import DEFAULT_MAP_SIM_KWARGS, initialize_map, sample_maps
from .observation import Observation
from .params import parse_sim_kwargs

logger = logging.getLogger("maria_torch")


class Simulation:
    """``progress_bars`` and ``keep_mean_signal`` are kept for maria_tpu's
    signature (it stores both and reads neither in a run); ``dtype`` must
    be float32."""

    @classmethod
    def from_config(cls, config: dict = {}, **params):
        """A Simulation of ``config``'s keywords, ``params`` taking precedence."""
        return cls(**{**config, **params})

    def __init__(self, instrument, plans=None, site=None, atmosphere=None,
                 atmosphere_kwargs: dict = {}, cmb=None, cmb_kwargs: dict = {}, map=None,  # noqa: A002
                 map_kwargs: dict = {},
                 noise: bool = True, noise_kwargs: dict = {}, fused: bool = True, progress_bars: bool = False,
                 keep_mean_signal: bool = False, seed: int = None, dtype=torch.float32,
                 device=None, plan=None, **kwargs):
        if plans is None:
            plans = plan
        if plans is None:
            raise TypeError("Simulation requires 'plans' (or the alias 'plan').")
        if site is None:
            raise TypeError("Simulation requires 'site'.")
        check_float32(dtype)

        # loose keywords (pwv=1.2, ...) go to their subsystem; pwv is sugar
        # for the weather's override
        loose = parse_sim_kwargs(kwargs)
        atmosphere_kwargs = {**loose["atmosphere"], **atmosphere_kwargs}
        if "pwv" in atmosphere_kwargs:
            pwv = atmosphere_kwargs.pop("pwv")
            atmosphere_kwargs["weather"] = {**atmosphere_kwargs.get("weather", {}), "pwv": pwv}
        cmb_kwargs = {**loose["cmb"], **cmb_kwargs}
        map_kwargs = {**loose["map"], **map_kwargs}
        noise_kwargs = {**loose["noise"], **noise_kwargs}

        self.dtype = torch.float32
        self.fused = fused
        self.progress_bars = progress_bars
        self.keep_mean_signal = keep_mean_signal
        self.device = resolve_device(device)
        self.seed = seed
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed) if seed is not None else int(np.random.randint(2**31)))

        self.instrument = instrument if isinstance(instrument, Instrument) else get_instrument(instrument)
        self.site = site if isinstance(site, Site) else get_site(site)
        if isinstance(plans, str):
            plans = [get_plan(plans)]
        elif isinstance(plans, Plan):
            plans = [plans]
        self.plans = PlanList(plans)

        self.atmosphere = atmosphere
        self.atmosphere_kwargs = {**DEFAULT_ATMOSPHERE_SIM_KWARGS, **atmosphere_kwargs}
        self.noise = noise
        self.noise_kwargs = {**DEFAULT_NOISE_SIM_KWARGS, **noise_kwargs}

        self.obs_list = []
        for plan in self.plans:
            obs = Observation(
                instrument=self.instrument, plan=plan, site=self.site,
                atmosphere=self.atmosphere, atmosphere_kwargs=self.atmosphere_kwargs,
            )
            if atmosphere is not None:
                obs.atmosphere.initialize(obs)
            self.obs_list.append(obs)
        self._programs = {}

        self.cmb = None
        if cmb:
            self.cmb_kwargs = {**DEFAULT_CMB_SIM_KWARGS, **cmb_kwargs}
            self.cmb = initialize_cmb(cmb, seed=seed, device=self.device, **self.cmb_kwargs)

        self.map = None
        if map is not None:
            self.map_kwargs = {**DEFAULT_MAP_SIM_KWARGS, **map_kwargs}
            self.map = initialize_map(map, **self.map_kwargs)

    def program(self, obs_index: int = 0):
        """The observation's TODProgram, built once (a simulation with
        an atmosphere has one an observation, which ``run`` takes unless
        ``fused=False``)."""
        if self.atmosphere is None:
            raise ValueError("a simulation without an atmosphere has no TODProgram")
        if obs_index not in self._programs:
            self._programs[obs_index] = build_tod_program(
                self.obs_list[obs_index], with_noise=self.noise, noise_kwargs=self.noise_kwargs, cmb=self.cmb,
                input_map=self.map, map_kwargs=self.map_kwargs if self.map is not None else {},
                device=self.device,
            )
        return self._programs[obs_index]

    def run(self, units: str = "K_RJ", draws: list = None) -> list:
        """One TOD per observation, in ``units``. ``draws`` optionally
        gives each observation's unit normals (see ``run_obs``)."""
        tods = []
        for i in range(len(self.obs_list)):
            s = _time.monotonic()
            tod = self.run_obs(i, draws=None if draws is None else draws[i])
            with span("tod.to"):
                tods.append(tod.to(units))
            logger.info(f"Simulated observation {i + 1}/{len(self.obs_list)} in {_time.monotonic() - s:.2f} s")
        return tods

    def run_obs(self, obs, draws: dict = None) -> TOD:
        """One observation's TOD in pW: ``obs`` is one of ``obs_list`` or
        its index. ``draws`` may hold "screens", "noise", "modes" (see
        ``TODProgram.fields``) and "gains" ((n_det,) normals); anything
        missing is drawn from the generator."""
        with span("sim.run_obs"):
            return self._run_obs(obs, draws)

    def _run_obs(self, obs, draws: dict = None) -> TOD:
        obs_index = obs if isinstance(obs, (int, np.integer)) else self.obs_list.index(obs)
        obs = self.obs_list[obs_index]
        draws = draws or {}
        dets = obs.instrument.dets
        metadata = {
            "atmosphere": self.atmosphere is not None,
            "sim_time": _time.time(),
            "altitude": float(obs.site.altitude),
            "region": obs.site.region,
        }
        if self.atmosphere is not None:
            metadata["pwv"] = float(np.round(obs.atmosphere.weather.pwv, 3))
            metadata["base_temperature"] = float(np.round(obs.atmosphere.weather.temperature[0], 3))
        fused = self.atmosphere is not None and self.fused
        if fused:
            program = self.program(obs_index)
            fields, pwv_fine = program.fields(generator=self.generator, draws=draws, device=self.device)
            obs.zenith_scaled_pwv = pwv_fine
        else:
            fields = {}
            if self.atmosphere is not None:
                simulate_atmosphere(obs, generator=self.generator, draws=draws, device=self.device)
                fields["atmosphere"] = compute_atmospheric_loading(obs)
            if self.cmb is not None:
                with span("sim.cmb"):
                    fields["cmb"] = self._compute_cmb_loading(obs)
            if self.map is not None:
                with span("sim.map"):
                    fields["map"] = sample_maps(
                        self.map, obs, bilinear=self.map_kwargs["bilinear_sampling"], device=self.device
                    )
            if self.noise:
                with span("noise"):
                    fields["noise"] = self._simulate_noise(obs, draws, loading=fields)
            if not fields:
                raise ValueError("nothing to simulate: no atmosphere, no CMB, no map and no noise")
        if self.map is not None:
            metadata["input_map"] = self.map

        # multiplicative per-detector gain error on every non-noise field
        with span("program.gains"):
            if fused:
                gains = program.draw_gains(generator=self.generator, draw=draws.get("gains"), device=self.device)
            else:
                gains = gain_errors(dets.gain_error, self.generator, draws.get("gains"), self.device)
            if gains is not None:
                fields = {k: v if k == "noise" else v * gains for k, v in fields.items()}

        return TOD(
            data=fields,
            dets=dets,
            pointing=Pointing(obs.boresight, obs.offsets, obs.q),
            units="pW",
            metadata=metadata,
            spectrum=obs.atmosphere.spectrum if self.atmosphere is not None else None,
        )

    def _compute_cmb_loading(self, obs):
        """The "cmb" field (n_det, n_t) in pW of ``obs`` outside the
        program (``sim/cmb.py``); with an atmosphere it reads the pwv of
        the observation's last run()."""
        return compute_cmb_loading(self.cmb, obs, self.device)

    def _simulate_noise(self, obs, draws: dict, loading: dict = {}):
        """The "noise" field (n_det, n_t) in pW outside the program: per
        band, white plus 1/f noise with its spatially correlated part,
        every row through kernel K1 (white noise alone for a band without
        a knee), scaled by the band's NEP plus, with ``NEP_per_loading``,
        the photon-loading term over the ``loading`` fields."""
        dets = obs.instrument.dets
        noise = torch.zeros(obs.shape, dtype=torch.float32, device=self.device)
        for i, (band, band_idx, rows) in enumerate(zip(dets.bands, dets.band_rows(), dets.band_rows_on(self.device))):
            with span("noise.basis"):
                basis, corr_prop = band_noise_basis(dets.offsets[band_idx], self.noise_kwargs)
            with span("noise.k1"):
                unscaled = generate_noise_with_knee(
                    (len(band_idx), obs.shape[-1]), sample_rate=obs.sample_rate, knee=band.knee, basis=basis,
                    corr_prop=corr_prop, generator=self.generator,
                    white=None if "noise" not in draws else draws["noise"][i],
                    mode_white=None if "modes" not in draws else draws["modes"][i], device=self.device,
                )
            noise[rows] = band_noise_scale(band, [v[rows] for v in loading.values()]) * unscaled
        return noise

    @property
    def min_time(self) -> float:
        return self.obs_list[0].plan.start_time

    @property
    def max_time(self) -> float:
        return self.obs_list[-1].plan.end_time

    def __repr__(self):
        return f"Simulation({self.instrument!r}, {self.site!r}, {len(self.plans)} plan(s), device={self.device})"
