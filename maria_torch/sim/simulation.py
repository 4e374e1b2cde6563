"""The Simulation engine (maria_tpu/sim/simulation.py): one Observation
per plan, one TODProgram per observation, and TODs out.

Every random draw comes from the simulation's ``torch.Generator`` (seeded
with ``seed``) unless ``run`` is handed the draws explicitly.
"""

from __future__ import annotations

import logging
import time as _time

import numpy as np
import torch

from ..device import resolve_device
from ..instrument import Instrument, get_instrument
from ..noise import DEFAULT_NOISE_SIM_KWARGS
from ..ops.program import build_tod_program
from ..plan import Plan, get_plan
from ..site import Site, get_site
from ..tod import TOD, Pointing
from .observation import Observation

logger = logging.getLogger("maria_torch")


class Simulation:
    def __init__(self, instrument, plans=None, site=None, atmosphere=None,
                 atmosphere_kwargs: dict = {}, cmb=None, map=None,  # noqa: A002
                 noise: bool = True, noise_kwargs: dict = {}, seed: int = None,
                 device=None, plan=None, **kwargs):
        if plans is None:
            plans = plan
        if plans is None:
            raise TypeError("Simulation requires 'plans' (or the alias 'plan').")
        if site is None:
            raise TypeError("Simulation requires 'site'.")
        if cmb:
            raise NotImplementedError("CMB (ROADMAP queue 1, item 8: sky stages)")
        if map is not None:
            raise NotImplementedError("input maps (ROADMAP queue 1, item 8: sky stages)")
        if atmosphere is None:
            raise NotImplementedError(
                "scenes without an atmosphere (ROADMAP queue 1, item 13: noise-only scenes)"
            )
        if kwargs:
            raise NotImplementedError(f"simulation options {sorted(kwargs)} (ROADMAP queue 1, item 13)")

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
        self.plans = list(plans)

        self.atmosphere = atmosphere
        self.atmosphere_kwargs = dict(atmosphere_kwargs)
        self.noise = noise
        self.noise_kwargs = {**DEFAULT_NOISE_SIM_KWARGS, **noise_kwargs}

        self.obs_list = []
        for plan in self.plans:
            obs = Observation(
                instrument=self.instrument, plan=plan, site=self.site,
                atmosphere=self.atmosphere, atmosphere_kwargs=self.atmosphere_kwargs,
            )
            obs.atmosphere.initialize(obs)
            self.obs_list.append(obs)
        self._programs = {}

    def program(self, obs_index: int = 0):
        """The observation's TODProgram, built once."""
        if obs_index not in self._programs:
            self._programs[obs_index] = build_tod_program(
                self.obs_list[obs_index], with_noise=self.noise, noise_kwargs=self.noise_kwargs
            )
        return self._programs[obs_index]

    def run(self, units: str = "K_RJ", draws: list = None) -> list:
        """One TOD per observation, in ``units``. ``draws`` optionally
        gives each observation's unit normals (see ``run_obs``)."""
        tods = []
        for i in range(len(self.obs_list)):
            s = _time.monotonic()
            tods.append(self.run_obs(i, draws=None if draws is None else draws[i]).to(units))
            logger.info(f"Simulated observation {i + 1}/{len(self.obs_list)} in {_time.monotonic() - s:.2f} s")
        return tods

    def run_obs(self, obs_index: int, draws: dict = None) -> TOD:
        """One observation's TOD in pW. ``draws`` may hold "screens",
        "noise", "modes" (see ``TODProgram.fields``) and "gains" ((n_det,)
        normals); anything missing is drawn from the generator."""
        obs = self.obs_list[obs_index]
        draws = draws or {}
        program = self.program(obs_index)
        fields, pwv_fine = program.fields(generator=self.generator, draws=draws, device=self.device)
        obs.zenith_scaled_pwv = pwv_fine

        # multiplicative per-detector gain error on every non-noise field
        gains = program.draw_gains(generator=self.generator, draw=draws.get("gains"), device=self.device)
        if gains is not None:
            fields = {k: v if k == "noise" else v * gains for k, v in fields.items()}

        metadata = {
            "atmosphere": True,
            "sim_time": _time.time(),
            "altitude": float(obs.site.altitude),
            "region": obs.site.region,
            "pwv": float(np.round(obs.atmosphere.weather.pwv, 3)),
            "base_temperature": float(np.round(obs.atmosphere.weather.temperature[0], 3)),
        }
        return TOD(
            data=fields,
            dets=obs.instrument.dets,
            pointing=Pointing(obs.boresight, obs.offsets),
            units="pW",
            metadata=metadata,
            spectrum=obs.atmosphere.spectrum,
        )

    def __repr__(self):
        return f"Simulation({self.instrument!r}, {self.site!r}, {len(self.plans)} plan(s), device={self.device})"
