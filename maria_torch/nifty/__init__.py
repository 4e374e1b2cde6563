"""A ``Simulation`` for NIFTy inference pipelines (maria_tpu/nifty): it
keeps each component's field after every observation it runs."""

from __future__ import annotations

from ..sim import Simulation

__all__ = ["NIFTySimulation"]


class NIFTySimulation(Simulation):
    """A Simulation whose ``components`` hold the last observation's
    fields (tensors by name) after ``run()``."""

    def run_obs(self, obs, *args, **kwargs):
        tod = super().run_obs(obs, *args, **kwargs)
        self.components = dict(tod.data)
        return tod
