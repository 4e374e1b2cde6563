"""Instruments: a detector array plus its drive limits (maria_tpu/instrument)."""

from __future__ import annotations

from ..array import Array
from ..io import read_config

__all__ = ["Instrument", "get_instrument"]


class Instrument:
    def __init__(self, dets: Array, name: str, description: str = "",
                 az_vel_limit: float = 3.0, az_acc_limit: float = 1.0,
                 el_vel_limit: float = 2.0, el_acc_limit: float = 1.0):
        self.dets = dets
        self.name = name
        self.description = description
        # deg/s and deg/s^2
        self.az_vel_limit = az_vel_limit
        self.az_acc_limit = az_acc_limit
        self.el_vel_limit = el_vel_limit
        self.el_acc_limit = el_acc_limit

    @property
    def bands(self):
        return self.dets.bands

    @property
    def n_dets(self) -> int:
        return self.dets.n

    def __repr__(self):
        return f"Instrument({self.name}: {self.n_dets} dets, bands={[b.name for b in self.bands]})"


def get_instrument(name: str) -> Instrument:
    for key, config in read_config("instrument_m2").items():
        if name.lower() == key.lower() or name.lower() in [a.lower() for a in config.get("aliases", [])]:
            cfg = dict(config)
            cfg.pop("aliases", None)
            array = Array.from_config({"name": key, **cfg.pop("array")})
            return Instrument(dets=array, name=key, **cfg)
    raise NotImplementedError(
        f"instrument '{name}' (ROADMAP queue 1, item 13: other instruments and sites)"
    )
