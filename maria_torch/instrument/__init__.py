"""Instruments: detector arrays plus the telescope's drive and elevation
limits (maria_tpu/instrument). The registry holds maria_tpu's eleven
instrument files; an instrument is found by its name or an alias, each
also under its flattened "<file>/<name>" key."""

from __future__ import annotations

from ..array import ARRAY_CONFIGS, Array, ArrayList, get_array
from ..io import read_config

__all__ = ["INSTRUMENT_CONFIGS", "Instrument", "all_instruments", "get_instrument", "get_instrument_config"]

# configs/instrument_<tag>.json holds maria_tpu/instrument/configs/<tag>.yml
INSTRUMENT_TAGS = ("act", "alma", "apex", "atlast", "hd", "lmt", "m2", "music", "newmusic", "so", "test")


def _instrument_configs() -> dict:
    configs = {}
    for tag in INSTRUMENT_TAGS:
        for key, cfg in read_config(f"instrument_{tag}").items():
            cfg.setdefault("aliases", []).append(f"{tag}/{key}".lower())
            configs[key] = cfg
    return configs


INSTRUMENT_CONFIGS = _instrument_configs()
all_instruments = sorted(INSTRUMENT_CONFIGS)


class Instrument:
    def __init__(self, arrays, name: str = None, description: str = "", documentation: str = "",
                 az_vel_limit: float = 3.0, az_acc_limit: float = 1.0, el_vel_limit: float = 2.0,
                 el_acc_limit: float = 1.0, min_elevation: float = 20.0, max_elevation: float = 90.0):
        # Arrays, configuration dicts (named "array-{i}" unless they say) or registry names
        arrays = arrays if isinstance(arrays, (list, tuple, ArrayList)) else [arrays]
        resolved = []
        for i, a in enumerate(arrays):
            if isinstance(a, dict):
                resolved.append(Array.from_config({"name": a.get("name", f"array-{i}"), **a}))
            elif isinstance(a, str):
                resolved.append(get_array(a))
            else:
                resolved.append(a)
        self.arrays = ArrayList(resolved)
        self.name = name or "+".join(a.name for a in self.arrays)
        self.description = description
        self.documentation = documentation
        # deg/s, deg/s^2 and deg
        self.az_vel_limit = az_vel_limit
        self.az_acc_limit = az_acc_limit
        self.el_vel_limit = el_vel_limit
        self.el_acc_limit = el_acc_limit
        self.min_elevation = min_elevation
        self.max_elevation = max_elevation
        self._dets = None

    @classmethod
    def from_config(cls, config: dict, name: str = None) -> "Instrument":
        """An instrument of an "array" (named ``name``, or "array") and/or
        "arrays": a dict of configurations by name, or a list of registry
        names and configurations."""
        c = dict(config)
        c.pop("aliases", None)
        array_configs = {}
        if "array" in c:
            array_configs[name or "array"] = c.pop("array")
        if "arrays" in c:
            arrs = c.pop("arrays")
            if isinstance(arrs, dict):
                array_configs.update(arrs)
            else:
                for entry in arrs:
                    if isinstance(entry, str):
                        if entry not in ARRAY_CONFIGS:
                            raise KeyError(f"Unknown array '{entry}' (known: {sorted(ARRAY_CONFIGS)}).")
                        array_configs[entry] = ARRAY_CONFIGS[entry]
                    else:
                        array_configs[entry.get("name", f"array-{len(array_configs)}")] = entry
        arrays = [cfg if isinstance(cfg, Array) else Array.from_config({"name": key, **cfg})
                  for key, cfg in array_configs.items()]
        return cls(arrays=arrays, name=name, **c)

    @property
    def dets(self) -> Array:
        """Every array's detectors, one table."""
        if self._dets is None:
            self._dets = self.arrays.combine()
        return self._dets

    @property
    def bands(self):
        return self.dets.bands

    @property
    def field_of_view(self) -> float:
        """Diameter of the focal plane, in radians."""
        return self.dets.field_of_view

    @property
    def n_dets(self) -> int:
        return self.dets.n

    def __repr__(self):
        return (f"Instrument({self.name}: {self.n_dets} dets, arrays={[a.name for a in self.arrays]}, "
                f"bands={self.bands.names})")


def get_instrument_config(name: str) -> dict:
    """The registry's configuration of instrument ``name`` (or an alias)."""
    for key, config in INSTRUMENT_CONFIGS.items():
        if name == key or name.lower() == key.lower() or name.lower() in [a.lower() for a in config["aliases"]]:
            return dict(config)
    raise KeyError(f"'{name}' is not a valid instrument name (known: {all_instruments}).")


def get_instrument(name: str = None, **kwargs) -> Instrument:
    """A registered instrument by name or alias, or, with no name, one
    assembled from keyword arguments: ``get_instrument(array={...})``."""
    if name is None:
        return Instrument.from_config(kwargs)
    low = name.lower()
    # a key match takes precedence over an alias match, as in maria_tpu
    for key, config in INSTRUMENT_CONFIGS.items():
        if low == key.lower():
            return Instrument.from_config({**config, **kwargs}, name=key)
    for key, config in INSTRUMENT_CONFIGS.items():
        if low in [a.lower() for a in config["aliases"]]:
            return Instrument.from_config({**config, **kwargs}, name=key)
    raise ValueError(f"'{name}' is not a valid instrument name (known: {all_instruments}).")
