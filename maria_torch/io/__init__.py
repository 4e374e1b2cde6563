"""Config registry, the on-disk data cache, file formats and the
helpers that print values (maria_tpu/io).

Configs are JSON files under ``maria_torch/configs``, converted from
maria_tpu's YAML registries (tests hold them equal). Generated data
(atmospheric spectra, the named maps' files) is cached under
``$MARIA_TORCH_CACHE_DIR``, default ``<tmp>/maria-torch-data``, or
wherever ``set_cache_dir`` points; ``fetch`` resolves a data product's
path there, made by its offline generator (``caching``). ``fits`` reads
and writes FITS images and binary tables with numpy alone.
"""

from __future__ import annotations

import json
import os
import tempfile
from functools import cache

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_DIR = os.path.join(HERE, "configs")

_cache_state = {"base": None}


def set_cache_dir(directory: str):
    _cache_state["base"] = str(directory)


def get_cache_dir() -> str:
    base = _cache_state["base"] or os.environ.get("MARIA_TORCH_CACHE_DIR")
    return base or os.path.join(tempfile.gettempdir(), "maria-torch-data")


@cache
def _read_config(name: str) -> dict:
    with open(os.path.join(CONFIG_DIR, f"{name}.json")) as f:
        return json.load(f)


def read_config(name: str) -> dict:
    """A fresh copy of one JSON config file (``configs/<name>.json``)."""
    return json.loads(json.dumps(_read_config(name)))


def flatten_config(config: dict, delimiter: str = "/") -> dict:
    """Nested namespaces flattened to delimited keys, as maria_tpu's
    registries hold them: {"act": {"pa4": {"f150": {...}}}} ->
    {"act/pa4/f150": {...}}. A node is a namespace iff all its values are
    dicts."""
    flat = {}
    for key, entry in config.items():
        if isinstance(entry, dict) and entry and all(isinstance(v, dict) for v in entry.values()):
            for inner_key, inner in flatten_config(entry, delimiter).items():
                flat[f"{key}{delimiter}{inner_key}"] = inner
        else:
            flat[key] = entry
    return flat


def atomic_save_npz(path: str, **arrays):
    """Write an .npz through a private temporary file in the same
    directory, then rename it into place: concurrent writers never see
    or leave a partial file."""
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".npz.tmp", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            import numpy as np

            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def read_yaml(path: str) -> dict:
    """A YAML file's contents (needs pyyaml, imported here)."""
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def humanize(x, units) -> str:
    """A value with its units, at the best SI prefix."""
    from ..units import Quantity

    return str(Quantity(x, units=units))


def leftpad(thing, n: int = 2, char: str = " ") -> str:
    """Every line of str(thing) indented by n chars."""
    return "\n".join(n * char + line for line in str(thing).splitlines())


def repr_phi_theta(phi, theta, frame_name: str = "az/el") -> str:
    import numpy as np

    return f"{np.degrees(float(phi)):.02f}°/{np.degrees(float(theta)):.02f}° ({frame_name})"


def repr_lat_lon(lat, lon) -> str:
    import numpy as np

    lat_deg, lon_deg = np.degrees(float(lat)), np.degrees(float(lon))
    ns = "N" if lat_deg >= 0 else "S"
    ew = "E" if lon_deg >= 0 else "W"
    return f"{abs(lat_deg):.03f}°{ns} {abs(lon_deg):.03f}°{ew}"


from .caching import fetch, register_generator  # noqa: E402,F401
from ..utils import humanize_time  # noqa: E402,F401
