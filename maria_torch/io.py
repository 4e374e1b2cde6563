"""Config registry and the on-disk data cache.

Configs are JSON files under ``maria_torch/configs``, converted from
maria_tpu's YAML registries (tests hold them equal). Generated data
(atmospheric spectra) is cached under ``$MARIA_TORCH_CACHE_DIR``, default
``<tmp>/maria-torch-data``, or wherever ``set_cache_dir`` points.
"""

from __future__ import annotations

import json
import os
import tempfile
from functools import cache

HERE = os.path.dirname(os.path.abspath(__file__))
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
