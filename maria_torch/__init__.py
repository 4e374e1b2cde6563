"""maria_torch — the PyTorch/CUDA port of maria_tpu.

The first slice runs the MUSTANG-2 simulate-and-bin path end to end:
``Simulation(...).run()`` -> ``TOD`` -> ``BinMapper(...).run()`` -> map,
with the same scene API and names as ``maria_tpu``. Per-sample work runs
in torch on the selected device; detector noise and map binning run as
hand-written CUDA kernels (``maria_torch/csrc``) when the tensors live
on a card, and as their plain torch versions on the CPU.

The package imports neither jax nor maria_tpu: it carries its own numpy
scene layer for the configurations it supports.
"""

from __future__ import annotations

from .device import default_device  # noqa: F401  (sets the f32/TF32 policy)
from .io import get_cache_dir, set_cache_dir  # noqa: F401
from .instrument import Instrument, get_instrument  # noqa: F401
from .plan import Plan, get_plan  # noqa: F401
from .site import Site, get_site  # noqa: F401
from .sim import Simulation  # noqa: F401
from .tod import TOD  # noqa: F401
from .mappers import BinMapper  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "BinMapper",
    "Instrument",
    "Plan",
    "Simulation",
    "Site",
    "TOD",
    "default_device",
    "get_cache_dir",
    "get_instrument",
    "get_plan",
    "get_site",
    "set_cache_dir",
]
