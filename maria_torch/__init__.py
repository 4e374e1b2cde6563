"""maria_torch — the PyTorch/CUDA port of maria_tpu.

These paths run end to end, with the same scene API and names as
``maria_tpu``: the MUSTANG-2 simulate-and-bin path,
``Simulation(...).run()`` -> ``TOD`` -> ``BinMapper(...).run()`` -> map,
in az/el or observing a sky in ra/dec (an input map, a CMB from
``generate_cmb``); and the AtLAST-50k total-power path,
``build_tod_program(obs)`` -> ``TODProgram.total_power_fn()`` (3-D
Fourier or AR atmosphere, the noise as one matrix product) -> total pW
-> a map binned over the field; and the observer's map-making,
``TOD.process(...)`` and ``BinMapper`` or ``MaximumLikelihoodMapper``
with ``tod_preprocessing=``, in any unit of maria_tpu's calibration graph
(``Quantity``, ``Calibration``, ``TOD.to``, ``Map.to``); and long
observations in bounded memory, ``StreamingExecutor(program, obs).run()``
(binned maps, Welch spectra, checkpoints) and
``mappers.StreamingMLMapper(executor).fit()``. Per-sample work runs in torch on the
card (``device="cpu"`` asks for the CPU; without a card an entry point
given no device raises); detector noise, the shared-shape noise draw,
map binning, the AR extrusion, the spherical harmonic transforms'
recursion and the streaming pink cascade run as hand-written CUDA kernels (``maria_torch/csrc``) when
the tensors live on a card, and as their plain torch versions on the
CPU.

The package imports neither jax nor maria_tpu: it carries its own numpy
scene layer, with every band, array, instrument, site, region and plan of
maria_tpu's registries, polarized arrays included.

The observer's products are here too: TOD and map files (HDF5, and FITS
with numpy alone, MUSTANG-2's TOD format among them), the offline
``fetch`` of the named maps' files, map operations (indexing, padding,
regridding, ``sampled_onto``), transfer functions and residuals on
another grid, and plots (matplotlib, imported where a plot is made).
"""

from __future__ import annotations

import logging

from .device import default_device  # noqa: F401  (sets the f32/TF32 policy)
from .io import fetch, get_cache_dir, set_cache_dir  # noqa: F401
from .band import Band, get_band  # noqa: F401
from .instrument import Instrument, get_instrument  # noqa: F401
from .plan import Plan, PlanList, Planner, get_plan  # noqa: F401
from .site import Site, get_site  # noqa: F401
from .sim import Simulation  # noqa: F401
from .tod import TOD  # noqa: F401
from .mappers import BinMapper, MaximumLikelihoodMapper, compute_residual_map  # noqa: F401
from .ops.streaming_exec import StreamingExecutor  # noqa: F401
from .units import Quantity  # noqa: F401
from .calibration import Calibration  # noqa: F401
from . import map  # noqa: F401, A004  (maria_torch.map.get, as maria_tpu.map.get)
from .map import all_maps  # noqa: F401
from .map.transfer import TransferFunction, compute_transfer_function, plot_transfer_function  # noqa: F401

__version__ = "0.1.0"

logger = logging.getLogger("maria_torch")


def debug():
    """Log the package's debug messages."""
    logger.setLevel(logging.DEBUG)


def undebug():
    """Back to warnings alone."""
    logger.setLevel(logging.WARNING)


__all__ = [
    "Band",
    "BinMapper",
    "Calibration",
    "Instrument",
    "MaximumLikelihoodMapper",
    "Plan",
    "PlanList",
    "Planner",
    "Quantity",
    "Simulation",
    "Site",
    "StreamingExecutor",
    "TOD",
    "TransferFunction",
    "all_maps",
    "compute_residual_map",
    "compute_transfer_function",
    "debug",
    "default_device",
    "fetch",
    "get_band",
    "get_cache_dir",
    "get_instrument",
    "get_plan",
    "get_site",
    "plot_transfer_function",
    "set_cache_dir",
    "undebug",
]
