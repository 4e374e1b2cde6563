"""The map-makers (maria_tpu/mappers): ``BaseMapper`` and
``BaseProjectionMapper`` (mappers/base.py), ``BinMapper``,
``MaximumLikelihoodMapper``, ``StreamingMLMapper`` (over a
``StreamingExecutor``'s blocks) and ``compute_residual_map``."""

from __future__ import annotations

import numpy as np
import torch

from .base import BaseMapper, BaseProjectionMapper  # noqa: F401
from .bin_mapper import BinMapper  # noqa: F401
from .ml_mapper import MaximumLikelihoodMapper  # noqa: F401
from .streaming_ml import StreamingMLMapper  # noqa: F401

__all__ = ["BaseMapper", "BaseProjectionMapper", "BinMapper", "MaximumLikelihoodMapper", "StreamingMLMapper",
           "compute_residual_map"]


def compute_residual_map(input_map, output_map):
    """The recovered map less the input sky where the output has weight,
    zero elsewhere, on the output's grid and device; leading (stokes, nu,
    t) axes cut to those both maps have. An input on another grid is
    sampled bilinearly onto the output's pixel centres first
    (``ProjectionMap.sampled_onto``)."""
    same_grid = tuple(input_map.data.shape[-2:]) == tuple(output_map.data.shape[-2:]) and np.allclose(
        input_map.center, output_map.center)
    device = output_map.data.device
    data_in = input_map.data.to(device) if same_grid else input_map.sampled_onto(output_map, device=device)
    ns, nn, nt = (min(a, b) for a, b in zip(data_in.shape[:3], output_map.data.shape[:3]))
    data_out = output_map.data[:ns, :nn, :nt]
    w = output_map.weight[:ns, :nn, :nt]
    resid = torch.where(w > 0, data_out - data_in[:ns, :nn, :nt], 0.0)
    return output_map._replace(data=resid, weight=w, stokes=output_map.stokes[:ns], nu=output_map.nu[:nn],
                               **{output_map.axis3_label: output_map.t[:nt]})
