"""The line-of-sight layer sampler: ``csrc/los_sample.cu`` and its plain
torch version.

``los_sample(mean_pwv, layers, px, py, t_rel)`` returns the zenith-scaled
pwv, the mean plus each layer's bilinear sample along the lines of sight
times its rms, summed in the order of ``layers``. A layer (``Layer``) is
a (ny, nx) float32 grid and its transform: height h, extrusion angle,
wind (vx, vy), grid spacings (res_x, res_y), origin (tx_min, ty_min) and
rms. Layer l is sampled at x = h px + vx t, y = h py + vy t, rotated by
its angle; points off its grid give 0.

On a CPU tensor it runs the plain version (``los_sample_plain``): one
``interp_bilinear_uniform`` a layer, as the port always sampled. On a
CUDA tensor it launches the kernel, which replaces no TPU kernel (see its
source): one launch for up to ``max_layers()`` layers, bit-equal to the
plain version on the card. Where px or py requires a gradient, the
backward is one launch of the kernel's backward, whose gradients are
the plain version's autograd on the card bit for bit. The grids and
t_rel are constants: one that requires a gradient is refused.
``los_sample.launches`` counts the kernel's launches, forward and
backward.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import kernels
from .interp import interp_bilinear_uniform

__all__ = ["Layer", "LosLayer", "layer_table", "los_sample", "los_sample_plain", "max_layers"]


class Layer(NamedTuple):
    """One layer the sampler reads: ``values`` (ny, nx) and its transform."""

    values: torch.Tensor
    h: float
    angle: float
    vx: float
    vy: float
    res_x: float
    res_y: float
    tx_min: float
    ty_min: float
    rms: float


class LosLayer(ctypes.Structure):
    """The kernel's descriptor of a layer (``LosLayer`` in the source): the
    constants as float32, as torch rounds a Python scalar, and the
    reciprocals of the spacings by which torch divides a CUDA tensor:
    1 / res in double, then rounded to float32 (not 1 / float32(res))."""

    _fields_ = [
        ("grid", ctypes.c_void_p), ("ny", ctypes.c_int), ("nx", ctypes.c_int),
        ("h", ctypes.c_float), ("ca", ctypes.c_float), ("sa", ctypes.c_float),
        ("vx", ctypes.c_float), ("vy", ctypes.c_float),
        ("inv_dx", ctypes.c_float), ("inv_dy", ctypes.c_float),
        ("x0", ctypes.c_float), ("y0", ctypes.c_float), ("rms", ctypes.c_float),
    ]


def _sample(values, h, angle, vx, vy, res_x, res_y, tx_min, ty_min, px, py, t_rel):
    x = h * px + vx * t_rel
    y = h * py + vy * t_rel
    ca, sa = float(np.cos(angle)), float(np.sin(angle))
    tx = ca * x + sa * y
    ty = -sa * x + ca * y
    return interp_bilinear_uniform(values, tx, ty, tx_min, res_x, ty_min, res_y)


def los_sample_plain(mean_pwv, layers, px, py, t_rel):
    """Plain torch version of ``los_sample``, on any device."""
    pwv = torch.full(px.shape, float(np.float32(mean_pwv)), dtype=px.dtype, device=px.device)
    for layer in layers:
        pwv = pwv + layer.rms * _sample(*layer[:-1], px, py, t_rel)
    return pwv


def layer_table(layers):
    """(descriptors, grids): ``layers`` as a ctypes array of ``LosLayer``,
    in their order, and the contiguous float32 grids they point to (hold
    them while the kernel may read them). Refuses a grid that is not a
    2-D float32 tensor of at least 2 x 2, or that requires a gradient."""
    table = (LosLayer * len(layers))()
    grids = []
    for d, layer in zip(table, layers):
        values = layer.values
        if values.requires_grad:
            raise ValueError("los_sample takes constant grids: a layer's grid requires a gradient")
        if values.dtype != torch.float32 or values.ndim != 2 or min(values.shape) < 2:
            raise ValueError(f"a layer's grid must be float32 (ny, nx) with ny, nx >= 2, got {values.dtype} "
                             f"{tuple(values.shape)}")
        values = values.contiguous()
        grids.append(values)
        d.grid, (d.ny, d.nx) = values.data_ptr(), values.shape
        d.h, d.vx, d.vy = float(layer.h), float(layer.vx), float(layer.vy)
        d.ca, d.sa = float(np.cos(layer.angle)), float(np.sin(layer.angle))
        d.inv_dx, d.inv_dy = kernels.scalar_reciprocal(layer.res_x), kernels.scalar_reciprocal(layer.res_y)
        d.x0, d.y0, d.rms = float(layer.tx_min), float(layer.ty_min), float(layer.rms)
    return table, grids


def max_layers() -> int:
    """Layers the kernel takes in one launch."""
    return kernels.load().maria_los_max_layers()


def _library():
    lib = kernels.load()
    if lib.maria_los_layer_bytes() != ctypes.sizeof(LosLayer):
        raise RuntimeError("csrc/los_sample.cu's LosLayer and ops/los_sample.py's differ in size")
    return lib


def _chunks(table, n_layers, step):
    """(address, count) of each launch's run of descriptors, in order: one
    launch at least, so that an empty table still writes the mean."""
    return [(ctypes.addressof(table) + start * ctypes.sizeof(LosLayer), min(step, n_layers - start))
            for start in range(0, max(n_layers, 1), step)]


def _launch(table, n_layers, mean, px, py, t):
    lib = _library()
    pwv = torch.empty_like(px)
    stream = torch.cuda.current_stream(px.device).cuda_stream
    for k, (address, count) in enumerate(_chunks(table, n_layers, lib.maria_los_max_layers())):
        code = lib.maria_los_sample(address, count, mean, px.data_ptr(), py.data_ptr(), t.data_ptr(), *px.shape,
                                    int(k > 0), pwv.data_ptr(), stream)
        kernels.check(lib, code, "los_sample kernel launch")
        los_sample.launches += 1
    return pwv


def _launch_backward(table, n_layers, px, py, t, grad):
    lib = _library()
    gpx, gpy = torch.empty_like(px), torch.empty_like(px)
    stream = torch.cuda.current_stream(px.device).cuda_stream
    for k, (address, count) in enumerate(reversed(_chunks(table, n_layers, lib.maria_los_max_layers()))):
        code = lib.maria_los_sample_backward(address, count, px.data_ptr(), py.data_ptr(), t.data_ptr(), *px.shape,
                                             int(k > 0), grad.data_ptr(), gpx.data_ptr(), gpy.data_ptr(), stream)
        kernels.check(lib, code, "los_sample backward kernel launch")
        los_sample.launches += 1
    return gpx, gpy


class _LosSampleFn(torch.autograd.Function):
    """The kernel's pwv as a function of px and py; the backward is the
    backward kernel over the same table (its grids held until then)."""

    @staticmethod
    def forward(ctx, px, py, t, table, grids, mean):
        ctx.save_for_backward(px, py, t)
        ctx.table, ctx.grids = table, grids
        return _launch(table, len(grids), mean, px, py, t)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        px, py, t = ctx.saved_tensors
        gpx, gpy = _launch_backward(ctx.table, len(ctx.grids), px, py, t, grad.contiguous())
        return gpx, gpy, None, None, None, None


def los_sample(mean_pwv, layers, px, py, t_rel):
    """The mean plus every layer's sample times its rms, (rows, cols)
    float32 for px and py (rows, cols) and the coarse times t_rel (cols,):
    the plain version on CPU tensors, the kernel on CUDA ones (px, py,
    t_rel and the grids float32 on one card)."""
    if px.device.type == "cpu":
        return los_sample_plain(mean_pwv, layers, px, py, t_rel)
    if px.device.type != "cuda":
        raise ValueError(f"los_sample runs on cpu or cuda tensors, not {px.device.type}")
    table, grids = layer_table(layers)
    if t_rel.requires_grad:
        raise ValueError("los_sample takes a constant t_rel: it requires a gradient")
    if px.ndim != 2 or py.shape != px.shape or t_rel.shape != px.shape[1:]:
        raise ValueError(f"los_sample takes px, py (rows, cols) and t_rel (cols,), got {tuple(px.shape)}, "
                         f"{tuple(py.shape)}, {tuple(t_rel.shape)}")
    tensors = (px, py, t_rel, *grids)
    if any(x.dtype != torch.float32 or x.device != px.device for x in tensors):
        raise ValueError(f"los_sample takes float32 tensors on {px.device}, got "
                         f"{[(x.dtype, str(x.device)) for x in tensors]}")
    mean = float(np.float32(mean_pwv))
    px, py, t = px.contiguous(), py.contiguous(), t_rel.contiguous()
    if torch.is_grad_enabled() and (px.requires_grad or py.requires_grad):
        return _LosSampleFn.apply(px, py, t, table, grids, mean)
    return _launch(table, len(grids), mean, px, py, t)


los_sample.launches = 0
