"""The mappers' flat nearest-pixel ids from the factorized pointing:
``csrc/pixel_ids.cu`` and its plain torch version.

``pixel_ids(offsets, phi, theta, center, res, n_x, n_y, cos_q, sin_q)``
returns the flat ids iy * n_x + ix (int32, (n_det, n_t), -1 off the map)
at which BinMapper and the ML mapper bin each sample: the detectors'
tangent-plane ``offsets`` (n_det, 2), rotated by q(t) where ``cos_q`` and
``sin_q`` (n_t,) are given (ra/dec; az/el passes None), placed around
the boresight (``phi``, ``theta``) (n_t,), then taken to offsets around
the map's ``center`` (phi, theta in radians) and rounded to the nearest
of n_x x n_y pixels ``res`` (radians) wide centred on it.

On CPU tensors it runs the plain chain (``pixel_ids_plain``), as the
port always computed the ids; on CUDA tensors it launches the kernel, one
launch a call, bit-equal to the plain chain on the card. It replaces no
TPU kernel (see its source). ``pixel_ids.launches`` counts its launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..coords import offsets_to_phi_theta, phi_theta_to_offsets
from . import kernels

__all__ = ["centred_pixel_ids", "flat_pixel_ids", "pixel_ids", "pixel_ids_plain", "sky_offsets"]


def sky_offsets(offsets, cos_q, sin_q):
    """The offsets (n_det, 2) rotated by q(t): (n_det, n_t, 2), from cos q
    and sin q (n_t,) (``Pointing.offsets_radec``)."""
    x, y = offsets[:, None, 0], offsets[:, None, 1]
    return torch.stack([cos_q * x - sin_q * y, sin_q * x + cos_q * y], dim=-1)


def flat_pixel_ids(dx, dy, x0: float, y0: float, res: float, n_x: int, n_y: int):
    """Flat nearest-pixel ids iy * n_x + ix (int32) of tangent-plane
    offsets, -1 outside the map."""
    ix = torch.round((dx - x0) / res).to(torch.int32)
    iy = torch.round((dy - y0) / res).to(torch.int32)
    inside = (ix >= 0) & (ix < n_x) & (iy >= 0) & (iy < n_y)
    return torch.where(inside, iy * n_x + ix, torch.full_like(ix, -1))


def _origin(res: float, n_x: int, n_y: int):
    return -(n_x - 1) / 2 * res, -(n_y - 1) / 2 * res


def centred_pixel_ids(phi, theta, center, res: float, n_x: int, n_y: int):
    """The chain's tail: flat ids (int32, -1 off the map) of the
    detectors' angles ``phi``, ``theta`` (n_det, n_t) on the map."""
    offsets = phi_theta_to_offsets(torch.stack([phi, theta], dim=-1), *center)
    return flat_pixel_ids(offsets[..., 0], offsets[..., 1], *_origin(res, n_x, n_y), res, n_x, n_y)


def pixel_ids_plain(offsets, phi, theta, center, res: float, n_x: int, n_y: int, cos_q=None, sin_q=None):
    """Plain torch version of ``pixel_ids``, on any device: the detectors'
    angles as ``Pointing.det_radec`` (or ``det_azel``) computes them, then
    ``centred_pixel_ids``."""
    dX = offsets[:, None, :] if cos_q is None else sky_offsets(offsets, cos_q, sin_q)
    pt = offsets_to_phi_theta(dX, phi, theta)
    return centred_pixel_ids(pt[..., 0], pt[..., 1], center, res, n_x, n_y)


def _check(offsets, phi, theta, cos_q, sin_q):
    if (cos_q is None) != (sin_q is None):
        raise ValueError("pixel_ids takes both cos_q and sin_q (ra/dec) or neither (az/el)")
    tracks = [x for x in (phi, theta, cos_q, sin_q) if x is not None]
    tensors = [offsets, *tracks]
    if any(x.dtype != torch.float32 for x in tensors):
        raise ValueError(f"pixel_ids takes float32 tensors, got {[x.dtype for x in tensors]}")
    if any(x.device != offsets.device for x in tensors):
        raise ValueError(f"pixel_ids takes tensors on one device, got {[str(x.device) for x in tensors]}")
    if offsets.ndim != 2 or offsets.shape[1] != 2 or any(x.shape != phi.shape or x.ndim != 1 for x in tracks):
        raise ValueError(f"pixel_ids takes offsets (n_det, 2) and tracks (n_t,), got {tuple(offsets.shape)} and "
                         f"{[tuple(x.shape) for x in tracks]}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("pixel_ids takes contiguous offsets and tracks")


def pixel_ids(offsets, phi, theta, center, res: float, n_x: int, n_y: int, cos_q=None, sin_q=None):
    """Flat int32 ids (n_det, n_t), -1 off the map (module docstring):
    the plain chain on CPU tensors, one kernel launch on CUDA ones."""
    _check(offsets, phi, theta, cos_q, sin_q)
    if offsets.device.type == "cpu":
        return pixel_ids_plain(offsets, phi, theta, center, res, n_x, n_y, cos_q, sin_q)
    if offsets.device.type != "cuda":
        raise ValueError(f"pixel_ids runs on cpu or cuda tensors, not {offsets.device.type}")
    n_det, n_t = offsets.shape[0], phi.shape[0]
    ids = torch.empty((n_det, n_t), dtype=torch.int32, device=offsets.device)
    if ids.numel() == 0:
        return ids
    c_phi, c_theta = float(center[0]), float(center[1])
    x0, y0 = _origin(res, n_x, n_y)
    lib = kernels.load()
    rotated = cos_q is not None
    code = lib.maria_pixel_ids(
        offsets.data_ptr(), phi.data_ptr(), theta.data_ptr(), cos_q.data_ptr() if rotated else None,
        sin_q.data_ptr() if rotated else None, n_det, n_t, c_phi, float(np.sin(c_theta)), float(np.cos(c_theta)),
        x0, y0, kernels.scalar_reciprocal(res), kernels.scalar_reciprocal(np.pi), int(n_x), int(n_y), ids.data_ptr(),
        torch.cuda.current_stream(offsets.device).cuda_stream,
    )
    kernels.check(lib, code, "pixel_ids kernel launch")
    pixel_ids.launches += 1
    return ids


pixel_ids.launches = 0
