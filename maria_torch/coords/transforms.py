"""Tangent-plane (azimuthal-equidistant) offsets around a centre, for
numpy (float64, host) or torch tensors (maria_tpu/coords/transforms.py).

Positive dx decreases phi, positive dy increases theta.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["offsets_to_phi_theta", "phi_theta_to_offsets", "get_center_phi_theta", "phi_theta_to_xyz",
           "xyz_to_phi_theta"]


def _stack(xs, xp):
    return torch.stack(xs, dim=-1) if xp is torch else np.stack(xs, axis=-1)


def _offsets_to_phi_theta(dX, cphi, ctheta, xp):
    dx, dy = dX[..., 0], dX[..., 1]
    r2 = dx**2 + dy**2
    nonzero = r2 > 0
    r = xp.where(nonzero, xp.sqrt(xp.where(nonzero, r2, 1.0)), 0.0)
    sin_r_over_r = xp.sinc(r / np.pi)
    cos_r = xp.cos(r)
    sin_c, cos_c = xp.sin(ctheta), xp.cos(ctheta)
    sin_theta = sin_c * cos_r + cos_c * sin_r_over_r * dy
    merid = cos_c * cos_r - sin_c * sin_r_over_r * dy
    dphi = xp.arctan2(-sin_r_over_r * dx, merid)
    theta = xp.arcsin(xp.clip(sin_theta, -1.0, 1.0))
    return _stack([cphi + dphi, theta], xp)


def _phi_theta_to_offsets(pt, cphi, ctheta, xp):
    phi, theta = pt[..., 0], pt[..., 1]
    dphi = phi - cphi
    sin_c, cos_c = np.sin(ctheta), np.cos(ctheta)
    if xp is torch:
        sin_c, cos_c = float(sin_c), float(cos_c)
    cos_t = xp.cos(theta)
    u = xp.sin(dphi) * cos_t
    v = xp.cos(dphi) * cos_t * sin_c - xp.sin(theta) * cos_c
    w = xp.cos(dphi) * cos_t * cos_c + xp.sin(theta) * sin_c
    s2 = u**2 + v**2
    nonzero = s2 > 0
    sin_r = xp.where(nonzero, xp.sqrt(xp.where(nonzero, s2, 1.0)), 0.0)
    r = xp.arctan2(sin_r, w)
    scale = xp.where(sin_r > 0, r / xp.where(sin_r > 0, sin_r, 1.0), 1.0)
    return _stack([-u * scale, -v * scale], xp)


def offsets_to_phi_theta(dX, cphi, ctheta):
    """Map tangent-plane offsets (..., 2) around (cphi, ctheta) to
    (phi, theta). Torch tensors stay on their device and dtype; the
    centre may be a tensor broadcasting against the offsets."""
    if isinstance(dX, torch.Tensor):
        return _offsets_to_phi_theta(dX, cphi, ctheta, torch)
    return _offsets_to_phi_theta(
        np.asarray(dX, dtype=np.float64), np.asarray(cphi, dtype=np.float64),
        np.asarray(ctheta, dtype=np.float64), np,
    )


def phi_theta_to_offsets(pt, cphi, ctheta):
    """Map (phi, theta) (..., 2) to tangent-plane offsets around the
    centre (cphi, ctheta): a scalar for torch tensors; for numpy arrays
    it may also be an array broadcasting against the points."""
    if isinstance(pt, torch.Tensor):
        return _phi_theta_to_offsets(pt, float(cphi), float(ctheta), torch)
    return _phi_theta_to_offsets(
        np.asarray(pt, dtype=np.float64), np.asarray(cphi, dtype=np.float64), np.asarray(ctheta, dtype=np.float64), np,
    )


def phi_theta_to_xyz(phi, theta):
    """Angles onto the unit sphere (..., 3), host float64."""
    phi, theta = np.asarray(phi, dtype=np.float64), np.asarray(theta, dtype=np.float64)
    cos_t = np.cos(theta)
    return np.stack([np.cos(phi) * cos_t, np.sin(phi) * cos_t, np.sin(theta)], axis=-1)


def xyz_to_phi_theta(xyz):
    """(phi in [0, 2 pi), theta) of 3-vectors, host float64."""
    xyz = np.asarray(xyz, dtype=np.float64)
    norm = np.sqrt(np.sum(xyz**2, axis=-1))
    phi = np.arctan2(xyz[..., 1], xyz[..., 0]) % (2 * np.pi)
    theta = np.arcsin(np.clip(xyz[..., 2] / norm, -1.0, 1.0))
    return phi, theta


def get_center_phi_theta(phi, theta, keep_dims=()):
    """Spherical mean via the unit-sphere embedding (host float64): floats
    over every axis, or arrays over the axes that ``keep_dims`` keeps
    (``keep_dims=(-1,)``: one centre a time sample)."""
    xyz = phi_theta_to_xyz(np.atleast_1d(phi), np.atleast_1d(theta))
    if keep_dims:
        axes = list(range(xyz.ndim - 1))
        for dim in keep_dims:
            axes.pop(dim)
        center = xyz.mean(axis=tuple(axes)) if axes else xyz
        phi_c, theta_c = xyz_to_phi_theta(center / np.sqrt(np.sum(center**2, axis=-1, keepdims=True)))
        return np.asarray(phi_c), np.asarray(theta_c)
    center = xyz.reshape(-1, 3).mean(axis=0)
    phi_c, theta_c = xyz_to_phi_theta(center / np.sqrt(np.sum(center**2)))
    return float(phi_c), float(theta_c)
