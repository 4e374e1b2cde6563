"""Tangent-plane (azimuthal-equidistant) offsets around a centre, for
numpy (float64, host) or torch tensors (maria_tpu/coords/transforms.py).

Positive dx decreases phi, positive dy increases theta.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["offsets_to_phi_theta", "phi_theta_to_offsets", "get_center_phi_theta"]


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


def phi_theta_to_offsets(pt, cphi: float, ctheta: float):
    """Map (phi, theta) (..., 2) to tangent-plane offsets around the
    scalar centre (cphi, ctheta)."""
    if isinstance(pt, torch.Tensor):
        return _phi_theta_to_offsets(pt, float(cphi), float(ctheta), torch)
    return _phi_theta_to_offsets(np.asarray(pt, dtype=np.float64), np.float64(cphi), np.float64(ctheta), np)


def get_center_phi_theta(phi, theta):
    """Spherical mean via the unit-sphere embedding (host float64)."""
    phi = np.atleast_1d(np.asarray(phi, dtype=np.float64))
    theta = np.atleast_1d(np.asarray(theta, dtype=np.float64))
    cos_t = np.cos(theta)
    xyz = np.stack([np.cos(phi) * cos_t, np.sin(phi) * cos_t, np.sin(theta)], axis=-1)
    center = xyz.reshape(-1, 3).mean(axis=0)
    center = center / np.sqrt(np.sum(center**2))
    phi_c = np.arctan2(center[1], center[0]) % (2 * np.pi)
    theta_c = np.arcsin(np.clip(center[2], -1.0, 1.0))
    return float(phi_c), float(theta_c)
