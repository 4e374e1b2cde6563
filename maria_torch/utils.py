"""Host numpy helpers of the scene layer (from maria_tpu/utils and
maria_tpu/functions)."""

from __future__ import annotations

from datetime import datetime, timezone

import numpy as np
import scipy as sp


def compute_diameter(points) -> float:
    """Diameter of a point cloud via its convex hull."""
    points = np.atleast_2d(points)
    if len(points) < 2:
        return 0.0
    dims_vary = np.ptp(points, axis=0) > 0
    if dims_vary.sum() == 0:
        return 0.0
    if dims_vary.sum() == 1:
        return float(np.ptp(points[:, dims_vary]))
    try:
        hull = sp.spatial.ConvexHull(points[:, dims_vary])
        vertices = points[hull.vertices][:, dims_vary]
    except sp.spatial.QhullError:
        vertices = points[:, dims_vary]
    d2 = np.square(vertices[:, None] - vertices[None]).sum(axis=-1)
    return float(np.sqrt(d2.max()))


def principal_angle_2d(points) -> float:
    """Angle of the principal axis of a 2-D point cloud."""
    p = np.asarray(points, dtype=float).reshape(-1, 2)
    p = p - p.mean(axis=0)
    cxx = np.mean(p[:, 0] ** 2)
    cyy = np.mean(p[:, 1] ** 2)
    cxy = np.mean(p[:, 0] * p[:, 1])
    return 0.5 * np.arctan2(2 * cxy, cxx - cyy)


def rotation_matrix_2d(a):
    a = np.asarray(a)
    c, s = np.cos(a), np.sin(a)
    return np.stack([np.stack([c, -s], axis=-1), np.stack([s, c], axis=-1)], axis=-2)


def get_utc_day_hour(t: float) -> float:
    dt = datetime.fromtimestamp(float(t), tz=timezone.utc)
    return dt.hour + dt.minute / 60 + dt.second / 3600 + dt.microsecond / 3.6e9


def get_utc_year_day(t: float) -> float:
    dt = datetime.fromtimestamp(float(t), tz=timezone.utc)
    return float(dt.timetuple().tm_yday - 1) + get_utc_day_hour(t) / 24


def matern_five_halves(r):
    return (1 + np.sqrt(3) * r + (5.0 / 3.0) * r**2) * np.exp(-np.sqrt(5) * r)


def matern_spectral_density(k, nu: float, r0: float, d: int):
    """Unnormalized Whittle-Matérn spectral density in d dimensions."""
    inv_l2 = 2 * nu / r0**2
    return (inv_l2 + k**2) ** -(nu + d / 2)


def generate_spatial_basis(offsets, k: int = 5, n_side: int = 8, scale: float = 1):
    """Low-rank Matérn-5/2 eigenbasis over the focal plane for the
    correlated detector noise (maria_tpu/utils/linalg.py)."""
    lo = offsets.min(axis=0)
    hi = offsets.max(axis=0)
    x = np.linspace(lo[0], hi[0], n_side)
    y = np.linspace(lo[1], hi[1], n_side)
    grid = np.stack(np.meshgrid(x, y, indexing="ij"), axis=-1).reshape(-1, 2)
    dist = np.linalg.norm(grid[:, None] - grid[None, :], axis=-1) / max(scale, 1e-16)
    evals, evecs = np.linalg.eigh(matern_five_halves(dist))
    modes = evecs[:, : -k - 1 : -1] * np.sqrt(np.maximum(evals[: -k - 1 : -1], 0.0))
    B = sp.interpolate.RegularGridInterpolator(
        (x, y), modes.reshape(n_side, n_side, k), method="cubic"
    )(offsets)
    B *= np.sign(B[:, 0].mean() or 1.0)
    return B
