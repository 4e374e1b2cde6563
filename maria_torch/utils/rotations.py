"""Rotations and the aligning transform (maria_tpu/utils/rotations.py),
host numpy. The transform that aligns a point cloud with its extrusion
axis is closed-form: the principal axis of its horizontal covariance."""

from __future__ import annotations

import numpy as np

__all__ = ["compute_aligning_transform", "get_orthogonal_transform", "get_rotation_matrix_2d",
           "get_rotation_matrix_3d", "principal_angle_2d", "rotation_matrix_2d", "rotation_matrix_3d"]


def rotation_matrix_2d(a):
    """(..., 2, 2) rotation matrices for angles ``a``."""
    a = np.asarray(a)
    c, s = np.cos(a), np.sin(a)
    return np.stack([np.stack([c, -s], axis=-1), np.stack([s, c], axis=-1)], axis=-2)


def rotation_matrix_3d(**rotations):
    """Rotations about named axes composed left to right:
    ``rotation_matrix_3d(z=a, x=b)`` rotates about z by a, then about x by b."""
    axes = {"x": 0, "y": 1, "z": 2}
    R = np.eye(3)
    for axis, angle in rotations.items():
        i, j = (index for dim, index in axes.items() if dim != axis)
        c, s = np.cos(angle), np.sin(angle)
        S = np.eye(3)
        S[i, i], S[i, j], S[j, i], S[j, j] = c, s, -s, c
        R = S @ R
    return R


def get_rotation_matrix_2d(a):
    """(..., 2, 2) rotation matrices for a broadcastable array of angles."""
    return rotation_matrix_2d(a)


def get_rotation_matrix_3d(**rotations):
    """``rotation_matrix_3d`` with broadcastable angles: arrays of angles
    become leading axes of the (..., 3, 3) stack."""
    axes = {"x": 0, "y": 1, "z": 2}
    R = np.eye(3)
    for axis, angle in rotations.items():
        i, j = (index for dim, index in axes.items() if dim != axis)
        a = np.asarray(angle, dtype=float)
        c, s = np.cos(a), np.sin(a)
        S = np.zeros((*a.shape, 3, 3))
        S[..., 0, 0] = S[..., 1, 1] = S[..., 2, 2] = 1.0
        S[..., i, i], S[..., j, j] = c, c
        S[..., i, j], S[..., j, i] = s, -s
        R = S @ R
    return R


def get_orthogonal_transform(signature, entries):
    """The orthogonal matrix exp(S - S^T), S holding the skew ``entries``
    on the axes that ``signature`` (booleans) selects."""
    import scipy.linalg

    signature = np.asarray(signature, dtype=bool)
    axes = np.where(signature)[0]
    n_dim = len(signature)
    n_axes = int(signature.sum())
    if n_axes * (n_axes - 1) // 2 != len(entries):
        raise ValueError(
            f"Bad shape for entries (for signature {signature.tolist()} we expect "
            f"len(entries) = {n_axes * (n_axes - 1) // 2})."
        )
    i, j = np.triu_indices(n=n_axes, k=1)
    S = np.zeros((n_dim, n_dim))
    S[axes[i], axes[j]] = entries
    return scipy.linalg.expm(S - S.T)


def principal_angle_2d(points) -> float:
    """Angle of the principal axis of a 2-D point cloud."""
    p = np.asarray(points, dtype=float).reshape(-1, 2)
    p = p - p.mean(axis=0)
    cxx = np.mean(p[:, 0] ** 2)
    cyy = np.mean(p[:, 1] ** 2)
    cxy = np.mean(p[:, 0] * p[:, 1])
    return 0.5 * np.arctan2(2 * cxy, cxx - cyy)


def compute_aligning_transform(points) -> np.ndarray:
    """3 x 3 transform (``p @ T``) that rotates about the vertical so the
    principal axis of the horizontal footprint lies along the first axis,
    heights unchanged."""
    angle = principal_angle_2d(np.asarray(points)[..., :2])
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
