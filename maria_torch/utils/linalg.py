"""Linear-algebra helpers (maria_tpu/utils/linalg.py): the pointing
matrix's (pixel, weight) pairs, the PSD inverse and the detectors'
spatial noise basis.

``pointing_indices_and_weights`` runs on the device of the coordinates
it is given (the card for arrays); ``compute_pointing_matrix_sparse_indices``,
``fast_psd_inverse`` and ``generate_spatial_basis`` are host numpy.
"""

from __future__ import annotations

import numpy as np
import scipy as sp
import torch

from ..device import as_float32_tensors
from ..functions import matern_five_halves

__all__ = ["compute_pointing_matrix_ingredients", "compute_pointing_matrix_sparse_indices", "fast_psd_inverse",
           "generate_spatial_basis", "pointing_indices_and_weights"]


def _dim_indices_and_weights(x, side, bilinear: bool):
    """(2 or 1, ...) pixel indices and weights along one dimension of
    pixel centres ``side`` (ascending): the two neighbours' bilinear
    weights, or the nearest centre; zero weight off the grid."""
    side = torch.as_tensor(side, dtype=x.dtype, device=x.device)
    n = side.shape[0]
    if bilinear:
        lo = torch.clamp(torch.searchsorted(side, x.contiguous(), right=True) - 1, 0, n - 2)
        p = (x - side[lo]) / (side[lo + 1] - side[lo])
        inside = (p >= 0) & (p <= 1)
        p = torch.clamp(p, 0.0, 1.0)
        return torch.stack([lo, lo + 1]), torch.stack([1 - p, p]) * inside[None]
    edges = 0.5 * (side[1:] + side[:-1])
    idx = torch.searchsorted(edges, x.contiguous(), right=True)
    half = torch.diff(side).mean() / 2
    inside = (x >= side[0] - half) & (x <= side[-1] + half)
    return idx[None], inside[None].to(x.dtype)


def pointing_indices_and_weights(x_list, side_list, bilinear=True, device=None):
    """(pixels, weights, n_pixels) of samples over the Cartesian product
    of the grids of pixel centres ``side_list`` (host arrays), in float32
    on the device of the coordinate tensors ``x_list`` (``device``, the
    card by default, for arrays): ``pixels`` (int64) and
    ``weights`` have shape (2^n_bilinear_dims, *sample_shape), row-major
    flat pixel ids and their weights, zero for a sample off the grid.
    A dimension of one pixel is skipped."""
    if isinstance(bilinear, bool):
        bilinear = len(x_list) * [bilinear]
    pixels = weights = None
    n_pixels = 1
    for x, side, dim_bilinear in zip(as_float32_tensors(*x_list, device=device), side_list, bilinear):
        side = np.atleast_1d(side)
        if side.size == 1:
            continue
        dim_idx, dim_wgt = _dim_indices_and_weights(x, side, dim_bilinear)
        n_pixels *= side.size
        if pixels is None:
            pixels, weights = dim_idx, dim_wgt
        else:  # the outer product over the leading corner axis
            k = pixels.shape[0] * dim_idx.shape[0]
            pixels = (pixels[:, None] * side.size + dim_idx[None]).reshape(k, *dim_idx.shape[1:])
            weights = (weights[:, None] * dim_wgt[None]).reshape(k, *dim_wgt.shape[1:])
    if pixels is None:
        raise ValueError("at least one dimension must have more than one pixel")
    return pixels, weights, n_pixels


compute_pointing_matrix_ingredients = pointing_indices_and_weights


def compute_pointing_matrix_sparse_indices(x_list, bins_list):
    """(sample_indices, pixel_indices, n_pixels): the samples binned onto
    the Cartesian product of the bin edges ``bins_list``, those that fall
    outside any dimension dropped; host numpy."""
    for bins in bins_list:
        if not np.all(np.diff(bins) > 0):
            raise ValueError("Each set of bins must be strictly increasing.")
    flat = [np.ravel(np.asarray(x)) for x in x_list]
    pixel = np.zeros(flat[0].shape, dtype=np.int64)
    inside = np.ones(flat[0].shape, dtype=bool)
    n_pixels = 1
    for x, bins in zip(flat, bins_list):
        i = np.digitize(x, bins=bins) - 1
        inside &= (i >= 0) & (i < len(bins) - 1)
        pixel = pixel * (len(bins) - 1) + np.clip(i, 0, len(bins) - 2)
        n_pixels *= len(bins) - 1
    return np.nonzero(inside)[0], pixel[inside], n_pixels


def fast_psd_inverse(M: np.ndarray) -> np.ndarray:
    """Inverse of a symmetric positive definite matrix by Cholesky
    (LAPACK dpotrf, dpotri), float64; raises LinAlgError when M is not
    positive definite."""
    chol, info = sp.linalg.lapack.dpotrf(M)
    if info != 0:
        raise np.linalg.LinAlgError(f"dpotrf failed with info={info}")
    inv, info = sp.linalg.lapack.dpotri(chol)
    if info != 0:
        raise np.linalg.LinAlgError(f"dpotri failed with info={info}")
    return np.where(inv, inv, inv.T)


def generate_spatial_basis(offsets, k: int = 5, n_side: int = 8, scale: float = 1):
    """Low-rank Matérn-5/2 eigenbasis over the focal plane for the
    correlated detector noise: the top k modes on an n_side^2 grid over
    the detectors' extent, interpolated (cubic) to the detectors."""
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
