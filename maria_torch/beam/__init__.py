"""Gaussian-optics beams (maria_tpu/beam): the angular and physical FWHM
of an aperture's beam, a beam kernel image and its separable
convolution, and the Fourier filter of a Gaussian beam. Host numpy,
except ``gaussian_beam_fft_filter``, a host tensor."""

from __future__ import annotations

import numpy as np

from ..array import compute_angular_fwhm  # noqa: F401
from ..map.projection import gaussian_beam_fft_filter  # noqa: F401

__all__ = ["compute_angular_fwhm", "compute_physical_fwhm", "construct_beam_filter", "gaussian_beam_fft_filter",
           "separably_filter_2d"]


def compute_physical_fwhm(fwhm_0, z=np.inf, n=1.0, nu=None, l=None):  # noqa: E741
    """The beam's FWHM in metres at distance z: z x the angular FWHM."""
    return z * compute_angular_fwhm(fwhm_0=fwhm_0, z=z, n=n, nu=nu, l=l)


def construct_beam_filter(fwhm, res, beam_profile=None, buffer=1):
    """A normalized image of the beam of ``fwhm`` on pixels ``res`` wide
    (``buffer`` x fwhm across, at least 3 pixels): ``beam_profile(r, r0)``
    with r0 = fwhm / 2, a soft-edged top hat exp(-(r / r0)^16) by
    default."""
    if beam_profile is None:
        def beam_profile(r, r0):
            return np.exp(-((r / r0) ** 16))

    filter_width = buffer * fwhm
    n_side = max(int(filter_width / res), 3)
    side = np.linspace(-filter_width / 2, filter_width / 2, n_side)
    X, Y = np.meshgrid(side, side, indexing="ij")
    F = beam_profile(np.sqrt(X**2 + Y**2), fwhm / 2)
    return F / F.sum()


def separably_filter_2d(data, F, tol=1e-2):
    """``data`` convolved over its last two axes with the 2-D kernel F as
    a sum of separable terms from F's SVD, stopping once the terms so far
    reproduce F to a mean absolute error under ``tol``."""
    import scipy.ndimage

    if F.ndim != 2:
        raise ValueError("'F' must be two-dimensional.")
    u, s, v = np.linalg.svd(F)
    effective = np.zeros_like(F)
    filtered = np.zeros_like(np.asarray(data, dtype=float))
    for m in range(len(s)):
        effective += s[m] * u[:, m:m + 1] @ v[m:m + 1]
        filtered += s[m] * scipy.ndimage.convolve1d(scipy.ndimage.convolve1d(data, u[:, m], axis=-2), v[m], axis=-1)
        if np.abs(F - effective).mean() < tol:
            break
    return filtered
