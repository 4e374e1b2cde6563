"""Covariance kernels and generic math (maria_tpu/functions): the Matérn
family on the host in float64, and ``MaternInterpolator``, whose blended
log-log tables are made once on the host and evaluated on the device of
the distances it is given."""

from __future__ import annotations

import numpy as np
import scipy as sp
import torch

from ..device import as_float32_tensors
from .radiometry import (  # noqa: F401
    inverse_planck_spectrum,
    inverse_rayleigh_jeans_spectrum,
    planck_spectrum,
    rayleigh_jeans_spectrum,
)
from ..ops.interp import interp

__all__ = [
    "MaternInterpolator",
    "approximate_normalized_matern",
    "inverse_sigmoid",
    "matern",
    "matern_five_halves",
    "matern_spectral_density",
    "matern_three_halves",
    "normalized_matern",
    "sigmoid",
]


def sigmoid(x):
    return 1 / (1 + np.exp(-x))


def inverse_sigmoid(y):
    return -np.log(1 / y - 1)


def matern(r, r0, nu):
    """Matérn covariance with outer scale r0."""
    return normalized_matern(r / r0, nu)


def matern_three_halves(r):
    return (1 + np.sqrt(3) * r) * np.exp(-np.sqrt(3) * r)


def matern_five_halves(r):
    return (1 + np.sqrt(3) * r + (5.0 / 3.0) * r**2) * np.exp(-np.sqrt(5) * r)


def matern_spectral_density(k, nu: float, r0: float, d: int):
    """Unnormalized Whittle-Matérn spectral density in d dimensions."""
    inv_l2 = 2 * nu / r0**2
    return (inv_l2 + k**2) ** -(nu + d / 2)


def normalized_matern(r, nu):
    """Unit-variance Matérn covariance at distance r (in units of the
    outer scale), by Bessel K."""
    arg = np.sqrt(2 * nu) * np.asarray(r, dtype=float) + 1e-16
    return 2 ** (1 - nu) / sp.special.gamma(nu) * sp.special.kv(nu, arg) * arg**nu


def _matern_log_tables(nu: float, n_test_points: int = 1024):
    """Log-log tables of the structure function 1 - C(r) and of C(r) on
    r in [1e-6, 1e3], for ``approximate_normalized_matern``."""
    r_samples = np.geomspace(1e-6, 1e3, n_test_points)
    cov = normalized_matern(r_samples, nu=nu)
    log_r = np.log(r_samples)
    log_sf = np.log(np.clip(1 - cov, 1e-300, None))
    log_cov = np.log(np.clip(cov, 1e-300, None))
    return log_r, log_sf, log_cov


def approximate_normalized_matern(r, nu=1 / 3, r0=1e0, n_test_points=1024):
    """Unit-variance Matérn covariance by log-log interpolation, cheap
    over large distance matrices: the structure function interpolated at
    small r (where C ~ 1 and C itself loses precision), the covariance
    at large r, crossfaded at r ~ r0."""
    log_r_tab, log_sf_tab, log_cov_tab = _matern_log_tables(nu, n_test_points)
    r = np.asarray(r, dtype=float)
    r_eff = np.clip(np.atleast_1d(np.abs(r) / r0), 1e-6, None)
    log_r = np.log(r_eff)
    sf = np.exp(np.interp(log_r, log_r_tab, log_sf_tab))
    cov = np.exp(np.interp(log_r, log_r_tab, log_cov_tab))
    t = 1 / (1 + r_eff**2)
    res = np.where(r_eff < 1e3, t * (1 - sf) + (1 - t) * cov, 0.0)
    return res.reshape(np.shape(r)) if np.shape(r) else res[0]


class MaternInterpolator:
    """``approximate_normalized_matern`` on the device: the blended
    log-log tables are made on the host once and kept as float32 on each
    device a call runs on; ``__call__`` computes on the device of the
    distance tensor it is given (``device``, the card by default, for an
    array)."""

    def __init__(self, nu: float, r0: float = 1.0, n_test_points: int = 1024):
        self.nu = float(nu)
        self.r0 = float(r0)
        self._tables = _matern_log_tables(nu, n_test_points)
        self._device_tables = {}

    def tables(self, device) -> tuple:
        """(log r, log structure function, log covariance), float32 on ``device``."""
        key = str(device)
        if key not in self._device_tables:
            self._device_tables[key] = tuple(torch.tensor(t, dtype=torch.float32, device=device)
                                             for t in self._tables)
        return self._device_tables[key]

    def __call__(self, r, device=None):
        (r,) = as_float32_tensors(r, device=device)
        log_r_tab, log_sf_tab, log_cov_tab = self.tables(r.device)
        r_eff = torch.clamp(torch.abs(r) / self.r0, min=1e-6)
        log_r = torch.log(r_eff)
        sf = torch.exp(interp(log_r, log_r_tab, log_sf_tab))
        cov = torch.exp(interp(log_r, log_r_tab, log_cov_tab))
        t = 1 / (1 + r_eff**2)
        return torch.where(r_eff < 1e3, t * (1 - sf) + (1 - t) * cov, 0.0)
