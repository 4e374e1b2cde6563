"""Approximate lensed ΛCDM CMB power spectra (maria_tpu/cmb/spectra.py).

The reference fetches CAMB-computed spectra from its data repository
(reference: maria/cmb/generation.py:36-58). Offline, we embed a compact
anchor table of the Planck-2018-like lensed TT/EE/BB/TE spectra
(D_l = l(l+1)C_l/2π in μK²) and log-interpolate between anchors. This is
a simulator-grade approximation: acoustic peak positions and amplitudes
are right at the ~10% level, which is what matters for synthesizing
realistic time streams; it is NOT a cosmology-grade spectrum.
"""

from __future__ import annotations

import numpy as np

# (ell, D_l^TT [uK^2]) anchors through the acoustic peaks and damping tail
_TT_ANCHORS = np.array([
    [2, 1000], [10, 850], [30, 850], [50, 1400], [100, 3000], [150, 4700],
    [220, 5750], [320, 3900], [416, 1650], [537, 2550], [675, 1800],
    [810, 2500], [950, 1200], [1120, 1250], [1300, 750], [1500, 350],
    [1750, 190], [2000, 95], [2500, 30], [3000, 11], [4000, 3],
])

_EE_ANCHORS = np.array([
    [2, 0.03], [10, 0.02], [50, 0.3], [100, 1.0], [140, 1.1], [200, 0.8],
    [300, 8.0], [390, 22.0], [500, 12.0], [690, 40.0], [850, 25.0],
    [1000, 42.0], [1200, 25.0], [1500, 20.0], [2000, 7.0], [3000, 1.0],
])

_BB_ANCHORS = np.array([
    [2, 0.0001], [50, 0.002], [100, 0.01], [200, 0.02], [400, 0.05],
    [700, 0.09], [1000, 0.10], [1500, 0.09], [2000, 0.06], [3000, 0.03],
])

# TE correlation coefficient anchors: rho = C_TE / sqrt(C_TT C_EE)
_TE_RHO_ANCHORS = np.array([
    [2, 0.3], [30, 0.4], [100, -0.3], [150, -0.5], [220, 0.2], [310, 0.6],
    [420, -0.3], [550, 0.4], [700, -0.3], [900, 0.3], [1200, -0.2],
    [2000, 0.1], [4000, 0.0],
])


def _interp_anchors(anchors, ells):
    return np.exp(
        np.interp(np.log(np.clip(ells, 2, None)), np.log(anchors[:, 0]), np.log(np.clip(anchors[:, 1], 1e-30, None)))
    )


def get_cmb_spectrum(lmax: int = 3000) -> dict:
    """C_l in K_CMB^2 for TT/EE/BB/TE, l = 0..lmax."""
    ells = np.arange(lmax + 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        to_cl = np.where(ells > 1, 2 * np.pi / (ells * (ells + 1) + 1e-16), 0.0) * 1e-12  # uK^2 -> K^2
    tt = _interp_anchors(_TT_ANCHORS, ells) * to_cl
    ee = _interp_anchors(_EE_ANCHORS, ells) * to_cl
    bb = _interp_anchors(_BB_ANCHORS, ells) * to_cl
    rho = np.interp(ells, _TE_RHO_ANCHORS[:, 0], _TE_RHO_ANCHORS[:, 1])
    te = rho * np.sqrt(tt * ee)
    for cl in (tt, ee, bb, te):
        cl[:2] = 0.0
    return {"TT": tt, "EE": ee, "BB": bb, "TE": te, "ell": ells}
