"""HEALPix pixelization, RING scheme (maria_tpu/healpix/core.py).

The ring tables, ``pix2ang_ring`` and the NESTED <-> RING maps run in
host numpy; ``ang2pix_ring`` runs in torch on the device of its angles,
with its integer parts in int32 as maria_tpu computes them.

Conventions match HEALPix: theta is the colatitude in [0, pi], phi the
longitude in [0, 2pi); npix = 12 nside^2.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "ang2pix_ring", "nest2ring", "npix2nside", "nside2npix", "pix2ang_ring", "reorder", "ring2nest", "ring_info",
]


def nside2npix(nside: int) -> int:
    return 12 * nside * nside


def npix2nside(npix: int) -> int:
    nside = int(round(np.sqrt(npix / 12)))
    if 12 * nside * nside != npix:
        raise ValueError(f"{npix} is not a valid HEALPix map size.")
    return nside


def ang2pix_ring(nside: int, theta, phi):
    """RING-scheme pixel index (int32) of (colatitude, longitude) tensors."""
    z = torch.cos(theta)
    za = torch.abs(z)
    tt = torch.remainder(phi, 2 * np.pi) / (np.pi / 2)  # in [0, 4)

    # equatorial belt: |z| <= 2/3
    temp1 = nside * (0.5 + tt)
    temp2 = nside * z * 0.75
    jp = torch.floor(temp1 - temp2).to(torch.int32)
    jm = torch.floor(temp1 + temp2).to(torch.int32)
    ir_eq = nside + 1 + jp - jm  # ring counted from z = 2/3, in [1, 2 nside + 1]
    kshift = 1 - (ir_eq & 1)
    ip_eq = torch.remainder(torch.div(jp + jm - nside + kshift + 1, 2, rounding_mode="floor"), 4 * nside)
    ncap = 2 * nside * (nside - 1)
    pix_eq = ncap + (ir_eq - 1) * 4 * nside + ip_eq

    # polar caps
    tp = tt - torch.floor(tt)
    tmp = nside * torch.sqrt(3 * (1 - za))
    jp_c = torch.floor(tp * tmp).to(torch.int32)
    jm_c = torch.floor((1 - tp) * tmp).to(torch.int32)
    ir_c = jp_c + jm_c + 1
    ip_c = torch.remainder(torch.floor(tt * ir_c).to(torch.int32), 4 * ir_c)
    pix_north = 2 * ir_c * (ir_c - 1) + ip_c
    pix_south = nside2npix(nside) - 2 * ir_c * (ir_c + 1) + ip_c

    pix_cap = torch.where(z > 0, pix_north, pix_south)
    return torch.where(za <= 2 / 3, pix_eq, pix_cap).to(torch.int32)


def ring_info(nside: int):
    """Host table of the 4 nside - 1 isolatitude rings: per ring (0-based
    from the north pole) n_pix, start (first pixel), z (cos colatitude)
    and shift (phi offset of the first pixel, in pixel spacings)."""
    n_rings = 4 * nside - 1
    i = np.arange(1, n_rings + 1)  # 1-based ring index

    north_cap = i < nside
    south_cap = i > 3 * nside
    equatorial = ~(north_cap | south_cap)

    n_pix = np.where(north_cap, 4 * i, np.where(south_cap, 4 * (4 * nside - i), 4 * nside))

    z = np.empty(n_rings)
    z[north_cap] = 1 - (i[north_cap] ** 2) / (3 * nside**2)
    z[equatorial] = 4 / 3 - 2 * i[equatorial] / (3 * nside)
    i_s = 4 * nside - i[south_cap]
    z[south_cap] = -(1 - (i_s**2) / (3 * nside**2))

    # cap rings start half a pixel in; equatorial rings alternate 0 / half
    s = np.where(equatorial, (i - nside + 1) % 2, 1)
    shift = np.where(equatorial, 0.5 * s, 0.5)

    start = np.zeros(n_rings, dtype=np.int64)
    start[1:] = np.cumsum(n_pix)[:-1]

    return {"n_pix": n_pix.astype(np.int64), "start": start, "z": z, "shift": shift}


def pix2ang_ring(nside: int, pix):
    """(colatitude, longitude) of RING pixels; host numpy."""
    pix = np.asarray(pix, dtype=np.int64)
    npix = nside2npix(nside)
    ncap = 2 * nside * (nside - 1)

    theta = np.empty(pix.shape)
    phi = np.empty(pix.shape)

    north = pix < ncap
    south = pix >= npix - ncap
    eq = ~(north | south)

    p = pix[north]
    ir = np.floor(0.5 * (1 + np.sqrt(1 + 2 * p))).astype(np.int64)
    ip = p - 2 * ir * (ir - 1)
    theta[north] = np.arccos(1 - ir**2 / (3 * nside**2))
    phi[north] = (ip + 0.5) * np.pi / (2 * ir)

    p = pix[eq] - ncap
    ir = p // (4 * nside) + nside  # in [nside, 3 nside]
    ip = p % (4 * nside)
    s = (ir - nside + 1) % 2
    theta[eq] = np.arccos(4 / 3 - 2 * ir / (3 * nside))
    phi[eq] = (ip + 0.5 * s) * np.pi / (2 * nside)

    p = npix - 1 - pix[south]
    ir = np.floor(0.5 * (1 + np.sqrt(1 + 2 * p))).astype(np.int64)
    ip = p - 2 * ir * (ir - 1)
    theta[south] = np.arccos(-(1 - ir**2 / (3 * nside**2)))
    phi[south] = (4 * ir - ip - 0.5) * np.pi / (2 * ir) % (2 * np.pi)

    return theta, phi


# NESTED <-> RING (host numpy): the ordering of healpy-written maps
_JRLL = np.array([2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4])
_JPLL = np.array([1, 3, 5, 7, 0, 2, 4, 6, 1, 3, 5, 7])


def _compress_bits(v):
    """The even-position bits of v packed together (inverse of a bit
    interleave), for int64 up to 2 x 29 bits."""
    v = v & 0x5555555555555555
    v = (v | (v >> 1)) & 0x3333333333333333
    v = (v | (v >> 2)) & 0x0F0F0F0F0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF00FF00FF
    v = (v | (v >> 8)) & 0x0000FFFF0000FFFF
    v = (v | (v >> 16)) & 0x00000000FFFFFFFF
    return v


def nest2ring(nside: int, pix):
    """RING index of NESTED pixel(s) (healpy.nest2ring)."""
    if nside & (nside - 1):
        raise ValueError("NESTED ordering requires a power-of-2 nside.")
    pix = np.asarray(pix, dtype=np.int64)
    npface = nside * nside
    f = pix // npface
    pf = pix & (npface - 1)
    x = _compress_bits(pf)
    y = _compress_bits(pf >> 1)

    jr = _JRLL[f] * nside - x - y - 1  # 1-based ring index from the north pole
    north = jr < nside
    south = jr > 3 * nside
    nr = np.where(north, jr, np.where(south, 4 * nside - jr, nside))
    n_before = np.where(
        north,
        2 * nr * (nr - 1),
        np.where(south, nside2npix(nside) - 2 * nr * (nr + 1), 2 * nside * (nside - 1) + (jr - nside) * 4 * nside),
    )
    kshift = np.where(north | south, 0, (jr - nside) & 1)
    jp = (_JPLL[f] * nr + x - y + 1 + kshift) // 2
    jp = np.where(jp > 4 * nr, jp - 4 * nr, jp)
    jp = np.where(jp < 1, jp + 4 * nr, jp)
    return n_before + jp - 1


def ring2nest(nside: int, pix):
    """NESTED index of RING pixel(s): the inverse permutation of nest2ring."""
    n2r = nest2ring(nside, np.arange(nside2npix(nside)))
    r2n = np.empty_like(n2r)
    r2n[n2r] = np.arange(len(n2r))
    return r2n[np.asarray(pix, dtype=np.int64)]


def reorder(m, n2r: bool = False, r2n: bool = False):
    """Reorder map(s) between NESTED and RING (healpy.reorder)."""
    m = np.asarray(m)
    nside = npix2nside(m.shape[-1])
    if n2r:  # input NESTED -> output RING
        idx = nest2ring(nside, np.arange(m.shape[-1]))
        out = np.empty_like(m)
        out[..., idx] = m
        return out
    if r2n:
        idx = nest2ring(nside, np.arange(m.shape[-1]))
        return m[..., idx]
    raise ValueError("Give one of n2r=True or r2n=True.")
