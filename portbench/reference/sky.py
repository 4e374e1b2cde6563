"""The sky side of a polarized realization, in float64 plain numpy and
torch, with none of the program's code: where each detector looks on
the sky, which HEALPix pixel that is, and what the bands see of the CMB.

- ``azel_to_radec``: a site's apparent az/el to ICRS (ra, dec): the
  Earth rotation angle and IAU 2006 sidereal time with UT1 = UTC, the
  IAU 2006 precession angles, the 18 largest terms of the IAU 1980
  nutation, the ICRS frame bias and the annual aberration of a
  low-precision solar ephemeris, the model the simulator states;
- ``boresight_radec``: the boresight's (ra, dec) and the angle q(t) by
  which tangent-plane offsets about it in az/el turn into offsets in
  ra/dec, read from a point 1e-5 rad above it; a detector's (ra, dec) is
  its offset turned by q about the boresight's, the simulator's pointing
  model;
- ``radec_to_galactic``, ``ring_pixels``: galactic coordinates, and the
  HEALPix RING pixel of (colatitude, longitude) after Gorski et al., ApJ
  622, 759 (2005);
- ``rj_power_per_kelvin``, ``cmb_band_powers``: k_B times the
  passband's integral (halved for a polarized band), and a band's
  loading by blackbodies at T_CMB and T_CMB + 1e-6 K through it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .common import C, F64, H, K_B, offsets_to_phi_theta, phi_theta_to_offsets

ARCSEC = math.pi / 180 / 3600
TT_MINUS_UTC = 69.184  # s: 37 leap seconds + 32.184
UNIX_J2000 = 946728000.0  # unix time of J2000.0
T_CMB = 2.72548
DT_CMB = 1e-6  # K: the step of the two-point dP/dT

# IAU 1980 nutation, the 18 largest terms: multipliers of (D, M, M', F, Omega);
# psi sin and its T rate, eps cos and its T rate, in 1e-4 arcsec
NUTATION = np.array([
    [0, 0, 0, 0, 1, -171996, -174.2, 92025, 8.9], [-2, 0, 0, 2, 2, -13187, -1.6, 5736, -3.1],
    [0, 0, 0, 2, 2, -2274, -0.2, 977, -0.5], [0, 0, 0, 0, 2, 2062, 0.2, -895, 0.5],
    [0, 1, 0, 0, 0, 1426, -3.4, 54, -0.1], [0, 0, 1, 0, 0, 712, 0.1, -7, 0.0],
    [-2, 1, 0, 2, 2, -517, 1.2, 224, -0.6], [0, 0, 0, 2, 1, -386, -0.4, 200, 0.0],
    [0, 0, 1, 2, 2, -301, 0.0, 129, -0.1], [-2, -1, 0, 2, 2, 217, -0.5, -95, 0.3],
    [-2, 0, 1, 0, 0, -158, 0.0, 0, 0.0], [-2, 0, 0, 2, 1, 129, 0.1, -70, 0.0],
    [0, 0, -1, 2, 2, 123, 0.0, -53, 0.0], [2, 0, 0, 0, 0, 63, 0.0, 0, 0.0],
    [0, 0, 1, 0, 1, 63, 0.1, -33, 0.0], [2, 0, -1, 2, 2, -59, 0.0, 26, 0.0],
    [0, 0, -1, 0, 1, -58, -0.1, 32, 0.0], [0, 0, 1, 2, 1, -51, 0.0, 27, 0.0],
])


def rotation(axis: int, a):
    """(n, 3, 3) rotations of the frame by angles ``a`` about ``axis``."""
    a = np.atleast_1d(np.asarray(a, dtype=float))
    c, s = np.cos(a), np.sin(a)
    R = np.zeros((len(a), 3, 3))
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    R[:, axis, axis] = 1.0
    R[:, i, i], R[:, j, j], R[:, i, j], R[:, j, i] = c, c, s, -s
    return R


def centuries_tt(t):
    return (np.asarray(t, dtype=float) + TT_MINUS_UTC - UNIX_J2000) / (86400.0 * 36525.0)


def obliquity(T):
    return (84381.406 - 46.836769 * T - 0.0001831 * T**2 + 0.00200340 * T**3) * ARCSEC


def nutation(T):
    """(dpsi, deps) in radians."""
    deg = math.pi / 180
    args = np.stack([
        (297.85036 + 445267.111480 * T - 0.0019142 * T**2 + T**3 / 189474) * deg,
        (357.52772 + 35999.050340 * T - 0.0001603 * T**2 - T**3 / 300000) * deg,
        (134.96298 + 477198.867398 * T + 0.0086972 * T**2 + T**3 / 56250) * deg,
        (93.27191 + 483202.017538 * T - 0.0036825 * T**2 + T**3 / 327270) * deg,
        (125.04452 - 1934.136261 * T + 0.0020708 * T**2 + T**3 / 450000) * deg,
    ])
    phase = NUTATION[:, :5] @ args
    dpsi = ((NUTATION[:, 5, None] + NUTATION[:, 6, None] * T) * 1e-4 * np.sin(phase)).sum(0) * ARCSEC
    deps = ((NUTATION[:, 7, None] + NUTATION[:, 8, None] * T) * 1e-4 * np.cos(phase)).sum(0) * ARCSEC
    return dpsi, deps


def sidereal_angle(t, lon: float):
    """Local apparent sidereal time: ERA + the IAU 2006 GMST polynomial +
    the equation of the equinoxes + the east longitude (radians)."""
    T = centuries_tt(t)
    du = np.asarray(t, dtype=float) / 86400.0 + 2440587.5 - 2451545.0
    era = 2 * math.pi * ((0.7790572732640 + 1.00273781191135448 * du) % 1.0)
    poly = 0.014506 + 4612.156534 * T + 1.3915817 * T**2 - 0.00000044 * T**3 - 0.000029956 * T**4
    dpsi, _ = nutation(T)
    return (era + poly * ARCSEC) % (2 * math.pi) + dpsi * np.cos(obliquity(T)) + lon


def icrs_to_true(t):
    """(n, 3, 3): ICRS to the true equator and equinox of date (nutation x
    precession x frame bias)."""
    T = centuries_tt(t)
    zeta = (2.650545 + 2306.083227 * T + 0.2988499 * T**2 + 0.01801828 * T**3 - 0.000005971 * T**4
            - 0.0000003173 * T**5) * ARCSEC
    z = (-2.650545 + 2306.077181 * T + 1.0927348 * T**2 + 0.01826837 * T**3 - 0.000028596 * T**4
         - 0.0000002904 * T**5) * ARCSEC
    theta = (2004.191903 * T - 0.4294934 * T**2 - 0.04182264 * T**3 - 0.000007089 * T**4
             - 0.0000001274 * T**5) * ARCSEC
    P = rotation(2, -z) @ rotation(1, theta) @ rotation(2, -zeta)
    dpsi, deps = nutation(T)
    eps = obliquity(T)
    N = rotation(0, -(eps + deps)) @ rotation(2, -dpsi) @ rotation(0, eps)
    bias = rotation(0, 0.0068192 * ARCSEC) @ rotation(1, -0.016617 * ARCSEC) @ rotation(2, -0.0146 * ARCSEC)
    return N @ P @ bias


def earth_velocity(t):
    """(n, 3): the Earth's velocity over c in ICRS axes, from the Sun's
    true longitude of a low-precision solar ephemeris."""
    T = centuries_tt(t)
    deg = math.pi / 180
    M = (357.52911 + 35999.05029 * T - 0.0001537 * T**2) * deg
    e = 0.016708634 - 0.000042037 * T
    lam = (280.46646 + 36000.76983 * T + 0.0003032 * T**2) * deg + (
        (1.914602 - 0.004817 * T) * np.sin(M) + 0.019993 * np.sin(2 * M) + 0.000289 * np.sin(3 * M)) * deg
    peri = (102.93735 + 0.32328 * T) * deg
    eps = obliquity(T)
    v = 29.7847 / np.sqrt(1 - e**2)
    vx, vy = v * (np.sin(lam) + e * np.sin(peri)), -v * (np.cos(lam) + e * np.cos(peri))
    return np.stack([vx, vy * np.cos(eps), vy * np.sin(eps)], axis=-1) / (C / 1e3)


def azel_to_radec(az, el, t, lat: float, lon: float):
    """ICRS (ra, dec) of apparent (az, el), (..., n_t) arrays at unix times
    ``t``, from the site at geodetic (lat, lon) radians: the East-North-Up
    direction turned to the true equator by the local sidereal angle, to
    ICRS, less the aberration."""
    az, el = np.asarray(az, dtype=float), np.asarray(el, dtype=float)
    st = sidereal_angle(t, lon)
    sL, cL, sp_, cp = np.sin(st), np.cos(st), math.sin(lat), math.cos(lat)
    east = np.sin(az) * np.cos(el)
    north = np.cos(az) * np.cos(el)
    up = np.sin(el)
    v_true = np.stack([-sL * east - sp_ * cL * north + cp * cL * up,
                       cL * east - sp_ * sL * north + cp * sL * up,
                       cp * north + sp_ * up], axis=-1)
    v = np.einsum("tji,...tj->...ti", icrs_to_true(t), v_true) - earth_velocity(t)
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    return np.arctan2(v[..., 1], v[..., 0]) % (2 * math.pi), np.arcsin(np.clip(v[..., 2], -1, 1))


def boresight_radec(bs_az, bs_el, t, lat: float, lon: float) -> tuple:
    """(ra, dec, q) of the boresight at unix times ``t``: q(t) is the angle
    from the dec direction at which a point 1e-5 rad above the boresight
    in az/el lies about the boresight in ra/dec."""
    bs_az, bs_el = (torch.as_tensor(np.asarray(a, dtype=float), dtype=F64) for a in (bs_az, bs_el))
    az_p, el_p = offsets_to_phi_theta(torch.zeros((), dtype=F64), torch.full((), 1e-5, dtype=F64), bs_az, bs_el)
    ra, dec = azel_to_radec(bs_az.numpy(), bs_el.numpy(), t, lat, lon)
    ra_p, dec_p = azel_to_radec(az_p.numpy(), el_p.numpy(), t, lat, lon)
    x, y = phi_theta_to_offsets(torch.as_tensor(ra_p), torch.as_tensor(dec_p), torch.as_tensor(ra),
                                torch.as_tensor(dec))
    return ra, dec, np.arctan2(-x.numpy(), y.numpy())


# ICRS to galactic (the Hipparcos convention): rows are the galactic axes in ICRS
ICRS_TO_GALACTIC = np.array([
    [-0.0548755604162154, -0.8734370902348850, -0.4838350155487132],
    [0.4941094278755837, -0.4448296299600112, 0.7469822444972189],
    [-0.8676661490190047, -0.1980763734312015, 0.4559837761750669],
])


def radec_to_galactic(ra, dec):
    """Galactic (l, b) of ICRS (ra, dec) tensors."""
    R = torch.as_tensor(ICRS_TO_GALACTIC, dtype=ra.dtype, device=ra.device)
    v = torch.stack([torch.cos(ra) * torch.cos(dec), torch.sin(ra) * torch.cos(dec), torch.sin(dec)], dim=-1) @ R.T
    return torch.atan2(v[..., 1], v[..., 0]), torch.asin(torch.clamp(v[..., 2], -1, 1))


def ring_pixels(nside: int, theta, phi):
    """HEALPix RING pixel (int64) of colatitude ``theta`` and longitude
    ``phi``, float64 tensors."""
    z = torch.cos(theta)
    za = z.abs()
    tt = torch.remainder(phi, 2 * math.pi) / (math.pi / 2)
    t1 = nside * (0.5 + tt)
    t2 = nside * z * 0.75
    jp = torch.floor(t1 - t2).long()
    jm = torch.floor(t1 + t2).long()
    ir = nside + 1 + jp - jm
    kshift = 1 - (ir & 1)
    ip = torch.remainder(torch.div(jp + jm - nside + kshift + 1, 2, rounding_mode="floor"), 4 * nside)
    equator = 2 * nside * (nside - 1) + (ir - 1) * 4 * nside + ip
    tp = tt - torch.floor(tt)
    tmp = nside * torch.sqrt(3 * (1 - za))
    jp = torch.floor(tp * tmp).long()
    jm = torch.floor((1 - tp) * tmp).long()
    ir = jp + jm + 1
    ip = torch.remainder(torch.floor(tt * ir).long(), 4 * ir)
    north = 2 * ir * (ir - 1) + ip
    south = 12 * nside**2 - 2 * ir * (ir + 1) + ip
    return torch.where(za <= 2 / 3, equator, torch.where(z > 0, north, south))


def rj_power_per_kelvin(nu, passband, polarized: bool) -> float:
    """W per K_RJ: k_B times the passband's integral, halved for a
    polarized band."""
    return (0.5 if polarized else 1.0) * K_B * float(np.trapezoid(passband, nu))


def cmb_band_powers(nu, passband) -> tuple:
    """(P0, dP/dT) in pW: 1e12 k_B times the integral of the Rayleigh-Jeans
    temperature of a blackbody at T_CMB through the passband, and its
    two-point derivative over DT_CMB."""
    def power(T):
        planck = 2 * H * nu**3 / C**2 / np.expm1(H * nu / (K_B * T))
        return 1e12 * K_B * float(np.trapezoid(planck * C**2 / (2 * K_B * nu**2) * passband, nu))

    P0 = power(T_CMB)
    return P0, (power(T_CMB + DT_CMB) - P0) / DT_CMB
