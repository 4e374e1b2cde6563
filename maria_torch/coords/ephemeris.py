"""Earth orientation and frame-rotation ephemeris
(maria_tpu/coords/ephemeris.py), host numpy in float64.

Closed-form trigonometry with no IERS tables: the exact rotation matrix
is evaluated at every timestamp, and the (n_t, 3, 3) stack is applied as
batched products. The arithmetic is maria_tpu's, term for term, so the
two packages agree to rounding.

Components and accuracy (against the full IAU models):
  - Earth rotation angle / GMST (IAU 2000/2006), with UT1 = UTC (error
    under ~1 s of rotation);
  - precession: IAU 2006 equatorial angles (zeta_A, z_A, theta_A);
  - nutation: 18-term truncation of IAU 1980 (under ~0.01" residual);
  - frame bias ICRS -> J2000 mean equator;
  - annual aberration from a low-precision solar ephemeris (under ~0.05");
  - polar motion and diurnal aberration neglected (under ~0.4").
"""

from __future__ import annotations

import numpy as np

ARCSEC = np.pi / 180 / 3600
TWO_PI = 2 * np.pi

# TT - UTC in seconds (37 leap seconds + 32.184), valid from 2017
TT_MINUS_UTC = 69.184

J2000_JD = 2451545.0
UNIX_J2000 = 946728000.0  # unix time of J2000.0 (2000-01-01 11:58:55.816 UTC ≈ 12:00 TT)


def unix_to_jd_utc(t):
    return np.asarray(t, dtype=np.float64) / 86400.0 + 2440587.5


def julian_centuries_tt(t):
    """Julian centuries of TT since J2000.0, from unix UTC."""
    return (np.asarray(t, dtype=np.float64) + TT_MINUS_UTC - UNIX_J2000) / (86400.0 * 36525.0)


def earth_rotation_angle(t):
    """ERA (radians), IAU 2000, with UT1 ≈ UTC."""
    Du = unix_to_jd_utc(t) - J2000_JD
    return TWO_PI * ((0.7790572732640 + 1.00273781191135448 * Du) % 1.0)


def gmst(t):
    """Greenwich mean sidereal time (radians), IAU 2006."""
    T = julian_centuries_tt(t)
    poly = (
        0.014506
        + 4612.156534 * T
        + 1.3915817 * T**2
        - 0.00000044 * T**3
        - 0.000029956 * T**4
    )
    return (earth_rotation_angle(t) + poly * ARCSEC) % TWO_PI


def mean_obliquity(T):
    """Mean obliquity of the ecliptic (radians), IAU 2006."""
    eps = 84381.406 - 46.836769 * T - 0.0001831 * T**2 + 0.00200340 * T**3
    return eps * ARCSEC


# IAU 1980 nutation series, 18 largest terms.
# columns: multipliers of (D, M, M', F, Omega), then psi_sin, psi_t, eps_cos, eps_t
# psi/eps coefficients in units of 0.0001 arcsec.
_NUTATION_TERMS = np.array(
    [
        [0, 0, 0, 0, 1, -171996, -174.2, 92025, 8.9],
        [-2, 0, 0, 2, 2, -13187, -1.6, 5736, -3.1],
        [0, 0, 0, 2, 2, -2274, -0.2, 977, -0.5],
        [0, 0, 0, 0, 2, 2062, 0.2, -895, 0.5],
        [0, 1, 0, 0, 0, 1426, -3.4, 54, -0.1],
        [0, 0, 1, 0, 0, 712, 0.1, -7, 0.0],
        [-2, 1, 0, 2, 2, -517, 1.2, 224, -0.6],
        [0, 0, 0, 2, 1, -386, -0.4, 200, 0.0],
        [0, 0, 1, 2, 2, -301, 0.0, 129, -0.1],
        [-2, -1, 0, 2, 2, 217, -0.5, -95, 0.3],
        [-2, 0, 1, 0, 0, -158, 0.0, 0, 0.0],
        [-2, 0, 0, 2, 1, 129, 0.1, -70, 0.0],
        [0, 0, -1, 2, 2, 123, 0.0, -53, 0.0],
        [2, 0, 0, 0, 0, 63, 0.0, 0, 0.0],
        [0, 0, 1, 0, 1, 63, 0.1, -33, 0.0],
        [2, 0, -1, 2, 2, -59, 0.0, 26, 0.0],
        [0, 0, -1, 0, 1, -58, -0.1, 32, 0.0],
        [0, 0, 1, 2, 1, -51, 0.0, 27, 0.0],
    ],
    dtype=np.float64,
)


def _delaunay_args(T):
    deg = np.pi / 180
    D = (297.85036 + 445267.111480 * T - 0.0019142 * T**2 + T**3 / 189474) * deg
    M = (357.52772 + 35999.050340 * T - 0.0001603 * T**2 - T**3 / 300000) * deg
    Mp = (134.96298 + 477198.867398 * T + 0.0086972 * T**2 + T**3 / 56250) * deg
    F = (93.27191 + 483202.017538 * T - 0.0036825 * T**2 + T**3 / 327270) * deg
    Om = (125.04452 - 1934.136261 * T + 0.0020708 * T**2 + T**3 / 450000) * deg
    return D, M, Mp, F, Om


def nutation(T):
    """(Δψ, Δε) in radians; truncated IAU 1980 series."""
    T = np.atleast_1d(np.asarray(T, dtype=np.float64))
    D, M, Mp, F, Om = _delaunay_args(T)
    mult = _NUTATION_TERMS[:, :5]  # (18, 5)
    args = (
        mult[:, 0, None] * D[None]
        + mult[:, 1, None] * M[None]
        + mult[:, 2, None] * Mp[None]
        + mult[:, 3, None] * F[None]
        + mult[:, 4, None] * Om[None]
    )  # (18, n)
    psi_coeff = (_NUTATION_TERMS[:, 5, None] + _NUTATION_TERMS[:, 6, None] * T[None]) * 1e-4
    eps_coeff = (_NUTATION_TERMS[:, 7, None] + _NUTATION_TERMS[:, 8, None] * T[None]) * 1e-4
    dpsi = (psi_coeff * np.sin(args)).sum(axis=0) * ARCSEC
    deps = (eps_coeff * np.cos(args)).sum(axis=0) * ARCSEC
    return dpsi, deps


def gast(t):
    """Greenwich apparent sidereal time (radians)."""
    T = julian_centuries_tt(t)
    dpsi, _ = nutation(T)
    return (gmst(t) + dpsi * np.cos(mean_obliquity(T))) % TWO_PI


def _R1(a):
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack(
        [
            np.stack([o, z, z], -1),
            np.stack([z, c, s], -1),
            np.stack([z, -s, c], -1),
        ],
        -2,
    )


def _R2(a):
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack(
        [
            np.stack([c, z, -s], -1),
            np.stack([z, o, z], -1),
            np.stack([s, z, c], -1),
        ],
        -2,
    )


def _R3(a):
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack(
        [
            np.stack([c, s, z], -1),
            np.stack([-s, c, z], -1),
            np.stack([z, z, o], -1),
        ],
        -2,
    )


# frame bias ICRS -> J2000 mean equator/equinox
_DALPHA0 = -0.0146 * ARCSEC
_XI0 = -0.016617 * ARCSEC
_ETA0 = -0.0068192 * ARCSEC
FRAME_BIAS = (_R1(np.float64(-_ETA0)) @ _R2(np.float64(_XI0)) @ _R3(np.float64(_DALPHA0)))


def precession_matrix(T):
    """J2000 mean -> mean-of-date, IAU 2006 equatorial angles."""
    T = np.asarray(T, dtype=np.float64)
    zeta = (2.650545 + 2306.083227 * T + 0.2988499 * T**2 + 0.01801828 * T**3
            - 0.000005971 * T**4 - 0.0000003173 * T**5) * ARCSEC
    z = (-2.650545 + 2306.077181 * T + 1.0927348 * T**2 + 0.01826837 * T**3
         - 0.000028596 * T**4 - 0.0000002904 * T**5) * ARCSEC
    theta = (2004.191903 * T - 0.4294934 * T**2 - 0.04182264 * T**3
             - 0.000007089 * T**4 - 0.0000001274 * T**5) * ARCSEC
    return _R3(-z) @ _R2(theta) @ _R3(-zeta)


def nutation_matrix(T):
    """Mean-of-date -> true-of-date."""
    dpsi, deps = nutation(T)
    eps = mean_obliquity(np.asarray(T, dtype=np.float64))
    return _R1(-(eps + deps)) @ _R3(-dpsi) @ _R1(eps)


def icrs_to_tod_matrix(t):
    """(n_t, 3, 3): ICRS -> true equator & equinox of date."""
    T = np.atleast_1d(julian_centuries_tt(t))
    return nutation_matrix(T) @ precession_matrix(T) @ FRAME_BIAS


def earth_velocity_over_c(t):
    """Earth barycentric velocity / c in ICRS equatorial coords (n_t, 3).

    Low-precision solar ephemeris; |β| ≈ 1e-4 (≈ 20.5" of aberration).
    """
    T = np.atleast_1d(julian_centuries_tt(t))
    deg = np.pi / 180
    L0 = (280.46646 + 36000.76983 * T + 0.0003032 * T**2) * deg
    M = (357.52911 + 35999.05029 * T - 0.0001537 * T**2) * deg
    e = 0.016708634 - 0.000042037 * T
    C = (
        (1.914602 - 0.004817 * T) * np.sin(M)
        + 0.019993 * np.sin(2 * M)
        + 0.000289 * np.sin(3 * M)
    ) * deg
    lam = L0 + C  # sun's true longitude
    pi_peri = (102.93735 + 0.32328 * T) * deg  # longitude of perihelion (of sun's orbit)
    eps = mean_obliquity(T)

    # Earth's orbital velocity in the ecliptic plane (km/s), standard
    # two-body result with the sun-longitude parametrization
    v0 = 29.7847 / np.sqrt(1 - e**2)
    vx_ecl = v0 * (np.sin(lam) + e * np.sin(pi_peri))
    vy_ecl = -v0 * (np.cos(lam) + e * np.cos(pi_peri))

    c_km_s = 299792.458
    beta = np.stack(
        [vx_ecl, vy_ecl * np.cos(eps), vy_ecl * np.sin(eps)],
        axis=-1,
    ) / c_km_s
    return beta


def enu_to_tod_matrix(t, lat, lon):
    """(n_t, 3, 3): topocentric East-North-Up -> true-of-date equatorial.

    Columns are the E, N, U basis vectors expressed in the equatorial
    frame at local apparent sidereal time GAST + lon (geodetic lat/lon
    in radians).
    """
    theta_L = gast(t) + lon
    theta_L = np.atleast_1d(theta_L)
    sL, cL = np.sin(theta_L), np.cos(theta_L)
    sphi, cphi = np.sin(lat), np.cos(lat)
    z = np.zeros_like(sL)
    E = np.stack([-sL, cL, z], axis=-1)
    N = np.stack([-sphi * cL, -sphi * sL, cphi + z], axis=-1)
    U = np.stack([cphi * cL, cphi * sL, sphi + z], axis=-1)
    return np.stack([E, N, U], axis=-1)


# ICRS -> galactic rotation (Hipparcos convention; rows are the galactic
# basis vectors in ICRS coordinates)
ICRS_TO_GAL = np.array(
    [
        [-0.0548755604162154, -0.8734370902348850, -0.4838350155487132],
        [0.4941094278755837, -0.4448296299600112, 0.7469822444972189],
        [-0.8676661490190047, -0.1980763734312015, 0.4559837761750669],
    ],
    dtype=np.float64,
)
