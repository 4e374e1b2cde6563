"""Spherical harmonic transforms on HEALPix grids, scalar and spin-2
(maria_tpu/healpix/sht.py).

All theta-dependence comes from Wigner-d elements,
``sY_lm(theta, phi) = (-1)^m sqrt((2l+1)/4pi) d^l_{-m,s}(theta) e^{im phi}``,
made by the three-term recursion in l from closed-form seeds at
l = max(m, |s|), with a shared power-of-2^60 exponent a lane so float32
never underflows near the poles. Only the northern rings are computed;
the southern ones follow from parity, which for spin fields swaps s and
-s, so the spin-2 transforms run the s = +2 and s = -2 recursions.

Where each part runs:
- the recursion, seed and sign tables: host numpy in float64, cast to
  float32 (built once per (lmax, nside, spin));
- the recursion itself: kernels KS1 (synthesis) and KS2 (analysis),
  ``ops/sht.py``, on the device of the a_lm or maps;
- the equatorial belt's ring FFTs (rings of 4 nside pixels, no
  m-aliasing for lmax < 4 nside): ``torch.fft`` on that device;
- the polar caps (rings of 4 (r + 1) pixels, m-aliased): one batched
  chirp-z transform over every cap ring of both hemispheres in
  complex128 (``torch.fft`` at one power-of-two length) on that device,
  cast to float32 at the end; no host copy of a map or an accumulator.

Polarization follows healpy/HEALPix (COSMO): Q + iU = -sum_lm (aE + i aB)_lm 2Y_lm.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import scipy.special as sps
import torch

from ..device import resolve_device
from ..ops.sht import sht_anal, sht_synth
from .core import nside2npix, npix2nside, ring_info

__all__ = [
    "alm2map", "alm2map_spin", "alm_index", "map2alm", "map2alm_spin", "synalm", "synalm_cmb", "synalm_cmb_device",
]


def alm_index(lmax: int):
    return np.tril_indices(lmax + 1)


# -- random a_lm (host float64, as maria_tpu draws them) ------------------------------------
def _unit_alm(lmax: int, rng) -> np.ndarray:
    """a_lm of unit variance a (l, m): m = 0 real N(0, 1), m > 0 complex
    with unit total variance."""
    L = lmax + 1
    alm = np.zeros((L, L), dtype=complex)
    alm[:, 0] = rng.standard_normal(L)
    re = rng.standard_normal((L, L))
    im = rng.standard_normal((L, L))
    rows, cols = np.tril_indices(L)
    sel = cols >= 1
    alm[rows[sel], cols[sel]] = (re[rows[sel], cols[sel]] + 1j * im[rows[sel], cols[sel]]) / np.sqrt(2)
    return alm


def _padded_cl(spectra: dict, name: str, lmax: int) -> np.ndarray:
    c = np.asarray(spectra.get(name, np.zeros(lmax + 1)), dtype=float)
    return np.pad(c[: lmax + 1], (0, max(0, lmax + 1 - len(c))))


def synalm(cl, lmax: int = None, seed: int = None) -> np.ndarray:
    """a_lm ~ N(0, C_l), complex, indexed [l, m]; host numpy."""
    rng = np.random.default_rng(seed)
    cl = np.asarray(cl, dtype=float)
    lmax = lmax if lmax is not None else len(cl) - 1
    cl = np.pad(cl[: lmax + 1], (0, max(0, lmax + 1 - len(cl))))
    return _unit_alm(lmax, rng) * np.sqrt(np.clip(cl, 0, None))[:, None]


def _cmb_factors(spectra: dict, lmax: int):
    """(cT, cTE, cE, cB): per l, the Cholesky factors of [[TT, TE], [TE,
    EE]] and the root of BB."""
    TT, EE, BB, TE = (_padded_cl(spectra, name, lmax) for name in ("TT", "EE", "BB", "TE"))
    cT = np.sqrt(np.clip(TT, 0, None))
    with np.errstate(divide="ignore", invalid="ignore"):
        cTE = np.where(cT > 0, TE / np.where(cT > 0, cT, 1.0), 0.0)
    cE = np.sqrt(np.clip(EE - cTE**2, 0, None))
    return cT, cTE, cE, np.sqrt(np.clip(BB, 0, None))


def synalm_cmb(spectra: dict, lmax: int, seed: int = None):
    """Correlated (aT, aE, aB) from TT/EE/BB/TE spectra; host numpy. Per
    l, (aT, aE) are jointly Gaussian with covariance [[TT, TE], [TE, EE]]
    (Cholesky), aB independent with BB."""
    rng = np.random.default_rng(seed)
    cT, cTE, cE, cB = _cmb_factors(spectra, lmax)
    xi1, xi2, xi3 = (_unit_alm(lmax, rng) for _ in range(3))
    return xi1 * cT[:, None], xi1 * cTE[:, None] + xi2 * cE[:, None], xi3 * cB[:, None]


def synalm_cmb_device(spectra: dict, lmax: int, generator: torch.Generator):
    """(aT, aE, aB) drawn from ``generator`` on its device: complex64 (L,
    L) [l, m], m = 0 real, each m > 0 part of variance 1/2, (aT, aE)
    through the TE Cholesky factor. Only the O(lmax) factors cross from
    the host. The draws are torch's, not numpy's: the same spectra, another
    realization than ``synalm_cmb``'s."""
    device = generator.device
    L = lmax + 1
    f32 = dict(dtype=torch.float32, device=device)
    tri = torch.tril(torch.ones((L, L), **f32))
    half = torch.where(torch.arange(L, device=device)[None, :] == 0, 1.0, float(1 / np.sqrt(2.0))) * tri
    imag_half = half.clone()
    imag_half[:, 0] = 0.0  # m = 0 is real

    def unit():
        re = torch.randn((L, L), generator=generator, **f32) * half
        im = torch.randn((L, L), generator=generator, **f32) * imag_half
        return torch.complex(re, im)

    cT, cTE, cE, cB = (torch.as_tensor(c, **f32)[:, None] for c in _cmb_factors(spectra, lmax))
    x1, x2, x3 = unit(), unit(), unit()
    return x1 * cT, x1 * cTE + x2 * cE, x3 * cB


# -- host tables ---------------------------------------------------------------------------
@lru_cache(maxsize=32)
def _ring_geometry(nside: int):
    rings = ring_info(nside)
    nh = 2 * nside  # northern rings with the equator (index nh - 1)
    return rings, nh, rings["z"][:nh].copy()


@lru_cache(maxsize=32)
def _recursion_tables(lmax: int, spin: int):
    """alpha/beta/gamma[l, m] (float32) of the raw Wigner-d recursion
    d_l = (alpha x + beta) d_{l-1} - gamma d_{l-2}, zero outside the
    valid region l > max(m, |spin|)."""
    L = lmax + 1
    ell = np.arange(L, dtype=float)[:, None]
    m = np.arange(L, dtype=float)[None, :]
    s = float(spin)
    lmin = np.maximum(m, abs(s))
    with np.errstate(invalid="ignore", divide="ignore"):
        D = (ell - 1) * np.sqrt((ell**2 - m**2) * (ell**2 - s**2))
        alpha = (2 * ell - 1) * ell * (ell - 1) / D
        beta = (2 * ell - 1) * m * s / D
        gamma = ell * np.sqrt(((ell - 1) ** 2 - m**2) * ((ell - 1) ** 2 - s**2)) / D
    valid = ell > lmin
    alpha = np.where(valid, alpha, 0.0)
    beta = np.where(valid, beta, 0.0)
    gamma = np.where(valid & (ell - 1 > lmin), gamma, 0.0)
    if spin == 0:
        # the l = 1, m = 0 step divides by (l - 1) = 0; d^1_00 = x d^0_00
        alpha[1, 0], beta[1, 0], gamma[1, 0] = 1.0, 0.0, 0.0
    return alpha.astype(np.float32), beta.astype(np.float32), gamma.astype(np.float32)


def _seed_from_log(log_mag: np.ndarray, sign: np.ndarray):
    """A log magnitude split into (value in ~[2^-30, 2^30), exponent k of
    2^-60) for the rescaled lanes."""
    e2 = log_mag / np.log(2.0)
    k = np.maximum(0, np.ceil((-30.0 - e2) / 60.0)).astype(np.int32)
    val = sign * np.exp2(e2 + 60.0 * k)
    return val.astype(np.float32), k


@lru_cache(maxsize=32)
def _seed_tables(lmax: int, nside: int, spin: int):
    """Seed (value, exponent) arrays (L, nh) of d^{lmin}_{-m, s} at each
    northern ring, and the seed step lmin(m) of each m."""
    _, nh, z_n = _ring_geometry(nside)
    L = lmax + 1
    s = int(spin)
    m = np.arange(L, dtype=float)[:, None]
    lsh = 0.5 * np.log((1.0 - z_n) / 2.0)[None, :]  # log sin(b/2)
    lch = 0.5 * np.log((1.0 + z_n) / 2.0)[None, :]  # log cos(b/2)

    # at l = m (m >= |s|): d^m_{-m,s} = sqrt((2m)!/((m-s)!(m+s)!)) cos(b/2)^(m-s) sin(b/2)^(m+s)
    with np.errstate(invalid="ignore"):
        log_mag = (
            0.5 * (sps.gammaln(2 * m + 1) - sps.gammaln(m - s + 1) - sps.gammaln(m + s + 1))
            + (m - s) * lch
            + (m + s) * lsh
        )
    sign = np.ones_like(log_mag)

    if s != 0:
        # m < |s|: seeds at l = |s|, closed forms for |s| = 2
        if abs(s) != 2:
            raise ValueError("only spins 0 and +-2 are implemented")
        z = z_n[None, :]
        sinb = np.sqrt(np.clip(1 - z_n**2, 0, None))[None, :]
        d2_0 = np.sqrt(6.0) / 4.0 * sinb**2  # d^2_{0, +-2}
        d2_1 = (1 - z) / 2 * sinb if s > 0 else -(1 + z) / 2 * sinb  # d^2_{-1, s}
        for mm, val in ((0, d2_0), (1, d2_1)):
            mag = np.abs(val[0])
            with np.errstate(divide="ignore"):
                log_mag[mm] = np.where(mag > 0, np.log(np.maximum(mag, 1e-300)), -1e9)
            sign[mm] = np.sign(val[0]) + (val[0] == 0)

    seed_val, seed_exp = _seed_from_log(log_mag, sign)
    seed_step = np.maximum(np.arange(L), abs(s)).astype(np.int32)
    return seed_val, seed_exp, seed_step


def _norm_l(lmax: int):
    ell = np.arange(lmax + 1, dtype=float)
    return np.sqrt((2 * ell + 1) / (4 * np.pi))


@lru_cache(maxsize=16)
def _sign_tables_np(lmax: int):
    """(cn, cs) (L, L) float32: the northern ((-1)^m norm_l) and southern
    ((-1)^l norm_l) stream factors."""
    L = lmax + 1
    norm = _norm_l(lmax)
    msign = (-1.0) ** np.arange(L)
    lsign = (-1.0) ** np.arange(L)
    cn = (norm[:, None] * msign[None, :]).astype(np.float32)
    cs = (norm[:, None] * lsign[:, None] * np.ones((1, L))).astype(np.float32)
    return cn, cs


@lru_cache(maxsize=16)
def _host_tables(lmax: int, nside: int, spin: int) -> dict:
    alpha, beta, gamma = _recursion_tables(lmax, spin)
    seed_val, seed_exp, seed_step = _seed_tables(lmax, nside, spin)
    _, _, z_n = _ring_geometry(nside)
    return {"alpha": alpha, "beta": beta, "gamma": gamma, "seed_val": seed_val, "seed_exp": seed_exp,
            "seed_step": seed_step, "z": z_n.astype(np.float32)}


@lru_cache(maxsize=16)
def _belt_tables(nside: int, lmax: int):
    rings, nh, _ = _ring_geometry(nside)
    N = 4 * nside
    b0 = nside - 1  # first belt ring (0-based), and the number of polar rings
    b1 = 3 * nside - 1  # last belt ring, inclusive
    n_belt = b1 - b0 + 1
    assert n_belt == 2 * nside + 1 and int(rings["n_pix"][b0]) == N and int(rings["n_pix"][b1]) == N
    m_arr = np.arange(lmax + 1)
    phi0 = rings["shift"][b0 : b1 + 1] * (2 * np.pi / N)
    phase = np.exp(1j * m_arr[:, None] * phi0[None, :]).astype(np.complex64)  # (L, n_belt)
    return {"N": N, "b0": b0, "b1": b1, "n_belt": n_belt, "nh": nh, "n_rings": len(rings["z"]),
            "start_belt": int(rings["start"][b0]), "npol": nside - 1, "phase": phase}


def lane_tables(lmax: int, nside: int, spin: int, device) -> dict:
    """One spin's recursion tables as the kernels take them, on
    ``device`` (built once per device): alpha, beta, gamma transposed to
    [m, l]; coef (L, L, 4) [m, l] = (alpha, beta, gamma, 0), packed for
    one 16-byte load a step, and (0, 1, 0, 0) at each m's seed step, where
    the kernels' recursion copies the seed (``csrc/sht.cu``); seed_val,
    seed_exp and seed_step as int32, z."""
    return _lane_tables(lmax, nside, spin, str(device))


@lru_cache(maxsize=16)
def _lane_tables(lmax: int, nside: int, spin: int, device: str) -> dict:
    t = _host_tables(lmax, nside, spin)
    out = {k: torch.as_tensor(np.ascontiguousarray(t[k].T), device=device) for k in ("alpha", "beta", "gamma")}
    L = lmax + 1
    coef = np.zeros((L, L, 4), np.float32)
    for i, k in enumerate(("alpha", "beta", "gamma")):
        coef[..., i] = t[k].T
    m = np.arange(L)
    seeded = t["seed_step"] < L
    coef[m[seeded], t["seed_step"][seeded]] = (0.0, 1.0, 0.0, 0.0)
    out["coef"] = torch.as_tensor(coef, device=device)
    out.update({k: torch.as_tensor(t[k], device=device) for k in ("seed_val", "seed_exp", "seed_step", "z")})
    return out


def _device_consts(lmax: int, nside: int, device) -> dict:
    """The sign tables, the belt's phases and the lower triangle on ``device``."""
    return _device_consts_on(lmax, nside, str(device))


@lru_cache(maxsize=16)
def _device_consts_on(lmax: int, nside: int, device: str) -> dict:
    cn, cs = _sign_tables_np(lmax)
    L = lmax + 1
    return {
        "cn": torch.as_tensor(cn, device=device), "cs": torch.as_tensor(cs, device=device),
        "phase": torch.as_tensor(_belt_tables(nside, lmax)["phase"], device=device),
        "tri": torch.tril(torch.ones((L, L), dtype=torch.float32, device=device)),
    }


# -- the equatorial belt, on the device ------------------------------------------------------
def _belt_g(g_n, g_s, bt):
    """Belt columns, in ring order, from the north/south accumulators."""
    north = g_n[..., bt["b0"] : bt["nh"]]
    south = torch.flip(g_s[..., bt["b0"] : bt["nh"] - 1], dims=(-1,))
    return torch.cat([north, south], dim=-1)  # (..., L, n_belt)


def _belt_synth(g_pos, g_neg, bt, phase, lmax):
    """Belt ring values (..., n_belt, N) complex64: g_pos multiplies
    e^{+im phi}, conj(g_neg) fills the -m frequencies."""
    N, L = bt["N"], lmax + 1
    wp = (g_pos * phase).transpose(-1, -2)  # (..., n_belt, L)
    wn = torch.conj(g_neg * phase).transpose(-1, -2)
    F = torch.zeros((*wp.shape[:-1], N), dtype=torch.complex64, device=wp.device)
    F[..., :L] = wp
    F[..., N - lmax :] += torch.flip(wn[..., 1:], dims=(-1,))
    return torch.fft.ifft(F, dim=-1) * N


def _belt_anal(belt_vals, bt, phase, lmax, conj_input=False):
    """h[..., L, n_belt] = sum_j vals e^{-im phi_j} of the belt rings."""
    x = belt_vals.to(torch.complex64)
    x = torch.conj(x) if conj_input else x
    F = torch.fft.fft(x, dim=-1)
    return F[..., : lmax + 1].transpose(-1, -2) * torch.conj(phase)  # no aliasing for lmax < N


def _h_layout(h_pol_n, h_pol_s, h_belt, bt):
    """(h_north, h_south) in the (L, nh) lane layout from the polar-cap
    and belt pieces; the equator column of h_south is zero."""
    nb_north = bt["nh"] - bt["b0"]
    belt_n = h_belt[..., :nb_north]
    belt_s = torch.flip(h_belt[..., nb_north:], dims=(-1,))
    zero_eq = torch.zeros((*belt_s.shape[:-1], 1), dtype=belt_s.dtype, device=belt_s.device)
    return torch.cat([h_pol_n, belt_n], dim=-1), torch.cat([h_pol_s, belt_s, zero_eq], dim=-1)


# -- the polar caps, on the device --------------------------------------------------------------
def _cap_tables(nside: int, lmax: int, device) -> dict:
    """The caps' chirp-z tables and index tables on ``device``."""
    return _cap_tables_on(nside, lmax, str(device))


@lru_cache(maxsize=8)
def _cap_tables_on(nside: int, lmax: int, device: str) -> dict:
    """Ring r of a cap (0-based from the pole, the same in both
    hemispheres) has n_r = 4 (r + 1) pixels at phi0 = pi / n_r. Its ring
    sums take the chirp-z (Bluestein) form, complex128: with W = e^{2 pi i
    / n} and 2 m p = m^2 + p^2 - (p - m)^2,
        sum_m x_m e^{i m phi0} W^{m p} = chirp_p[p] sum_m (x_m chirp_m[m]) b[p - m],
    chirp_m = e^{i pi (m^2 + m) / n}, chirp_p = e^{i pi p^2 / n},
    b[d] = e^{-i pi d^2 / n}: one convolution a ring, taken by FFTs of
    length P, a power of two with P / 2 > max(L, n_max) - 1 (n_max = 4
    npol), so every difference d of either direction (-(L - 1)..n_max - 1
    and the reverse) has its own place on the circle, and b, even in d,
    serves both (the analysis takes the conjugates). The phases are reduced
    mod 2 n in integers before the exponential. The index tables move
    between the (npol, n_max) ring arrays and the flat caps (the north
    pole-first, the south pole-last): ``north_idx``/``south_idx`` gather
    the flat caps from the ring arrays, ``north_pos``/``south_pos`` the ring
    arrays from the flat caps with one zero appended (pixels past n_r read
    it)."""
    npol, L = nside - 1, lmax + 1
    n_max, n_cap = 4 * npol, 2 * npol * (npol + 1)
    P = 1 << (2 * max(L, n_max) - 2).bit_length()
    r = np.arange(npol, dtype=np.int64)[:, None]
    m = np.arange(L, dtype=np.int64)[None, :]
    p = np.arange(n_max, dtype=np.int64)[None, :]
    k = np.arange(P, dtype=np.int64)[None, :]
    n = 4 * (r + 1)
    off = 2 * r * (r + 1)  # pixels in the rings nearer the pole
    inside = p < n
    north_pos = np.where(inside, off + p, n_cap)
    south_pos = np.where(inside, n_cap - off - n + p, n_cap)
    north_idx = np.empty(n_cap, np.int64)
    south_idx = np.empty(n_cap, np.int64)
    north_idx[north_pos[inside]] = south_idx[south_pos[inside]] = (r * n_max + p)[inside]

    def phase(q):
        return np.exp(1j * np.pi * (q % (2 * n)) / n)

    d = np.where(k < P // 2, k, k - P)
    out = {"north_pos": north_pos, "south_pos": south_pos, "north_idx": north_idx, "south_idx": south_idx,
           "chirp_m": phase(m * m + m), "chirp_p": phase(p * p), "b": np.conj(phase(d * d))}
    out = {key: torch.as_tensor(v, device=device) for key, v in out.items()}
    out["b_fft"] = torch.fft.fft(out.pop("b"), dim=-1)
    out["P"] = P
    return out


def _ring_sums(x, ct, forward: bool):
    """The chirp-z transform of every cap ring at once, complex128.
    Synthesis (``forward``): x (..., npol, L) [r, m] -> (..., npol,
    n_max), sum_m x_m e^{i m (phi0 + 2 pi p / n_r)} at pixel p (past n_r:
    unused). Analysis: x (..., npol, n_max) [r, p] (zero past n_r) ->
    (..., npol, L), sum_p x_p e^{-i m (phi0 + 2 pi p / n_r)}."""
    pre, post, b = ct["chirp_m"], ct["chirp_p"], ct["b_fft"]
    if not forward:
        pre, post, b = post.conj(), pre.conj(), b.conj()
    conv = torch.fft.ifft(torch.fft.fft(x * pre, n=ct["P"], dim=-1) * b, dim=-1)
    return conv[..., : post.shape[-1]] * post


def _caps_synth(gp_n, gn_n, gp_s, gn_s, nside, lmax, complex_out=False):
    """Synthesis of the polar caps on the device of the accumulators
    (..., L, npol): gp_* multiply e^{+im phi}, conj(gn_*) fills the -m
    side (m = 0 once). Returns (north, south) (..., 2 npol (npol + 1)),
    float64 or complex128, the south pole-last (maria_tpu's _polar_synth).
    The fold of m onto a ring's n_r frequencies is the chirp-z's own: it
    sums every m at its e^{i m phi} straight into the pixel, so no
    scatter (and no float atomic) is needed."""
    ct = _cap_tables(nside, lmax, gp_n.device)
    g0 = torch.stack([gn_n, gn_s])[..., 0, :, None].to(torch.complex128)  # (2, ..., npol, 1)
    if complex_out:
        y = _ring_sums(torch.stack([gp_n, gp_s, gn_n, gn_s]).transpose(-1, -2).to(torch.complex128), ct, True)
        vals = y[:2] + y[2:].conj() - g0.conj()
    else:
        # Re(B(gp) + conj(B(gn)) - conj(gn_0)) = Re(B(gp + gn)) - Re(gn_0)
        g = torch.stack([gp_n + gn_n, gp_s + gn_s]).transpose(-1, -2).to(torch.complex128)
        vals = _ring_sums(g, ct, True).real - g0.real
    flat = vals.flatten(-2)
    return flat[0][..., ct["north_idx"]], flat[1][..., ct["south_idx"]]


def _caps_anal(north, south, nside, lmax, conj_input=False):
    """Analysis of the polar caps (the flat caps (..., n_cap), the south
    pole-last) on their device -> (h_n, h_s), each (..., L, npol)
    complex64: h[m, r] = e^{-i m phi0} sum_p x_p W^{-m p} (maria_tpu's
    _polar_anal: the ring's FFT at m mod n_r)."""
    ct = _cap_tables(nside, lmax, north.device)
    zero = torch.zeros((*north.shape[:-1], 1), dtype=north.dtype, device=north.device)
    x = torch.stack([torch.cat([north, zero], dim=-1)[..., ct["north_pos"]],
                     torch.cat([south, zero], dim=-1)[..., ct["south_pos"]]]).to(torch.complex128)
    h = _ring_sums(x.conj() if conj_input else x, ct, False).transpose(-1, -2).to(torch.complex64)
    return h[0], h[1]


# -- one map or one a_lm set ---------------------------------------------------------------------
def synth_inputs(a, nside: int, e=None):
    """The synthesis kernel's launches for one (L, L) complex64 a_lm on
    its device: [(tables, rows (4, L, L))], one for the scalar transform;
    with ``e``, (aE, aB) = (e, a) and two, the s = +2 and s = -2 lanes.
    a2 = -(aE + i aB) and am2 = -(aE - i aB): the s = +2 lanes carry the
    northern a2 and southern am2 streams, the s = -2 lanes the northern
    am2 and southern a2."""
    lmax = a.shape[-2] - 1
    c = _device_consts(lmax, nside, a.device)
    cn, cs = c["cn"], c["cs"]
    if e is None:
        re, im = a.real, a.imag
        return [(lane_tables(lmax, nside, 0, a.device), torch.stack([re * cn, im * cn, re * cs, im * cs]))]
    e_re, e_im, b_re, b_im = e.real, e.imag, a.real, a.imag
    a2_re, a2_im = -(e_re - b_im), -(e_im + b_re)
    am2_re, am2_im = -(e_re + b_im), -(e_im - b_re)
    return [(lane_tables(lmax, nside, 2, a.device), torch.stack([a2_re * cn, a2_im * cn, am2_re * cs, am2_im * cs])),
            (lane_tables(lmax, nside, -2, a.device), torch.stack([am2_re * cn, am2_im * cn, a2_re * cs, a2_im * cs]))]


def anal_inputs(md, lmax: int, U=None):
    """The analysis kernel's launches for one (npix,) float32 map on its
    device: [(tables, h (4, L, nh))], the belt's ring FFTs and the polar
    caps' chirp-z on that device; with ``U``, (Q, U) = (md, U) and two,
    the s = +2 lanes on (hp north, hm south), the s = -2 lanes on (hp
    south, hm north)."""
    nside = npix2nside(md.shape[-1])
    device = md.device
    c = _device_consts(lmax, nside, device)
    bt = _belt_tables(nside, lmax)
    s0, nb, N = bt["start_belt"], bt["n_belt"], bt["N"]

    def streams(*parts):
        return torch.stack([x for p in parts for x in (p.real, p.imag)]).contiguous()

    if U is None:
        h_pol_n, h_pol_s = _caps_anal(md[:s0], md[s0 + nb * N :], nside, lmax)
        h_belt = _belt_anal(md[s0 : s0 + nb * N].reshape(nb, N), bt, c["phase"], lmax)
        h_n, h_s = _h_layout(h_pol_n, h_pol_s, h_belt, bt)
        return [(lane_tables(lmax, nside, 0, device), streams(h_n, h_s))]
    P = torch.complex(md, U)
    belt_P = P[s0 : s0 + nb * N].reshape(nb, N)
    north, south = P[:s0], P[s0 + nb * N :]
    (hp_n, hm_n), (hp_s, hm_s) = _caps_anal(torch.stack([north, north.conj()]), torch.stack([south, south.conj()]),
                                            nside, lmax)
    hp_n, hp_s = _h_layout(hp_n, hp_s, _belt_anal(belt_P, bt, c["phase"], lmax), bt)
    hm_n, hm_s = _h_layout(hm_n, hm_s, _belt_anal(belt_P, bt, c["phase"], lmax, conj_input=True), bt)
    return [(lane_tables(lmax, nside, 2, device), streams(hp_n, hm_s)),
            (lane_tables(lmax, nside, -2, device), streams(hp_s, hm_n))]


def _alm2map_one(a, nside: int):
    """Scalar synthesis of one (L, L) complex64 a_lm on its device."""
    lmax = a.shape[-2] - 1
    ((t, rows),) = synth_inputs(a, nside)
    acc = sht_synth(t, rows)
    g_n, g_s = torch.complex(acc[0], acc[1]), torch.complex(acc[2], acc[3])
    bt = _belt_tables(nside, lmax)
    belt = _belt_synth(_belt_g(g_n, g_s, bt), _belt_g(g_n, g_s, bt), bt, _device_consts(lmax, nside, a.device)["phase"],
                       lmax).real
    gn, gs = g_n[:, : bt["npol"]], g_s[:, : bt["npol"]]
    north, south = _caps_synth(gn, gn, gs, gs, nside, lmax)
    return torch.cat([north.float(), belt.reshape(-1), south.float()])


def _alm2map_spin_one(e, b, nside: int):
    """Spin-2 synthesis of one (aE, aB) pair: (Q, U) on their device."""
    lmax = e.shape[-2] - 1
    (tp, rows_p), (tm, rows_m) = synth_inputs(b, nside, e=e)
    acc_p, acc_m = sht_synth(tp, rows_p), sht_synth(tm, rows_m)
    gp_n, gp_s = torch.complex(acc_p[0], acc_p[1]), torch.complex(acc_m[2], acc_m[3])
    gm_n, gm_s = torch.complex(acc_m[0], acc_m[1]), torch.complex(acc_p[2], acc_p[3])
    bt = _belt_tables(nside, lmax)
    belt = _belt_synth(_belt_g(gp_n, gp_s, bt), _belt_g(gm_n, gm_s, bt), bt,
                       _device_consts(lmax, nside, e.device)["phase"], lmax)
    npol = bt["npol"]
    north, south = _caps_synth(*(g[:, :npol] for g in (gp_n, gm_n, gp_s, gm_s)), nside, lmax, complex_out=True)

    def assemble(part, belt_part):
        return torch.cat([part(north).float(), belt_part.reshape(-1), part(south).float()])

    return assemble(torch.real, belt.real), assemble(torch.imag, belt.imag)


def _alm_of(ys_n, ys_s, c, omega):
    """a_lm (re, im) of the northern and southern ys planes (re, im)."""
    return tuple(omega * (c["cn"] * n + c["cs"] * s) for n, s in zip(ys_n, ys_s))


def _map2alm_one(md, lmax: int):
    """Scalar analysis of one (npix,) float32 map on its device."""
    c = _device_consts(lmax, npix2nside(md.shape[-1]), md.device)
    ((t, h),) = anal_inputs(md, lmax)
    ys = sht_anal(t, h)
    re, im = _alm_of((ys[0], ys[1]), (ys[2], ys[3]), c, 4 * np.pi / md.shape[-1])
    return torch.complex(re * c["tri"], im * c["tri"])


def _map2alm_spin_one(Qm, Um, lmax: int):
    """Spin-2 analysis of one (Q, U) pair: (aE, aB) on their device."""
    c = _device_consts(lmax, npix2nside(Qm.shape[-1]), Qm.device)
    (tp, h_p), (tm, h_m) = anal_inputs(Qm, lmax, U=Um)
    ys_p, ys_m = sht_anal(tp, h_p), sht_anal(tm, h_m)
    omega = 4 * np.pi / Qm.shape[-1]
    a2_re, a2_im = _alm_of((ys_p[0], ys_p[1]), (ys_m[0], ys_m[1]), c, omega)
    am2_re, am2_im = _alm_of((ys_m[2], ys_m[3]), (ys_p[2], ys_p[3]), c, omega)
    tri = c["tri"]
    # aE = -(a2 + am2) / 2, aB = i (a2 - am2) / 2
    aE = torch.complex(-(a2_re + am2_re) / 2 * tri, -(a2_im + am2_im) / 2 * tri)
    aB = torch.complex(-(a2_im - am2_im) / 2 * tri, (a2_re - am2_re) / 2 * tri)
    return aE, aB


# -- public transforms ---------------------------------------------------------------------------
def _check_lmax(lmax, nside):
    if lmax >= 4 * nside:
        raise ValueError(f"lmax={lmax} >= 4*nside={4 * nside}: belt rings would alias.")


def _as_tensor(x, dtype, device):
    """``x`` as a ``dtype`` tensor: a tensor stays on its device unless
    ``device`` is given; anything else goes to ``device`` (the card unless
    told otherwise)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=x.device if device is None else torch.device(device), dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=resolve_device(device))


def _batched(fn, inner_ndim: int, *xs):
    """``fn`` over the leading batch dims of ``xs`` (one map or a_lm set
    at a time), outputs stacked back to those dims."""
    batch = xs[0].shape[: xs[0].ndim - inner_ndim]
    if not batch:
        return fn(*xs)
    flat = [x.reshape(-1, *x.shape[x.ndim - inner_ndim :]) for x in xs]
    outs = [fn(*items) for items in zip(*flat)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack([o[i] for o in outs]).reshape(*batch, *outs[0][i].shape) for i in range(len(outs[0])))
    return torch.stack(outs).reshape(*batch, *outs[0].shape)


def alm2map(alm, nside: int, device=None):
    """Real HEALPix RING map(s) (..., npix) float32 of a_lm indexed (...,
    l, m), on the a_lm's device (or ``device``)."""
    a = _as_tensor(alm, torch.complex64, device)
    _check_lmax(a.shape[-2] - 1, nside)
    return _batched(lambda x: _alm2map_one(x, nside), 2, a)


def map2alm(m, lmax: int, device=None):
    """a_lm (..., l, m) complex64 of real HEALPix RING map(s) (..., npix),
    by the Omega-weighted sum (healpy's iter=0): band-limited fields
    round-trip to ~0.2%."""
    md = _as_tensor(m, torch.float32, device)
    _check_lmax(lmax, npix2nside(md.shape[-1]))
    return _batched(lambda x: _map2alm_one(x, lmax), 1, md)


def alm2map_spin(alm_e, alm_b, nside: int, device=None):
    """Spin-2 synthesis: (aE, aB) indexed (..., l, m) -> (Q, U) maps, with
    Q + iU = -sum (aE + i aB) 2Y_lm (healpy COSMO)."""
    e = _as_tensor(alm_e, torch.complex64, device)
    b = _as_tensor(alm_b, torch.complex64, e.device)
    _check_lmax(e.shape[-2] - 1, nside)
    return _batched(lambda x, y: _alm2map_spin_one(x, y, nside), 2, e, b)


def map2alm_spin(Q, U, lmax: int, device=None):
    """Spin-2 analysis: (Q, U) maps (..., npix) -> (aE, aB)."""
    Qd = _as_tensor(Q, torch.float32, device)
    Ud = _as_tensor(U, torch.float32, Qd.device)
    _check_lmax(lmax, npix2nside(Qd.shape[-1]))
    return _batched(lambda x, y: _map2alm_spin_one(x, y, lmax), 1, Qd, Ud)
