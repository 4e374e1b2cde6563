"""The plain reference of the CMB patch's realization: the detector
noise and the CMB's loading of a polarized array, and the IQU
maximum-likelihood map made from a TOD, in float64 plain torch.

``tod_blocks`` starts from the scene (``start``): each band's detectors,
NEP, knee, correlated share and focal-plane basis, the detectors'
Stokes weights, the CMB's I, Q, U at each sample's HEALPix pixel, each
band's P(T_CMB) and dP/dT in pW and its pW -> K_RJ factor. From the
realization's seed it draws the normals in the program's documented
order (each band's spectral draw, then its modes' draw; then the gain
normals) and computes the TOD in K_RJ.

``ml_map`` is the mapper's definition: each detector's B-spline
baseline (with the mean elevation's powers) removed by least squares,
the |w|-weighted binned map, then per epoch a noise model (the 8-bin
smoothed periodogram of the Tukey-windowed, map-subtracted residuals,
inverted) and conjugate-gradient steps on P^T N^-1 P m = P^T N^-1 d
with the white-noise Jacobi preconditioner, from the pixel ids
(``pix``: a sample's pixel offset by its band's frame, off-map samples
at the frame's last bucket).

``precision`` "none" is the reference; "control" rounds every step to
bfloat16, one below the program's float32.
"""

from __future__ import annotations

import math

import numpy as np
import scipy as sp
import torch

from .common import F64, f64, fft_size, knee_spectrum, rounder


def draws(start: dict, seed: int, device) -> dict:
    """The realization's normals, in the program's order, on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    f32 = dict(generator=g, device=device, dtype=torch.float32)
    m1 = fft_size(start["n_t"]) // 2 + 1
    out = []
    for b in start["bands"]:
        white = torch.randn((len(b["det_index"]), m1, 2), **f32)
        modes = None if b["basis"] is None else torch.randn((b["basis"].shape[1], m1, 2), **f32)
        out.append((white, modes))
    gains = torch.randn((start["n_det"],), **f32)
    return {"bands": out, "gains": gains}


def tod(start: dict, seed: int, device, precision: str = "none"):
    """(tod, noise): the realization's (n_det, n_t) TOD in K_RJ and its
    noise part, float64."""
    q = rounder("bf16" if precision == "control" else "none")
    d = draws(start, seed, device)
    n_t, fs = start["n_t"], start["sample_rate"]
    n_fft = fft_size(n_t)
    tens = lambda a: f64(a, device)  # noqa: E731
    noise = torch.zeros((start["n_det"], n_t), dtype=F64, device=device)
    sky = torch.zeros_like(noise)
    cmb, sw = tens(start["cmb_samples"]), tens(start["stokes_weight"])  # (n_s, n_det, n_t), (n_det, n_s)
    for b, (white, modes) in zip(start["bands"], d["bands"]):
        rows = torch.as_tensor(np.asarray(b["det_index"]), device=device)
        cp = b["corr_prop"] if b["basis"] is not None else 0.0
        c = tens(knee_spectrum(fs, b["knee"], n_fft, 1.0, 1.0 - cp))
        z = white.to(F64)
        unit = q(torch.fft.irfft(c * torch.complex(z[..., 0], z[..., 1]), n=n_fft)[:, :n_t])
        if modes is not None:
            cm = tens(knee_spectrum(fs, b["knee"], n_fft, 0.0, 1.0))
            zm = modes.to(F64)
            series = q(torch.fft.irfft(cm * torch.complex(zm[..., 0], zm[..., 1]), n=n_fft)[:, :n_t])
            unit = q(unit + q(math.sqrt(cp) * tens(b["basis"]) @ series))
        noise[rows] = q(b["to_K_RJ"] * q(1e12 * b["NEP"] * unit))
        field = q(b["P0"] * sw[rows, 0, None] + q(b["dPdT"] * q(sum(sw[rows, s, None] * cmb[s, rows]
                                                                    for s in range(cmb.shape[0])))))
        sky[rows] = q(b["to_K_RJ"] * field)
    gains = torch.exp(tens(start["gain_error"]) * d["gains"].to(F64))[:, None]
    return q(q(gains * sky) + noise), noise


def bspline_basis(n: int, spacing: int, order: int = 3) -> np.ndarray:
    """(n_basis, n) cubic B-splines over samples 0..n-1 on uniform knots
    ``spacing`` samples apart, the ends repeated ``order`` times."""
    n_knots = max(int(n / spacing) + 1, 2)
    t = np.linspace(0, n - 1, n_knots)
    t = np.r_[[t[0]] * order, t, [t[-1]] * order]
    x = np.arange(n)
    B = np.stack([sp.interpolate.BSpline.basis_element(t[i:i + order + 2], extrapolate=False)(x)
                  for i in range(len(t) - order - 1)])
    return np.nan_to_num(B)


def remove_spline(data, fs: float, knot_spacing: float, el_order: int, el_mean, q):
    """Each row less its least-squares fit on the B-splines and the
    standardized mean elevation's powers 1..el_order (ridge 1e-6 of the
    mean diagonal)."""
    n = data.shape[-1]
    B = bspline_basis(n, max(int(knot_spacing * fs), 2))
    el = np.asarray(el_mean, dtype=np.float64)[None]
    if el_order and el.std() > 1e-12 * max(abs(el.mean()), 1e-12):
        el = (el - el.mean()) / el.std()
        B = np.concatenate([B, *[el**p for p in range(1, el_order + 1)]])
    B = torch.as_tensor(B, dtype=F64, device=data.device)
    gram = B @ B.T
    gram = gram + 1e-6 * torch.trace(gram) / len(gram) * torch.eye(len(gram), dtype=F64, device=data.device)
    coeffs = torch.linalg.solve(gram, B @ data.T).T
    return q(data - q(coeffs @ B))


def ml_map(data, start: dict, epochs: int, steps: int, precision: str = "none", smoothing: int = 8):
    """(m, hits, A): the fit's (n_s, n_frames * (n_pix + 1)) map and its
    |w|-weighted hits, float64, from the (n_det, n_t) TOD ``data`` in
    K_RJ, and the last epoch's operator x -> P^T N^-1 P x on the pixels
    (zero at the overflow buckets)."""
    q = rounder("bf16" if precision == "control" else "none")
    device = data.device
    pix = start["pix"].to(device=device, dtype=torch.int64)
    sw = torch.as_tensor(start["sw"], dtype=F64, device=device)
    n_s, n_m1, n_frames = sw.shape[1], start["n_pix"] + 1, start["n_frames"]
    n_c = n_frames * n_m1
    mask = torch.ones((n_s, n_frames, n_m1), dtype=F64, device=device)
    mask[..., -1] = 0.0
    mask = mask.reshape(n_s, n_c)
    flat = pix.reshape(-1)
    n = data.shape[-1]

    def P(m):
        m = m * mask
        return q(sum(sw[:, s, None] * m[s][flat].view_as(pix) for s in range(n_s)))

    def PT(v, w=sw):
        out = torch.zeros((n_s, n_c), dtype=F64, device=device)
        for s in range(n_s):
            out[s].index_add_(0, flat, (w[:, s, None] * v).reshape(-1))
        return q(out)

    d = remove_spline(q(data.to(F64)), start["sample_rate"], start["knot_spacing"], start["el_order"],
                      start["el_mean"], q)
    hits = PT(torch.ones_like(d), sw.abs())
    m = torch.where(hits > 0, PT(d) / torch.clamp(hits, min=1e-8), 0.0)
    win = torch.as_tensor(sp.signal.windows.tukey(n, 0.25), dtype=F64, device=device)
    A = None
    for _ in range(epochs):
        resid = d - P(m)
        resid = resid - resid.mean(dim=-1, keepdim=True)
        wd = resid * win
        spec = torch.fft.rfft(wd, dim=-1).abs() ** 2 / (win**2).sum()
        k = smoothing
        padded = torch.nn.functional.pad(spec, (k // 2, (k - 1) // 2))
        spec = sum(padded[..., j:j + spec.shape[-1]] for j in range(k)) / k
        A_inv = q(1.0 / torch.clamp(spec, min=1e-30))

        def Ninv(v):
            return q(torch.fft.irfft(torch.fft.rfft(v, dim=-1) * A_inv, n=n, dim=-1))

        b = PT(Ninv(d))
        diag = PT(A_inv.mean(dim=-1, keepdim=True).expand_as(d), sw**2)
        inv_diag = torch.where(diag > 0, 1.0 / torch.clamp(diag, min=1e-30), 1.0)

        def A(x):
            return q(PT(Ninv(P(x))) * mask + x * (1 - mask))

        atol2 = 1e-16 * torch.sum(b * b)
        r = b - A(m)
        z = r * inv_diag
        gamma, p = torch.sum(r * z), z
        for _ in range(steps):
            if torch.sum(r * r) <= atol2:
                break
            Ap = A(p)
            alpha = gamma / torch.sum(p * Ap)
            m, r = q(m + alpha * p), q(r - alpha * Ap)
            z = r * inv_diag
            gamma_new = torch.sum(r * z)
            p = q(z + (gamma_new / gamma) * p)
            gamma = gamma_new
    return m, hits, (lambda x: PT(Ninv(P(x))) * mask) if A is not None else None

