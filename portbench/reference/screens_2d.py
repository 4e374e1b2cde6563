"""The 2-D atmosphere of a realization, in float64 plain torch, with none
of the program's code: each slab's Matérn-5/6 screen made from its white
half-spectrum and its spectral weights, and the zenith-scaled pwv along
every line of sight.

A slab at height h is one screen on the grid the observation fixed (its
spacing, size and origin, read from the inputs as the weather and the
scan fix them), or, where the spectrum's outer scale is much wider than
the footprint, a fine/coarse pair of screens that carries the spectrum
split at k_c = 4 pi / L, L the fine grid's shorter side, by the
order-8 power partition 1 / (1 + (k_c / k)^8). Every screen's spectral
weights are the 2-D Matérn density (2 nu / r0^2 + k^2)^-(nu + 1), nu =
5/6, r0 the outer scale max(1 km, 300 m + h / 10), its DC bin zeroed,
scaled so that the slab's field (the pair's two grids together) has unit
variance, and blurred by the detectors' mean Gaussian beam at the slab's
distance: exp(-sigma^2 k^2 / 2).

``screen_weights`` makes the weights, ``screen_values`` a screen from its
(ny, nx//2 + 1, 2) unit normals, and ``pwv`` the mean plus each screen's
bilinear sample times its pwv rms, at x = h px + vx t, y = h py + vy t
turned by the screen's angle, (px, py) the unit-height projection of
each line of sight, its elevation clamped to [5, 90] deg.
"""

from __future__ import annotations

import math

import torch

from .common import F64, bilinear_uniform, offsets_to_phi_theta, white_half_spectrum

NU_2D = 5 / 6  # the Matérn index of the 2-D turbulence model
SPLIT_ORDER = 8


def outer_scale(h: float) -> float:
    return max(1e3, 300 + h / 10)


def _grid_k(ny: int, nx: int, res: float, device):
    ky = 2 * math.pi * torch.fft.fftfreq(ny, d=res, dtype=F64, device=device)
    kx = 2 * math.pi * torch.fft.rfftfreq(nx, d=res, dtype=F64, device=device)
    return torch.sqrt(ky[:, None] ** 2 + kx[None, :] ** 2)


def _density(k, r0: float):
    S = (2 * NU_2D / r0**2 + k**2) ** -(NU_2D + 1)
    S[0, 0] = 0.0
    return S


def _grid_variance(S, ny: int, nx: int) -> float:
    """The variance a cell of irfft2(S^1/2 x a white half-spectrum):
    every rfft column but the self-conjugate first and last stands for
    two."""
    fold = torch.full((S.shape[-1],), 2.0, dtype=F64, device=S.device)
    fold[0] = 1.0
    if nx % 2 == 0:
        fold[-1] = 1.0
    return float((S * fold).sum()) / (ny * nx)


def screen_weights(screen: dict, beam_sigma: float, partner: dict = None, device=None):
    """(ny, nx//2 + 1) float64 spectral weights of ``screen`` (its "band"
    "full", "fine" or "coarse"); a pair's screen names the other in
    ``partner``."""
    r0 = outer_scale(screen["h"])
    k = _grid_k(screen["ny"], screen["nx"], screen["res"], device)
    S = _density(k, r0)
    if screen["band"] == "full":
        W = torch.sqrt(S / _grid_variance(S, screen["ny"], screen["nx"]))
    else:
        fine = screen if screen["band"] == "fine" else partner
        k_c = 4 * math.pi / (min(fine["nx"], fine["ny"]) * fine["res"])

        def fine_share(kk):
            return torch.where(kk > 0, 1.0 / (1.0 + (k_c / torch.clamp(kk, min=1e-30)) ** SPLIT_ORDER), 0.0)

        parts = {}
        for s in (screen, partner):
            kk = _grid_k(s["ny"], s["nx"], s["res"], device)
            share = fine_share(kk) if s["band"] == "fine" else 1.0 - fine_share(kk)
            Ss = _density(kk, r0) * share
            parts[s["band"]] = (Ss, _grid_variance(Ss, s["ny"], s["nx"]))
        S = parts[screen["band"]][0]
        W = torch.sqrt(S / (parts["fine"][1] + parts["coarse"][1]))
    return W * torch.exp(-0.5 * beam_sigma**2 * k**2)


def screen_values(screen: dict, W, draw, q=lambda x: x):
    """The (ny, nx) screen from its (ny, nx//2 + 1, 2) unit normals."""
    spec = white_half_spectrum(draw.to(W.device)) * W
    return q(torch.fft.irfft2(spec, s=(screen["ny"], screen["nx"])))


def line_of_sight(offsets, bs_az, bs_el):
    """(el_clip, px, py), (n_det, n_t): each detector's elevation clamped
    to [5, 90] deg and the unit-height east and north projections of its
    line of sight."""
    az, el = offsets_to_phi_theta(offsets[:, 0, None], offsets[:, 1, None], bs_az[None], bs_el[None])
    el = torch.clamp(el, math.radians(5.0), math.pi / 2)
    cot = 1 / torch.tan(el)
    return el, torch.sin(az) * cot, torch.cos(az) * cot


def pwv(mean_pwv: float, screens: list, values: list, px, py, t, q=lambda x: x):
    """The zenith-scaled pwv: the mean plus each screen's sample along the
    lines of sight (px, py at the times t) times its rms, summed in screen
    order."""
    out = torch.full_like(px, mean_pwv)
    for s, grid in zip(screens, values):
        ca, sa = math.cos(s["angle"]), math.sin(s["angle"])
        x = s["h"] * px + s["vx"] * t
        y = s["h"] * py + s["vy"] * t
        sample = bilinear_uniform(grid, ca * x + sa * y, -sa * x + ca * y, s["tx_min"], s["res"], s["ty_min"],
                                  s["res"])
        out = q(out + q(s["pwv_rms"] * sample))
    return out


def partners(screens: list) -> list:
    """Each screen's pair partner (the fine screen's coarse half follows
    it), or None."""
    out = [None] * len(screens)
    for i, s in enumerate(screens):
        if s["band"] == "fine":
            if i + 1 >= len(screens) or screens[i + 1]["band"] != "coarse":
                raise ValueError("a fine screen must be followed by its coarse half")
            out[i], out[i + 1] = screens[i + 1], s
    return out


def all_weights(screens: list, beam_sigmas: list, device) -> list:
    return [screen_weights(s, b, p, device) for s, b, p in zip(screens, beam_sigmas, partners(screens))]

