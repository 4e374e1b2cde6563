"""The plain reference of one total-power realization: a 3-D layered
turbulence atmosphere seen through the bands' (pwv, elevation) tables,
gain errors, and detector noise (white plus 1/f with focal-plane
modes), in float64 plain torch.

It starts from the scene (``start``) that ``scene.start`` works out
from the configuration and the observation's inputs: the pointing, the
atmosphere's layer geometry and spectral operators, the bands' tables
and noise parameters, as plain arrays. From the realization's seed it draws the
same normals as the program's documented order: each screen group's
white half-spectra, the gain normals, each band's mode normals in band
order, then the two words of the noise's counter-based key, whose
Philox4x32-10 stream gives the detectors' spectral draw. Everything
after the draws is computed here from its definition: the half-spectra
weighted and mixed into layers and inverse-transformed, each layer
sampled bilinearly along each line of sight, the bands' tables, the
Catmull-Rom upsampling, the gains, the spectrum, the inverse real FFT
and the modes.

``precision`` "none" is the reference; "control" computes the
atmosphere in bfloat16 and the noise as the matrix product of fp8
operands, one step below the configuration's float32 and bfloat16;
"control_noise" lowers the noise product alone.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .common import (F64, f64, bilinear_uniform, catmull_rom_upsample, fft_size, knee_spectrum, offsets_to_phi_theta,
                     philox_complex_normals, rounder, table_bilinear, white_half_spectrum)


def draws(start: dict, seed: int, device):
    """The realization's normals, in the program's order, on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    f32 = dict(generator=g, device=device, dtype=torch.float32)
    groups = [torch.randn((2 * gr["W"].shape[0], gr["ny"], gr["nx"] // 2 + 1, 2), **f32) for gr in start["groups"]]
    gains = torch.randn((len(start["offsets"]),), **f32)
    m1 = fft_size(start["n_t"]) // 2 + 1
    modes = {}
    for i in start["band_order"]:
        basis = start["bands"][i]["basis"]
        if basis is not None:
            modes[i] = torch.randn((basis.shape[1], 2, m1), **f32)
    key = torch.randint(0, 1 << 32, (2,), dtype=torch.int64, generator=g, device=device)
    return {"groups": groups, "gains": gains, "modes": modes, "key": tuple(int(k) for k in key.tolist())}


def layer_screens(group: dict, draw, q, device):
    """(L, ny, nx) layer screens of a group from its 2J half-spectra."""
    W = torch.as_tensor(group["W"], dtype=F64, device=device)
    spec = white_half_spectrum(draw) * torch.cat([W, W])
    M = torch.as_tensor(np.concatenate([group["M_cos"], group["M_sin"]], axis=1), dtype=F64, device=device)
    mixed = torch.einsum("lj,jyx->lyx", M, spec.real) + 1j * torch.einsum("lj,jyx->lyx", M, spec.imag)
    if group["beam"] is not None:
        mixed = mixed * torch.as_tensor(group["beam"], dtype=F64, device=device)
    return q(torch.fft.irfft2(mixed, s=(group["ny"], group["nx"])))


def total_power_blocks(start: dict, seed: int, device, precision: str = "none", rows: int = 4096):
    """Yield (r0, r1, total, noise): float64 (r1 - r0, n_t) blocks of the
    realization ``seed``'s total power in pW and its noise part."""
    control = precision in ("control", "control_noise")
    q = rounder("bf16" if precision == "control" else "none")
    q8 = rounder("fp8" if control else "none")
    d = draws(start, seed, device)
    n_t, ratio, fs = start["n_t"], start["ratio"], start["sample_rate"]
    n_fft = fft_size(n_t)
    m1 = n_fft // 2 + 1
    tens = lambda a: f64(a, device)  # noqa: E731
    stacks = [layer_screens(gr, dr, q, device) for gr, dr in zip(start["groups"], d["groups"])]
    del d["groups"]
    offsets, bs_az, bs_el, t_c = (tens(start[k]) for k in ("offsets", "bs_az", "bs_el", "t_c"))
    mueller = tens(start["mueller_I"])
    gains = torch.exp(tens(start["gain_error"]) * d["gains"].to(F64))
    bands = start["bands"]
    shapes = {tuple(knee_spectrum(fs, b["knee"], n_fft, 1.0, 1.0 - b["corr_prop"])) for b in bands}
    if len(shapes) != 1:
        raise ValueError("the reference draws the noise of bands that share one spectral shape")
    c = tens(knee_spectrum(fs, bands[0]["knee"], n_fft, 1.0, 1.0 - bands[0]["corr_prop"]))
    mode_series = {}
    for i, zm in d["modes"].items():
        cm = tens(knee_spectrum(fs, bands[i]["knee"], n_fft, 0.0, 1.0))
        zm = zm.to(F64)
        mode_series[i] = torch.fft.irfft(cm * torch.complex(zm[:, 0], zm[:, 1]), n=n_fft)[:, :n_t]
    row_band = np.empty(len(offsets), dtype=np.int64)
    for i, b in enumerate(bands):
        row_band[np.asarray(b["det_index"])] = i
    nep = tens([1e12 * bands[i]["NEP"] for i in row_band])
    if control:
        t = np.arange(n_t)[None, :]
        k = np.arange(m1)[:, None]
        a = np.full((m1, 1), 2.0)
        a[0] = 1.0
        if n_fft % 2 == 0:
            a[-1] = 1.0
        ang = 2 * np.pi * k * t / n_fft
        CS = q8(tens(np.concatenate([a * np.cos(ang), -a * np.sin(ang)]) / n_fft))
        mode_series = {i: q8(s) for i, s in mode_series.items()}

    for r0 in range(0, len(offsets), rows):
        r1 = min(r0 + rows, len(offsets))
        az, el = offsets_to_phi_theta(offsets[r0:r1, 0, None], offsets[r0:r1, 1, None], bs_az[None], bs_el[None])
        el = torch.clamp(el, math.radians(5.0), math.pi / 2)
        cot = 1 / torch.tan(el)
        px, py = torch.sin(az) * cot, torch.cos(az) * cot
        pwv = torch.full_like(px, start["mean_pwv"])
        for gr, stack in zip(start["groups"], stacks):
            ca, sa = math.cos(gr["angle"]), math.sin(gr["angle"])
            for layer, h in enumerate(gr["heights"]):
                x = h * px + gr["vx"] * t_c
                y = h * py + gr["vy"] * t_c
                sample = bilinear_uniform(stack[layer], ca * x + sa * y, -sa * x + ca * y, gr["tx_min"], gr["res"],
                                          gr["ty_min"], gr["res"])
                pwv = q(pwv + q(gr["pwv_rms"][layer] * q(sample)))
        del px, py, az
        loading = torch.empty_like(pwv)
        for i, b in enumerate(bands):
            local = np.nonzero(row_band[r0:r1] == i)[0]
            if len(local) == 0:
                continue
            sel = torch.as_tensor(local, device=device)
            table = tens(b["table"])
            loading[sel] = q(mueller[r0 + sel, None] * q(table_bilinear(b["pwv_side"], b["el_side"], table,
                                                                          pwv[sel], el[sel])))
        signal = q(gains[r0:r1, None] * q(catmull_rom_upsample(loading, ratio, n_t)))
        del loading, pwv, el

        re, im = philox_complex_normals(d["key"], torch.arange(r0, r1, dtype=torch.int64, device=device), m1)
        if control:
            V = q8(torch.cat([c * re, c * im], dim=1))
            unit = V @ CS
        else:
            unit = torch.fft.irfft(c * torch.complex(re, im), n=n_fft)[:, :n_t]
        del re, im
        for i, series in mode_series.items():
            local = np.nonzero(row_band[r0:r1] == i)[0]
            if len(local) == 0:
                continue
            basis_rows = np.searchsorted(np.asarray(bands[i]["det_index"]), r0 + local)
            cols = tens(math.sqrt(bands[i]["corr_prop"]) * np.asarray(bands[i]["basis"])[basis_rows])
            sel = torch.as_tensor(local, device=device)
            unit[sel] += q8(cols) @ series
        noise = nep[r0:r1, None] * unit
        yield r0, r1, signal + noise, noise
