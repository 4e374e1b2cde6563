"""The plain reference of a realization of a polarized, multi-band camera
under the 2-D atmosphere with a CMB and detector noise, the TOD in K_RJ
by field, in float64 plain torch and numpy, with none of the program's
code.

``start`` works the scene out from the configuration and the
observation's inputs (the detectors' offsets, polarization angles and
bands, the boresight at the sample rate, the coarse step, the weather's
mean pwv and base temperature, each screen's grid, height, distance, pwv
rms and wind, the CMB map, and the atmospheric spectrum's grid file, raw
data that both sides read): each band's passband, its (pwv, elevation)
tables of atmospheric loading and of the CMB's loading and dP/dT_CMB
through the atmosphere, its pW -> K_RJ factor's elevation table, its
NEP, knee and focal-plane noise basis; the screens' spectral weights
(``screens_2d``); the Stokes weights and gains.

``fields`` draws the realization's normals from its seed in the
program's documented order (each screen's white half-spectrum in screen
order, then each band's detector draw and its modes' draw in the
instrument's band order, then the gain normals) and computes, a band of
detectors at a time:

- "atmosphere": each band's loading table at each detector's coarse
  (pwv, clamped elevation), times the Stokes I weight, Catmull-Rom
  upsampled to the samples;
- "cmb": P0 x the Stokes I weight + dP/dT x the Stokes-weighted I, Q, U
  of the CMB at the sample's HEALPix pixel, the tables read at the pwv
  linearly upsampled and the clamped elevation Catmull-Rom upsampled;
- "noise": 1e12 NEP x white plus 1/f noise with the band's correlated
  modes (the inverse real FFT of the drawn spectrum);

the first two times exp(gain_error x the gain normal), and every field
times the band's K_RJ per pW at the detector's own elevation at each
sample (the transmission at the weather's pwv and base temperature
rounded to 1e-3, as the simulator records them). ``precision`` "none"
is the reference; "control" rounds every step to bfloat16, one step
below the configuration's float32.

Departures from the program's order, none of which changes a number by
more than float32 rounding: the screens are made in float64 and the
lines of sight are sampled a band of detectors at a time; the band tables
are evaluated in float64, uncropped; the noise is the inverse FFT in
float64 of the same draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import screens_2d
from .common import F64, H, K_B, catmull_rom_upsample, f64, fft_size, grid_coordinate, knee_spectrum, \
    offsets_to_phi_theta, rounder, table_bilinear
from .scene import beam_sigma, coarse_pointing, diameter, loading_table, noise_basis, passband, support
from .sky import T_CMB, boresight_radec, radec_to_galactic, ring_pixels

DT_CMB = 1e-6  # K: the step of the two-point dP/dT_CMB
GRID_KEYS = ("side_base_temperature_K", "side_zenith_pwv_mm", "side_elevation_rad", "side_nu_Hz",
             "rayleigh_jeans_temperature_K", "opacity_nepers")


def collapse_temperature(T_side, values, T: float):
    """``values`` (n_T, ...) linearly interpolated at the base temperature
    T, clipped to the side."""
    i = int(np.clip(np.searchsorted(T_side, T) - 1, 0, len(T_side) - 2))
    w = float(np.clip((T - T_side[i]) / (T_side[i + 1] - T_side[i]), 0, 1))
    return (1 - w) * values[i] + w * values[i + 1]


def rj_temperature(T, nu):
    """The Rayleigh-Jeans temperature of a blackbody at T."""
    return H * nu / K_B / np.expm1(H * nu / (K_B * T))


def band_tables(grids: dict, spec: dict, base_temperature: float, pwv_record: float, T_record: float) -> dict:
    """The band's (pwv, elevation) tables in pW: "loading", 1e12 k_B x the
    integral of the sky's Rayleigh-Jeans temperature times the passband
    (``scene.loading_table``; the passband, ``scene.support``, the band's
    1,024 samples, linear between them, as the simulator defines it);
    "P0" and "dPdT", the loading of blackbodies at T_CMB and T_CMB + 1e-6 K
    through the transmission and the passband (on the band's own
    frequencies, the opacity linear between the grid's) and their
    difference over 1e-6 K; "transmission", the (elevation,) integral of
    the passband times the transmission at the recorded pwv and base
    temperature (interpolated multilinearly in the grid's axes)."""
    T_side, pwv_side, el_side, nu = (grids[k] for k in GRID_KEYS[:4])
    nu_b, tau_b = support(spec)
    pass_b = spec.get("efficiency", 0.5) * tau_b
    op = grids["opacity_nepers"]
    lo = np.clip(np.searchsorted(nu, nu_b, side="right") - 1, 0, len(nu) - 2)
    w = (nu_b - nu[lo]) / (nu[lo + 1] - nu[lo])
    trans_b = np.exp(-((1 - w) * op[..., lo] + w * op[..., lo + 1]))  # (T, pwv, el, n_nu_b)
    P = [1e12 * K_B * np.trapezoid(rj_temperature(T, nu_b) * trans_b * pass_b, nu_b, axis=-1)
         for T in (T_CMB, T_CMB + DT_CMB)]
    trans = np.trapezoid(passband(spec, nu) * np.exp(-op), nu, axis=-1)  # (T, pwv, el)
    u = float(grid_coordinate(T_side, torch.tensor([T_record], dtype=F64))[0])
    v = float(grid_coordinate(pwv_side, torch.tensor([pwv_record], dtype=F64))[0])
    i, j = min(int(u), len(T_side) - 2), min(int(v), len(pwv_side) - 2)
    wu, wv = u - i, v - j
    el_table = ((1 - wu) * (1 - wv) * trans[i, j] + (1 - wu) * wv * trans[i, j + 1] + wu * (1 - wv) * trans[i + 1, j]
                + wu * wv * trans[i + 1, j + 1])
    return {"pwv_side": pwv_side, "el_side": el_side,
            "loading": loading_table(grids, spec, base_temperature)[2],
            "P0": collapse_temperature(T_side, P[0], base_temperature),
            "dPdT": collapse_temperature(T_side, (P[1] - P[0]) / DT_CMB, base_temperature),
            "transmission": el_table}


def el_interp(side, table, el):
    """The (elevation,) ``table`` linearly interpolated at ``el``,
    clipped to its side."""
    f = grid_coordinate(side, el)
    i = torch.clamp(torch.floor(f), 0, len(side) - 2).long()
    t = torch.as_tensor(np.asarray(table, dtype=float), dtype=F64, device=el.device)
    return t[i] * (1 - (f - i)) + t[i + 1] * (f - i)


def linear_upsample(values, ratio: int, n_fine: int):
    """(..., n_c) coarse samples to n_fine samples, ``ratio`` a step,
    linear between them and the last held."""
    n_c = values.shape[-1]
    s = torch.arange(ratio, dtype=F64, device=values.device) / ratio
    out = (values[..., :-1, None] * (1 - s) + values[..., 1:, None] * s).reshape(*values.shape[:-1], (n_c - 1) * ratio)
    if out.shape[-1] < n_fine:
        out = torch.cat([out, values[..., -1:].expand(*values.shape[:-1], n_fine - out.shape[-1])], dim=-1)
    return out[..., :n_fine]


def instrument_bands(config: dict) -> list:
    """(array, band spec) of every band, arrays and bands in the
    configuration's order: the instrument's band order."""
    return [(a, spec) for a in config["arrays"].values() for spec in a["bands"]]


def start(config: dict, inputs: dict, device) -> dict:
    """The realization's scene (module docstring), worked out once."""
    with np.load(inputs["spectrum_path"]) as f:
        grids = {k: f[k].astype(float) for k in GRID_KEYS}
    offsets = np.asarray(inputs["offsets"], dtype=float)
    names = np.asarray(inputs["band_name"])
    gamma = np.asarray(inputs["gamma"], dtype=float)
    polarized = ~np.isnan(gamma)
    noise = config.get("noise_kwargs", {})
    cp = noise.get("correlated_noise_proportion", 0.5)
    pwv_record, T_record = round(inputs["mean_pwv"], 3), round(inputs["base_temperature"], 3)
    bands = []
    for array, spec in instrument_bands(config):
        idx = np.nonzero(names == spec["name"])[0]
        basis = None
        fov = diameter(offsets[idx], device) if len(idx) > 16 else 0.0
        if cp > 0 and fov > 0:
            basis = noise_basis(offsets[idx], fov * noise.get("correlated_noise_spatial_scale", 1.0))
        bands.append({
            "name": spec["name"], "center": float(spec["center"]), "aperture": float(array["primary_size"]),
            "det_index": idx, "NEP": float(spec["NEP"]), "knee": float(spec.get("knee", 1.0)),
            "gain_error": float(spec.get("gain_error", 0.0)), "basis": basis,
            "corr_prop": cp if basis is not None else 0.0, "polarized": bool(polarized[idx].any()),
            **band_tables(grids, spec, inputs["base_temperature"], pwv_record, T_record),
        })
    g = np.where(polarized, gamma, 0.0)
    sw = np.where(polarized[:, None], 0.5 * np.stack([np.ones_like(g), np.cos(2 * g), np.sin(2 * g)], 1),
                  np.array([1.0, 0.0, 0.0]))
    screens = [dict(s) for s in inputs["screens"]]
    apertures = {b["aperture"] for b in bands}
    if len(apertures) != 1:
        raise ValueError("the reference's beam model takes arrays of one aperture")
    (aperture,) = apertures
    centers, counts = [b["center"] for b in bands], [len(b["det_index"]) for b in bands]
    sigmas = [beam_sigma(s["z"], aperture, centers, counts) for s in screens]
    t_c, az_c, el_c, ratio = coarse_pointing(inputs)
    site = config["site"]
    ra, dec, q = boresight_radec(inputs["bs_az"], inputs["bs_el"], inputs["t"], math.radians(site["latitude"]),
                                 math.radians(site["longitude"]))
    return {
        "bands": bands, "screens": screens, "W": screens_2d.all_weights(screens, sigmas, device),
        "offsets": offsets, "sw": sw, "mean_pwv": float(inputs["mean_pwv"]), "t_c": t_c, "bs_az_c": az_c,
        "bs_el_c": el_c, "ratio": ratio, "n_t": len(inputs["t"]), "sample_rate": float(inputs["sample_rate"]),
        "bs_az": np.asarray(inputs["bs_az"], dtype=float), "bs_el": np.asarray(inputs["bs_el"], dtype=float),
        "ra": ra, "dec": dec, "q": q, "cmb": inputs["cmb"], "nside": int(inputs["nside"]),
        "cmb_frame": inputs["cmb_frame"],
    }


def draws(start: dict, seed: int, device) -> dict:
    """The realization's normals, in the program's order, on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    f32 = dict(generator=g, device=device, dtype=torch.float32)
    screens = [torch.randn((s["ny"], s["nx"] // 2 + 1, 2), **f32) for s in start["screens"]]
    m1 = fft_size(start["n_t"]) // 2 + 1
    bands = []
    for b in start["bands"]:
        white = torch.randn((len(b["det_index"]), m1, 2), **f32)
        modes = None if b["basis"] is None else torch.randn((b["basis"].shape[1], m1, 2), **f32)
        bands.append((white, modes))
    gains = torch.randn((len(start["offsets"]),), **f32)
    return {"screens": screens, "bands": bands, "gains": gains}


def det_radec(start: dict, rows, device):
    """(ra, dec), (len(rows), n_t): the detectors' offsets turned by q(t)
    about the boresight's (ra, dec)."""
    t = lambda a: f64(a, device)  # noqa: E731
    cq, sq = torch.cos(t(start["q"])), torch.sin(t(start["q"]))
    ox, oy = t(start["offsets"][rows, 0])[:, None], t(start["offsets"][rows, 1])[:, None]
    return offsets_to_phi_theta(cq * ox - sq * oy, sq * ox + cq * oy, t(start["ra"]), t(start["dec"]))


def fields(start: dict, seed: int, device, precision: str = "none"):
    """Yield (band, rows, {"atmosphere", "cmb", "noise"}) in K_RJ, each
    (len(rows), n_t) float64, a band at a time (module docstring)."""
    q = rounder("bf16" if precision == "control" else "none")
    d = draws(start, seed, device)
    t = lambda a: f64(a, device)  # noqa: E731
    values = [screens_2d.screen_values(s, W, z.to(F64), q) for s, W, z in zip(start["screens"], start["W"],
                                                                           d["screens"])]
    n_t, fs, ratio = start["n_t"], start["sample_rate"], start["ratio"]
    n_fft = fft_size(n_t)
    sw, t_c = t(start["sw"]), t(start["t_c"])
    gain_error = np.zeros(len(start["offsets"]))
    for b in start["bands"]:
        gain_error[b["det_index"]] = b["gain_error"]
    gains = torch.exp(t(gain_error) * d["gains"].to(F64))
    cmb = start["cmb"]
    cmb_maps = [cmb[s].reshape(-1).to(device=device, dtype=F64) for s in range(cmb.shape[0])]
    for b, (white, modes) in zip(start["bands"], d["bands"]):
        rows = np.asarray(b["det_index"])
        r = torch.as_tensor(rows, device=device)
        offs = t(start["offsets"][rows])
        el_c, px, py = screens_2d.line_of_sight(offs, t(start["bs_az_c"]), t(start["bs_el_c"]))
        pwv = screens_2d.pwv(start["mean_pwv"], start["screens"], values, px, py, t_c, q)
        del px, py
        mueller = sw[r, 0, None]
        table = lambda name: table_bilinear(b["pwv_side"], b["el_side"], t(b[name]), pwv, el_c)  # noqa: E731
        atm = q(catmull_rom_upsample(q(mueller * q(table("loading"))), ratio, n_t))
        pwv_f, el_f = q(linear_upsample(pwv, ratio, n_t)), q(catmull_rom_upsample(el_c, ratio, n_t))
        del pwv, el_c
        fine = lambda name: table_bilinear(b["pwv_side"], b["el_side"], t(b[name]), pwv_f, el_f)  # noqa: E731
        ra, dec = det_radec(start, rows, device)
        lon, lat = radec_to_galactic(ra, dec) if start["cmb_frame"] == "galactic" else (ra, dec)
        pix = ring_pixels(start["nside"], math.pi / 2 - lat, lon)
        del ra, dec, lon, lat
        sky = q(sum(sw[r, s, None] * cmb_maps[s][pix] for s in range(len(cmb_maps))))
        del pix
        cmb_field = q(q(fine("P0") * mueller) + q(fine("dPdT") * sky))
        del pwv_f, el_f, sky
        c = t(knee_spectrum(fs, b["knee"], n_fft, 1.0, 1.0 - b["corr_prop"]))
        z = white.to(F64)
        unit = q(torch.fft.irfft(c * torch.complex(z[..., 0], z[..., 1]), n=n_fft)[:, :n_t])
        if modes is not None:
            cm = t(knee_spectrum(fs, b["knee"], n_fft, 0.0, 1.0))
            zm = modes.to(F64)
            series = q(torch.fft.irfft(cm * torch.complex(zm[..., 0], zm[..., 1]), n=n_fft)[:, :n_t])
            unit = q(unit + q(math.sqrt(b["corr_prop"]) * t(b["basis"]) @ series))
        noise = q(1e12 * b["NEP"] * unit)
        del unit
        _, el = offsets_to_phi_theta(offs[:, 0, None], offs[:, 1, None], t(start["bs_az"])[None],
                                     t(start["bs_el"])[None])
        k_rj = 1e-12 / ((0.5 if b["polarized"] else 1.0) * K_B
                        * el_interp(b["el_side"], b["transmission"], torch.clamp(el, max=math.pi / 2)))
        del el
        g = gains[r, None]
        yield b, rows, {"atmosphere": q(q(g * atm) * k_rj), "cmb": q(q(g * cmb_field) * k_rj),
                        "noise": q(noise * k_rj)}
