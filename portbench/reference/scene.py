"""The scene of a total-power realization, worked out in float64 from
the configuration and the observation's inputs, with none of the
program's code and none of the tables it made.

The inputs (``inputs`` below) are what a user hands the simulator or
what its discretization and weather draw fix: the detectors' offsets
and bands, the boresight at the sample rate, the coarse time step, the
weather's mean pwv and base temperature, each screen group's layer
heights, line-of-sight distances, pwv rms, wind and grid, and the path
of the atmospheric spectrum's grid file (raw data that both sides
read). From them and the configuration this module makes what the
realization needs: the coarse pointing, the 3-D Matérn operators of each
group (the vertical quadrature, the per-node spectral amplitudes, the
layer mixing and the beam), each band's passband and its (pwv,
elevation) loading table, NEP, knee and focal-plane noise basis, the
gains' widths, and the field map's pixel ids. ``start`` returns them in
the form that ``total_power.total_power_blocks`` reads.
"""

from __future__ import annotations

import math

import numpy as np
import scipy as sp
import torch

from .common import C, F64, K_B, offsets_to_phi_theta, phi_theta_to_offsets

NU_3D = 1 / 3  # the Matérn index of the 3-D turbulence model
KZ_NODES = (64, 32)  # uniform and geometric nodes of the vertical quadrature
BASIS_MODES, BASIS_SIDE = 5, 16  # the correlated noise's modes and its grid over a band's focal plane


def support(band: dict) -> tuple:
    """(nu, tau): a Gaussian band's transmission, half at half its width
    from the centre, sampled at 1,024 frequencies over 1.5 widths a side."""
    if band.get("shape", "gaussian") != "gaussian":
        raise ValueError(f"the reference knows Gaussian passbands, not '{band['shape']}'")
    center, width = band["center"], band["width"]
    nu = np.linspace(center - 1.5 * width, center + 1.5 * width, 1024)
    return nu, np.exp(np.log(0.5) * (2 * (nu - center) / width) ** 2)


def passband(band: dict, nu):
    """efficiency x the band's transmission at ``nu`` (Hz): linear between
    the samples of its support and 0 outside."""
    grid, tau = support(band)
    return band.get("efficiency", 0.5) * np.interp(np.asarray(nu, dtype=float), grid, tau, left=0, right=0)


def band_center(band: dict) -> float:
    """The centroid of the band's transmission, Hz."""
    nu = np.linspace(band["center"] - 3 * band["width"], band["center"] + 3 * band["width"], 4096)
    tau = passband(band, nu)
    return float(np.sum(nu * tau) / np.sum(tau))


def loading_table(grids: dict, band: dict, base_temperature: float) -> tuple:
    """(pwv_side, el_side, table): the band's atmospheric loading in pW,
    1e12 k_B times the integral over frequency of the Rayleigh-Jeans
    brightness times the passband, on the grid's (pwv, elevation) nodes,
    linear in the base temperature."""
    nu = grids["side_nu_Hz"]
    values = 1e12 * K_B * np.trapezoid(grids["rayleigh_jeans_temperature_K"] * passband(band, nu), nu, axis=-1)
    T = grids["side_base_temperature_K"]
    i = int(np.clip(np.searchsorted(T, base_temperature) - 1, 0, len(T) - 2))
    w = float(np.clip((base_temperature - T[i]) / (T[i + 1] - T[i]), 0, 1))
    return grids["side_zenith_pwv_mm"], grids["side_elevation_rad"], (1 - w) * values[i] + w * values[i + 1]


def kz_nodes(nu: float, r0: float, heights) -> tuple:
    """(kz, weights): the vertical-wavenumber quadrature of a 3-D Matérn
    field sliced at ``heights``: midpoint nodes at spacing pi / dz_max,
    then geometric nodes up to pi / dz_min, each weighted by the 1-D
    restriction spectrum (2 nu / r0^2 + kz^2)^-(nu + 1/2) over its width,
    normalized to sum 1. dz_max is 2.5 x the heights' span + 1 km; dz_min
    half their least spacing, at least 5 m."""
    h = np.sort(np.asarray(heights, dtype=float))
    dz_max = 2.5 * max(h[-1] - h[0], 1.0) + 1e3
    dz_min = max(5.0, 0.5 * np.diff(h).min()) if len(h) > 1 else 5.0
    n1, n2 = KZ_NODES
    dk = math.pi / dz_max
    kz1 = (np.arange(n1) + 0.5) * dk
    edges = np.geomspace(n1 * dk, max(math.pi / dz_min, 4 * n1 * dk), n2 + 1)
    kz2 = np.sqrt(edges[:-1] * edges[1:])
    s2 = 2 * nu / r0**2
    w = np.concatenate([(s2 + kz1**2) ** -(nu + 0.5) * dk, (s2 + kz2**2) ** -(nu + 0.5) * np.diff(edges)])
    return np.concatenate([kz1, kz2]), w / w.sum()


def group_operators(group: dict, beam_sigmas, device) -> dict:
    """W (J, ny, nx//2+1), M_cos and M_sin (L, J), beam (L, ny, nx//2+1):
    each node's 2-D slice of the 3-D Matérn spectrum (2 nu / r0^2 + k^2 +
    kz^2)^-(nu + 3/2), its grid variance scaled to the node's weight and
    the horizontal DC bin zeroed; the layers' cos and sin of kz h; each
    layer's Gaussian beam exp(-sigma^2 k^2 / 2). r0, the outer scale, is
    the model's max(1 km, 300 m + a tenth of the mean height)."""
    heights = np.asarray(group["heights"], dtype=float)
    r0 = max(1e3, 300 + heights.mean() / 10)
    kz, w_node = kz_nodes(NU_3D, r0, heights)
    ny, nx, res = group["ny"], group["nx"], group["res"]
    ky = 2 * math.pi * torch.fft.fftfreq(ny, d=res, dtype=F64, device=device)
    kx = 2 * math.pi * torch.fft.rfftfreq(nx, d=res, dtype=F64, device=device)
    k2 = ky[:, None] ** 2 + kx[None, :] ** 2
    kz_t = torch.as_tensor(kz, dtype=F64, device=device)
    S = (2 * NU_3D / r0**2 + k2[None] + kz_t[:, None, None] ** 2) ** -(NU_3D + 1.5)
    S[:, 0, 0] = 0.0
    fold = torch.full((nx // 2 + 1,), 2.0, dtype=F64, device=device)  # each rfft column stands for two
    fold[0] = 1.0
    if nx % 2 == 0:
        fold[-1] = 1.0
    node_var = (S * fold).sum(dim=(1, 2)) / (ny * nx)
    W = torch.sqrt(S * (torch.as_tensor(w_node, dtype=F64, device=device) / node_var)[:, None, None])
    sig = torch.as_tensor(np.asarray(beam_sigmas, dtype=float), dtype=F64, device=device)
    return {"W": W, "M_cos": np.cos(np.outer(heights, kz)), "M_sin": np.sin(np.outer(heights, kz)),
            "beam": torch.exp(-0.5 * sig[:, None, None] ** 2 * k2[None])}


def beam_sigma(z: float, aperture: float, centers, counts) -> float:
    """The detectors' mean Gaussian beam width in metres at distance z: a
    Gaussian beam of waist aperture / 2 at each band's wavelength, FWHM
    2 w0 sqrt(1 / z^2 + 1 / z_R^2) radians, z_R = pi w0^2 / lambda, over
    2.355."""
    w0 = aperture / 2
    fwhm = [z * 2 * w0 * math.sqrt(1 / z**2 + (C / nu / (math.pi * w0**2)) ** 2) for nu in centers]
    return float(np.dot(fwhm, counts) / np.sum(counts)) / 2.355


def matern_five_halves(r):
    """The simulator's Matérn-5/2 covariance of the correlated noise,
    (1 + sqrt(3) r + 5 r^2 / 3) exp(-sqrt(5) r), as maria defines it."""
    return (1 + math.sqrt(3) * r + (5.0 / 3.0) * r**2) * np.exp(-math.sqrt(5) * r)


def diameter(points: np.ndarray, device) -> float:
    """The largest distance between two of the points."""
    p = torch.as_tensor(points, dtype=F64, device=device)
    exact = "donot_use_mm_for_euclid_dist"
    return max(float(torch.cdist(p[i:i + 2048], p, compute_mode=exact).max()) for i in range(0, len(p), 2048))


def noise_basis(offsets: np.ndarray, scale: float) -> np.ndarray:
    """(n, 5): the leading eigenmodes of the covariance
    matern_five_halves(distance / scale) on a 16 x 16 grid spanning the
    offsets, each scaled by the root of its eigenvalue, interpolated to
    the offsets by an interpolating bicubic spline, signed so the first
    mode's mean is positive."""
    lo, hi = offsets.min(axis=0), offsets.max(axis=0)
    x, y = np.linspace(lo[0], hi[0], BASIS_SIDE), np.linspace(lo[1], hi[1], BASIS_SIDE)
    grid = np.stack(np.meshgrid(x, y, indexing="ij"), axis=-1).reshape(-1, 2)
    dist = np.sqrt(((grid[:, None] - grid[None, :]) ** 2).sum(axis=-1)) / max(scale, 1e-16)
    evals, evecs = np.linalg.eigh(matern_five_halves(dist))
    order = np.argsort(evals)[::-1][:BASIS_MODES]
    modes = (evecs[:, order] * np.sqrt(np.maximum(evals[order], 0.0))).reshape(BASIS_SIDE, BASIS_SIDE, -1)
    B = np.stack([sp.interpolate.RectBivariateSpline(x, y, modes[..., j], kx=3, ky=3, s=0)(
        offsets[:, 0], offsets[:, 1], grid=False) for j in range(modes.shape[-1])], axis=-1)
    return B * np.sign(B[:, 0].mean() or 1.0)


def coarse_pointing(inputs: dict) -> tuple:
    """(t_c, az_c, el_c, ratio): the boresight linearly interpolated at the
    coarse steps from the first sample, times from the first sample, and
    the fine samples a coarse step."""
    t = np.asarray(inputs["t"], dtype=float)
    ds_t = np.arange(t.min(), t.max(), inputs["timestep"])
    az = np.interp(ds_t, t, np.asarray(inputs["bs_az"], dtype=float))
    el = np.interp(ds_t, t, np.asarray(inputs["bs_el"], dtype=float))
    return ds_t - t[0], az, el, int(round(inputs["timestep"] * inputs["sample_rate"]))


def field_ids(inputs: dict, n_x: int, n_y: int, device, q=lambda x: x, rows: int = 4096):
    """Yield (r0, r1, ids) of the field map: each sample's tangent-plane
    offset about the mean boresight, on an n_x x n_y grid whose half-width
    is 1.02 x the largest offset (+1e-8), clipped to its edge; ``q``
    rounds the detectors' az and el (the control's precision)."""
    offsets = torch.as_tensor(np.asarray(inputs["offsets"], dtype=float), dtype=F64, device=device)
    az, el = (torch.as_tensor(np.asarray(inputs[k], dtype=float), dtype=F64, device=device) for k in ("bs_az", "bs_el"))
    c_az, c_el = float(az.mean()), float(el.mean())

    def offs(r0, r1):
        phi, theta = offsets_to_phi_theta(offsets[r0:r1, 0, None], offsets[r0:r1, 1, None], az[None], el[None])
        return phi_theta_to_offsets(q(phi), q(theta), c_az, c_el)

    blocks = [(r0, min(r0 + rows, len(offsets))) for r0 in range(0, len(offsets), rows)]
    half = max(float(torch.maximum(ox.abs().max(), oy.abs().max())) for ox, oy in (offs(*b) for b in blocks))
    half = half * 1.02 + 1e-8
    res = 2 * half / n_x
    for r0, r1 in blocks:
        ox, oy = offs(r0, r1)
        ix = torch.clamp(torch.floor((ox + half) / res), 0, n_x - 1).to(torch.int64)
        iy = torch.clamp(torch.floor((oy + half) / res), 0, n_y - 1).to(torch.int64)
        yield r0, r1, iy * n_x + ix


def start(config: dict, inputs: dict, device) -> dict:
    """The realization's scene in the form ``total_power_blocks`` reads."""
    bands_cfg = config["array"]["bands"]
    names = np.asarray(inputs["band_name"])
    det_index = [np.nonzero(names == b["name"])[0] for b in bands_cfg]
    centers = [band_center(b) for b in bands_cfg]
    counts = [len(d) for d in det_index]
    groups = []
    for g in inputs["groups"]:
        sig = [beam_sigma(z, config["array"]["primary_size"], centers, counts) for z in g["zs"]]
        groups.append({**g, **group_operators(g, sig, device)})
    with np.load(inputs["spectrum_path"]) as f:
        grids = {k: f[k].astype(float) for k in ("side_base_temperature_K", "side_zenith_pwv_mm",
                                                  "side_elevation_rad", "side_nu_Hz", "rayleigh_jeans_temperature_K")}
    noise = config.get("noise_kwargs", {})
    cp = noise.get("correlated_noise_proportion", 0.5)
    offsets = np.asarray(inputs["offsets"], dtype=float)
    bands = []
    for b, idx in zip(bands_cfg, det_index):
        pwv_side, el_side, table = loading_table(grids, b, inputs["base_temperature"])
        basis = None
        fov = diameter(offsets[idx], device) if len(idx) > 16 else 0.0
        if cp > 0 and fov > 0:
            basis = noise_basis(offsets[idx], fov * noise.get("correlated_noise_spatial_scale", 1.0))
        bands.append({"det_index": idx, "pwv_side": pwv_side, "el_side": el_side, "table": table,
                      "NEP": float(b["NEP"]), "knee": float(b.get("knee", 1.0)),
                      "corr_prop": cp if basis is not None else 0.0, "basis": basis})
    t_c, az_c, el_c, ratio = coarse_pointing(inputs)
    gain_error = np.zeros(len(offsets))
    for b, idx in zip(bands_cfg, det_index):
        gain_error[idx] = b.get("gain_error", 0.0)
    polarized = config["array"].get("polarized", False)
    return {
        "groups": groups, "bands": bands, "band_order": sorted(range(len(bands)), key=lambda i: det_index[i][0]),
        "offsets": offsets, "bs_az": az_c, "bs_el": el_c, "t_c": t_c, "mean_pwv": float(inputs["mean_pwv"]),
        "mueller_I": np.full(len(offsets), 0.5 if polarized else 1.0), "gain_error": gain_error,
        "sample_rate": float(inputs["sample_rate"]), "n_t": int(inputs["n_t"]), "ratio": ratio,
    }
