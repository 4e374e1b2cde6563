"""Entry: ``Simulation.run()`` and the IQU maximum-likelihood map.

Set-up builds the configuration's ``Simulation`` (its CMB drawn from
the run's seed) and keeps the observation's inputs for the check
(``inputs``: the detectors' offsets, polarization angles and bands, the
boresight in az/el at the sample rate and the CMB map with its frame;
nothing the
program computed from them). A realization seeds the simulation's
generator, runs ``Simulation.run()`` (the TOD in K_RJ), builds the
configuration's ``MaximumLikelihoodMapper`` on it (its preprocessing,
pixel ids and binned starting map) and fits it with the traffic's
epochs and steps.

The check, once the window has closed, works the scene out anew from
the configuration and the inputs: each band's passband, NEP, pW -> K_RJ
factor, CMB loading and focal-plane noise basis, the Stokes weights,
each sample's (ra, dec) from the site's ephemeris and its HEALPix pixel,
the map's geometry and pixel ids (``reference/scene.py``,
``reference/sky.py``), and follows the plain reference
(``reference/ml_map.py``) in two stages. The TOD from the realization's
seed; the map from the program's TOD at the program's mapper pixel ids
(checked by themselves in ``ids_gap``). It compares:

- ``tod_gap``: the largest gap between the program's TOD and the
  reference's over every sample, in units of the reference noise's rms;
- ``tod_rms_gap``: the rms of that gap in the same units;
- ``ids_gap``: the share of samples whose mapper pixel id differs from
  the reference's float64 id;
- ``map_gap``: the gap between the program's fitted map and the
  reference's fit of the program's TOD in the norm of the fit's own
  operator, sqrt(e^T A e / m^T A m) with A = P^T N^-1 P of the last
  epoch, e the gap and m the reference's map: the norm in which conjugate
  gradients converge. Unconverged after 25 steps, the fit's float32 and
  float64 iterates part along the operator's weakest directions, where
  rounding steers them; this norm weighs each direction by how well the
  data fix it, so it reads what the data determine;
- ``hits_gap``: the largest gap between the program's |w|-weighted hit
  map and the reference's, over the largest hit count.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import scene
from ..reference import ml_map as ref
from ..reference import scene as ref_scene
from ..reference import sky
from ..reference.common import F64, offsets_to_phi_theta, phi_theta_to_offsets, rounder


def _mapper(config: dict, tod):
    import maria_torch

    m = config["mapper"]
    return maria_torch.MaximumLikelihoodMapper(tods=[tod], frame=m["frame"], resolution=m["resolution"],
                                               tod_preprocessing=m["tod_preprocessing"])


def setup(config: dict, traffic: dict, seed: int, device) -> dict:
    sim = scene.simulation(config, traffic["duration_s"], seed, device)
    obs = sim.obs_list[0]
    dets = obs.instrument.dets
    b = obs.boresight
    inputs = {
        "config": config, "offsets": np.asarray(obs.offsets, dtype=np.float64),
        "gamma": np.asarray(dets.gamma, dtype=np.float64), "band_name": np.asarray(dets.band_name),
        "t": np.asarray(b.t, dtype=np.float64), "bs_az": np.asarray(b.az, dtype=np.float64),
        "bs_el": np.asarray(b.el, dtype=np.float64), "sample_rate": float(obs.sample_rate),
        "cmb": sim.cmb.data, "nside": int(sim.cmb.nside), "cmb_frame": sim.cmb.frame,
    }
    return {"sim": sim, "config": config, "traffic": traffic, "device": device, "inputs": inputs}


def realize(state: dict, seed: int, span) -> dict:
    sim, fit = state["sim"], state["traffic"]["fit"]
    sim.generator.manual_seed(seed)
    with span("synthesis"):
        tod = sim.run()[0]
    with span("map"):
        mapper = _mapper(state["config"], tod)
        mapper.fit(epochs=fit["epochs"], steps_per_epoch=fit["steps_per_epoch"])
    state["n_cpix"] = mapper.n_cpix
    return {"tod": tod, "m": mapper.m, "hits": mapper.hits, "pix": mapper.blocks[0]["pix"], "fit": fit,
            "inputs": state["inputs"], "config": state["config"]}


def held_bytes(out: dict) -> int:
    tensors = [*out["tod"].data.values(), out["m"], out["hits"]]
    return sum(t.numel() * t.element_size() for t in tensors)


def samples(state: dict) -> int:
    return len(state["inputs"]["offsets"]) * len(state["inputs"]["t"])


def counters() -> dict:
    from maria_torch.ops.bin_map import bin_map
    from maria_torch.ops.pink_noise import pink_noise

    return {"bin_map": bin_map.launches, "pink_noise": pink_noise.launches}


def work(state: dict) -> dict:
    """K2 as the fit's P^T: the TOD and its ids read once, three Stokes
    weights a detector, the I, Q, U maps (every band's frame) written
    once; ``calls`` left to K2's launch counter."""
    n_det, n_t = len(state["inputs"]["offsets"]), len(state["inputs"]["t"])
    return {"k2": {"calls": None, "values": n_det * n_t, "weights": 3 * n_det, "n_pix": state["n_cpix"], "maps": 3}}


def reference_start(inputs: dict, device) -> dict:
    """The reference's scene, worked out once per run, after the window."""
    if "reference" in inputs:
        return inputs["reference"]
    config = inputs["config"]
    offsets, gamma, names = inputs["offsets"], inputs["gamma"], inputs["band_name"]
    noise = config.get("noise_kwargs", {})
    cp = noise.get("correlated_noise_proportion", 0.5)
    polarized = ~np.isnan(gamma)
    bands = []
    for spec in config["array"]["bands"]:
        idx = np.nonzero(names == spec["name"])[0]
        nu, tau = ref_scene.support(spec)
        band_pass = spec.get("efficiency", 0.5) * tau
        nep = spec["NEP"] if "NEP" in spec else spec["NET_RJ"] * sky.rj_power_per_kelvin(nu, band_pass, False)
        P0, dPdT = sky.cmb_band_powers(nu, band_pass)
        fov = ref_scene.diameter(offsets[idx], device) if len(idx) > 16 else 0.0
        basis = None
        if cp > 0 and fov > 0:
            basis = ref_scene.noise_basis(offsets[idx], fov * noise.get("correlated_noise_spatial_scale", 1.0))
        bands.append({
            "name": spec["name"], "center": ref_scene.band_center(spec), "det_index": idx, "NEP": float(nep),
            "knee": float(spec.get("knee", 1.0)), "corr_prop": cp if basis is not None else 0.0, "basis": basis,
            "P0": P0, "dPdT": dPdT,
            "to_K_RJ": 1e-12 / sky.rj_power_per_kelvin(nu, band_pass, bool(polarized[idx].any())),
        })
    g = np.where(polarized, gamma, 0.0)
    stokes_weight = np.where(polarized[:, None], 0.5 * np.stack([np.ones_like(g), np.cos(2 * g), np.sin(2 * g)], 1),
                             np.array([1.0, 0.0, 0.0]))
    gain_error = np.zeros(len(offsets))
    for spec, b in zip(config["array"]["bands"], bands):
        gain_error[b["det_index"]] = spec.get("gain_error", 0.0)

    # each sample's (ra, dec): the detector's offset turned by q about the boresight's
    site = config["site"]
    ra, dec, q = sky.boresight_radec(inputs["bs_az"], inputs["bs_el"], inputs["t"], math.radians(site["latitude"]),
                                     math.radians(site["longitude"]))
    f64 = lambda a: torch.as_tensor(np.asarray(a, dtype=float), dtype=F64, device=device)  # noqa: E731
    cq, sq = torch.cos(f64(q)), torch.sin(f64(q))
    ox, oy = f64(offsets[:, 0])[:, None], f64(offsets[:, 1])[:, None]
    det_ra, det_dec = offsets_to_phi_theta(cq * ox - sq * oy, sq * ox + cq * oy, f64(ra), f64(dec))
    lon, lat = sky.radec_to_galactic(det_ra, det_dec) if inputs["cmb_frame"] == "galactic" else (det_ra, det_dec)
    pix = sky.ring_pixels(inputs["nside"], math.pi / 2 - lat, lon)
    del lon, lat
    cmb = inputs["cmb"]
    cmb_samples = torch.stack([cmb[s].reshape(-1).to(device=device, dtype=F64)[pix] for s in range(cmb.shape[0])])
    del pix
    _, det_el = offsets_to_phi_theta(ox, oy, f64(inputs["bs_az"]), f64(inputs["bs_el"]))

    # the mapper's geometry: the boresight's spherical mean, a square 2.05 x the largest offset wide
    mapper = config["mapper"]
    xyz = torch.stack([torch.cos(f64(ra)) * torch.cos(f64(dec)), torch.sin(f64(ra)) * torch.cos(f64(dec)),
                       torch.sin(f64(dec))]).mean(dim=1)
    c_ra, c_dec = float(torch.atan2(xyz[1], xyz[0])) % (2 * math.pi), float(torch.asin(xyz[2] / xyz.norm()))
    bx, by = phi_theta_to_offsets(f64(ra), f64(dec), c_ra, c_dec)
    half = float(torch.maximum(bx.abs().max(), by.abs().max())) + float(np.abs(offsets).max())
    res = math.radians(mapper["resolution"])
    n_x = max(math.ceil(2.05 * half / res), 1)
    n_pix = n_x * n_x
    channel = torch.zeros(len(offsets), dtype=torch.int64, device=device)
    for k, i in enumerate(sorted(range(len(bands)), key=lambda i: bands[i]["center"])):
        channel[torch.as_tensor(bands[i]["det_index"], device=device)] = k

    def map_pix(q):
        """Each sample's pixel of its band's map (the frame's last bucket
        off the map), its (ra, dec) rounded by ``q``."""
        dx, dy = phi_theta_to_offsets(q(det_ra), q(det_dec), c_ra, c_dec)
        x0 = -(n_x - 1) / 2 * res
        ix, iy = torch.round((dx - x0) / res).long(), torch.round((dy - x0) / res).long()
        inside = (ix >= 0) & (ix < n_x) & (iy >= 0) & (iy < n_x)
        return torch.where(inside, iy * n_x + ix, n_pix) + channel[:, None] * (n_pix + 1)
    spline = mapper["tod_preprocessing"]["remove_spline"]
    inputs["reference"] = {
        "bands": bands, "n_det": len(offsets), "n_t": len(inputs["t"]), "sample_rate": inputs["sample_rate"],
        "stokes_weight": stokes_weight, "cmb_samples": cmb_samples, "gain_error": gain_error,
        "pix": map_pix(rounder("none")), "control_pix": map_pix(rounder("bf16")), "sw": stokes_weight,
        "n_pix": n_pix, "n_frames": len(bands),
        "knot_spacing": float(spline["knot_spacing"]), "el_order": int(spline.get("remove_el_gradient_order", 0)),
        "el_mean": det_el.mean(dim=0).cpu().numpy(),
    }
    return inputs["reference"]


def readings(tod_values, m, hits, pix, inputs: dict, seed: int, fit: dict, device, ids=None) -> dict:
    """The check's numbers for one realization's TOD and fitted map (made
    at the mapper pixel ids ``pix``); ``ids_gap`` reads ``ids``, ``pix``
    where not given."""
    start = reference_start(inputs, device)
    want, noise = ref.tod(start, seed, device)
    got = tod_values.to(device=device, dtype=torch.float64)
    noise_rms = float(noise.pow(2).mean().sqrt())
    gap = got - want
    out = {"tod_gap": float(gap.abs().max()) / noise_rms, "tod_rms_gap": float(gap.pow(2).mean().sqrt()) / noise_rms}
    del want, noise, gap
    pix = pix[:start["n_det"]].to(device=device, dtype=torch.int64)
    ids = pix if ids is None else ids
    out["ids_gap"] = float((ids != start["pix"]).sum()) / ids.numel()
    if m.numel() != 3 * start["n_frames"] * (start["n_pix"] + 1):
        return {**out, "map_gap": math.inf, "hits_gap": math.inf}  # another geometry than the reference's
    ref_m, ref_hits, A = ref.ml_map(got, {**start, "pix": pix}, fit["epochs"], fit["steps_per_epoch"])
    e = m.to(device=device, dtype=torch.float64).reshape(ref_m.shape) - ref_m
    out["map_gap"] = float((e * A(e)).sum() / (ref_m * A(ref_m)).sum()) ** 0.5
    hits = hits.to(device=device, dtype=torch.float64).reshape(ref_hits.shape)
    out["hits_gap"] = float((hits - ref_hits).abs().max() / ref_hits.abs().max())
    return out


def judge(kept: list, config: dict, traffic: dict, device) -> dict:
    """The worst reading of each number over the checked realizations."""
    worst = {}
    for _, seed, out in kept:
        r = readings(out["tod"].signal, out["m"], out["hits"], out["pix"], out["inputs"], seed, out["fit"], device)
        for k, v in r.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def control(out: dict, seed: int, device) -> dict:
    """The check's numbers with the control in the program's place: the
    reference's TOD and its fit of it in bfloat16, and its mapper pixel
    ids from the detectors' (ra, dec) rounded to bfloat16. Rounded so,
    the samples fall on a lattice ~20 pixels apart, which the fit solves
    with ease; the fit is read at the float64 ids, where the map is the
    cell's own."""
    inputs, fit = out["inputs"], out["fit"]
    start = reference_start(inputs, device)
    tod_values, _ = ref.tod(start, seed, device, precision="control")
    m, hits, _ = ref.ml_map(tod_values, start, fit["epochs"], fit["steps_per_epoch"], precision="control")
    return readings(tod_values, m, hits, start["pix"], inputs, seed, fit, device, ids=start["control_pix"])
