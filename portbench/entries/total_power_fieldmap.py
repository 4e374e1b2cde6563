"""Entry: the total-power realization and its field map.

Set-up builds the configuration's ``Simulation``, its program
(``Simulation.program()``), the program's ``total_power_fn()`` and the
field map's pixel ids (``mappers.bin_mapper.field_pixel_ids``, once: the
pointing is fixed), and keeps the observation's inputs for the check
(``inputs``: what the configuration, the discretization and the weather
fix, and nothing the program computed from them). A realization seeds
one generator on the card, calls the function, and bins the total into
the map with ``mappers.bin_mapper.bin_total``.

The check, once the window has closed, works the scene out anew from the
configuration and the inputs (``reference/scene.py``) and follows the
plain reference (``reference/total_power.py``) from it, each
realization's draws made anew from the realization's seed. It compares:

- ``tod_gap``: the largest gap between the program's total and the
  reference's, over every sample, in units of the reference noise's rms;
- ``tod_rms_gap``: the rms of that gap in the same units;
- ``noise_scale_gap``: |b - 1|, b the least-squares scale of the
  reference noise in the program's total less the reference signal: the
  noise's amplitude, which the float32 total's rounding of a loading
  ~6e5 times the noise rms leaves unbiased;
- ``ids_gap``: the share of samples whose field-map pixel id from set-up
  differs from the reference's float64 id;
- ``map_gap``: the largest gap between the program's binned sums and the
  float64 sums of the program's own total at the program's ids (checked
  by themselves in ``ids_gap``), over the largest sum;
- ``hits_gap``: the largest difference of the hit counts (exact).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import scene
from ..reference import scene as ref_scene
from ..reference.common import rounder
from ..reference.total_power import total_power_blocks

GROUP_INPUTS = ("heights", "zs", "pwv_rms", "angle", "vx", "vy", "res", "tx_min", "ty_min", "nx", "ny")


def setup(config: dict, traffic: dict, seed: int, device) -> dict:
    from maria_torch.mappers.bin_mapper import field_pixel_ids

    sim = scene.simulation(config, traffic["duration_s"], seed, device)
    program = sim.program()
    obs = sim.obs_list[0]
    fmap = config["field_map"]
    ids, n_pix = field_pixel_ids(obs.boresight, obs.offsets, fmap["n_x"], fmap["n_y"], device=device)
    if program.screens or not program.use_noise_matmul():
        raise ValueError("the total-power reference covers 3-D screen groups and the one-product noise")
    return {"program": program, "fn": program.total_power_fn(), "ids": ids, "n_pix": n_pix, "device": device,
            "generator": torch.Generator(device=device), "inputs": inputs(obs, config)}


def inputs(obs, config: dict) -> dict:
    """What the check starts from: the detectors' offsets and bands, the
    boresight at the sample rate, the coarse step, the weather's mean pwv
    and temperature, each screen group's heights, distances, pwv rms,
    wind and grid, and the atmospheric spectrum's grid file."""
    atm = obs.atmosphere
    b = obs.boresight
    return {
        "config": config, "offsets": np.asarray(obs.offsets, dtype=np.float64),
        "band_name": np.asarray(obs.instrument.dets.band_name), "t": np.asarray(b.t, dtype=np.float64),
        "bs_az": np.asarray(b.az, dtype=np.float64), "bs_el": np.asarray(b.el, dtype=np.float64),
        "sample_rate": float(obs.sample_rate), "n_t": len(b.t), "timestep": float(atm.timestep),
        "mean_pwv": float(atm.weather.pwv), "base_temperature": float(atm.weather.temperature[0]),
        "spectrum_path": atm.spectrum.cache_path,
        "groups": [{k: (np.asarray(getattr(g, k), dtype=np.float64) if k in ("heights", "zs", "pwv_rms")
                        else getattr(g, k)) for k in GROUP_INPUTS} for g in atm.groups],
    }


def realize(state: dict, seed: int, span) -> dict:
    from maria_torch.mappers.bin_mapper import bin_total

    g = state["generator"]
    g.manual_seed(seed)
    with span("synthesis"):
        total = state["fn"](generator=g, device=state["device"])
    with span("map"):
        sums, hits = bin_total(total, state["ids"], state["n_pix"])
    return {"total": total, "sums": sums, "hits": hits, "ids": state["ids"], "n_pix": state["n_pix"],
            "inputs": state["inputs"]}


def held_bytes(out: dict) -> int:
    return sum(out[k].numel() * out[k].element_size() for k in ("total", "sums", "hits"))


def samples(state: dict) -> int:
    return state["program"].n_det * state["program"].n_t


def counters() -> dict:
    from maria_torch.ops.bin_map import bin_map
    from maria_torch.ops.shared_v import shared_v

    return {"bin_map": bin_map.launches, "shared_v": shared_v.launches}


def work(state: dict) -> dict:
    """Each work item's shapes a realization, for its cost file."""
    p = state["program"]
    specs, corr_cols, n_fft, _, _ = p._noise_matmul_specs()
    k_modes = 0 if corr_cols is None else corr_cols.shape[1]
    return {
        "noise_gemm": {"calls": 1, "m": p.n_det, "k": 2 * (n_fft // 2 + 1) + k_modes, "n": p.n_t},
        "k2": {"calls": 1, "values": p.n_det * p.n_t, "n_pix": state["n_pix"], "maps": 2},
    }


def reference_start(inputs: dict, device) -> dict:
    """The reference's scene, worked out once per run, after the window."""
    if "reference" not in inputs:
        inputs["reference"] = ref_scene.start(inputs["config"], inputs, device)
    return inputs["reference"]


def field_ids(inputs: dict, device, q=lambda x: x) -> torch.Tensor:
    """The field map's pixel ids, (n_det, n_t) int64, worked out by the
    reference with its angles rounded by ``q``."""
    fmap = inputs["config"]["field_map"]
    ids = torch.empty((len(inputs["offsets"]), inputs["n_t"]), dtype=torch.int64, device=device)
    for r0, r1, block in ref_scene.field_ids(inputs, fmap["n_x"], fmap["n_y"], device, q):
        ids[r0:r1] = block
    return ids


def reference_ids(inputs: dict, device) -> torch.Tensor:
    """The field map's float64 pixel ids, worked out once per run."""
    if "reference_ids" not in inputs:
        inputs["reference_ids"] = field_ids(inputs, device)
    return inputs["reference_ids"]


def readings(total, sums, hits, ids, n_pix: int, inputs: dict, seed: int, device) -> dict:
    """The check's numbers for one realization's outputs (at the pixel
    ids ``ids``) against the float64 reference."""
    start = reference_start(inputs, device)
    ids = ids.to(device=device, dtype=torch.int64)
    gap_max = gap_sq = noise_sq = cross = 0.0
    n = 0
    ref_sums = torch.zeros(n_pix, dtype=torch.float64, device=device)
    for r0, r1, ref_total, ref_noise in total_power_blocks(start, seed, device):
        got = total[r0:r1].to(device=device, dtype=torch.float64)
        gap = got - ref_total
        gap_max = max(gap_max, float(gap.abs().max()))
        gap_sq += float((gap**2).sum())
        noise_sq += float((ref_noise**2).sum())
        cross += float(((gap + ref_noise) * ref_noise).sum())
        n += gap.numel()
        ref_sums.index_add_(0, ids[r0:r1].reshape(-1), got.reshape(-1))
    noise_rms = (noise_sq / n) ** 0.5
    ref_hits = torch.bincount(ids.reshape(-1), minlength=n_pix)
    return {
        "tod_gap": gap_max / noise_rms,
        "tod_rms_gap": (gap_sq / n) ** 0.5 / noise_rms,
        "noise_scale_gap": abs(cross / noise_sq - 1.0),
        "ids_gap": float((ids != reference_ids(inputs, device)).sum()) / ids.numel(),
        "map_gap": float((sums.to(device=device, dtype=torch.float64) - ref_sums).abs().max()
                         / ref_sums.abs().max()),
        "hits_gap": float((hits.to(device=device, dtype=torch.float64) - ref_hits.to(torch.float64)).abs().max()),
    }


def judge(kept: list, config: dict, traffic: dict, device) -> dict:
    """The worst reading of each number over the checked realizations."""
    worst = {}
    for _, seed, out in kept:
        r = readings(out["total"], out["sums"], out["hits"], out["ids"], out["n_pix"], out["inputs"], seed, device)
        for k, v in r.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def control(out: dict, seed: int, device, noise_only: bool = False) -> dict:
    """The check's numbers with the control in the program's place: the
    reference computed one step below the configuration's precision (its
    atmosphere and its detectors' az and el in bfloat16, its noise product
    of fp8 operands, its map summed in bfloat16). ``noise_only`` lowers
    the noise product alone, at the float64 ids and sums."""
    inputs = out["inputs"]
    start = reference_start(inputs, device)
    ids = reference_ids(inputs, device) if noise_only else field_ids(inputs, device, rounder("bf16"))
    n_pix = out["n_pix"]
    total = torch.empty((len(start["offsets"]), start["n_t"]), dtype=torch.float32, device=device)
    sums = torch.zeros(n_pix, dtype=torch.float64, device=device)
    q = (lambda x: x) if noise_only else (lambda x: x.to(torch.bfloat16).to(torch.float64))
    for r0, r1, block, _ in total_power_blocks(start, seed, device, "control_noise" if noise_only else "control"):
        total[r0:r1] = block
        sums.index_add_(0, ids[r0:r1].reshape(-1), q(block).reshape(-1))
    hits = torch.bincount(ids.reshape(-1), minlength=n_pix)
    return readings(total, q(sums), hits, ids, n_pix, inputs, seed, device)


def fault(state: dict, seed: int, device, kind: str) -> dict:
    """The check's numbers for a fault planted in the program:
    "noise_loud", the noise product's per-row NEP scale 1.25 times the
    configuration's; "half_binned", the map binned from the first half of
    the detectors alone."""
    tabs = state["program"]._tensors(device)
    if "row_scale" not in tabs:  # made by the program's first call
        realize(state, seed, lambda name: contextlib.nullcontext())
    scale = tabs["row_scale"]
    if kind == "noise_loud":
        tabs["row_scale"] = 1.25 * scale
    try:
        out = realize(state, seed, lambda name: contextlib.nullcontext())
    finally:
        tabs["row_scale"] = scale
    if kind == "half_binned":
        from maria_torch.mappers.bin_mapper import bin_total

        half = out["total"].shape[0] // 2
        out["sums"], out["hits"] = bin_total(out["total"][:half], out["ids"][:half], out["n_pix"])
    return readings(out["total"], out["sums"], out["hits"], out["ids"], out["n_pix"], out["inputs"], seed, device)


# what the calibration reads besides the control: the noise product alone
# lowered to fp8, and the faults planted in the program
VARIANTS = {
    "control_noise": lambda state, out, seed, device: control(out, seed, device, noise_only=True),
    "noise_loud": lambda state, out, seed, device: fault(state, seed, device, "noise_loud"),
    "half_binned": lambda state, out, seed, device: fault(state, seed, device, "half_binned"),
}
