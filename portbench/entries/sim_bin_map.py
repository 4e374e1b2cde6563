"""Entry: ``Simulation.run()`` of an instrument of several arrays through
the 2-D atmosphere, with a CMB and noise, and BinMapper's IQU maps.

Set-up builds the configuration's ``Simulation`` (its instrument from the
configuration's ``arrays``, each with its bands' parameters; its CMB drawn
from the run's seed) and its program, and keeps the observation's inputs
for the check (``inputs``: the detectors' offsets, polarization angles and
bands, the boresight at the sample rate, the coarse step, the weather's
mean pwv and base temperature, each atmospheric screen's grid, height,
distance, pwv rms and wind, the CMB map and the spectrum's grid file;
nothing the program computed from them). A realization seeds the
simulation's generator, runs ``Simulation.run()`` (the TOD in K_RJ, by
field) under the span "synthesis" and ``BinMapper(tod, ...).run()`` under
"map".

Traced (the harness hands a span object that is on), a realization runs
with the program's own tracing on (``maria_torch.io.logging``), and
``counters`` returns the program's cumulative counters and span host
seconds, which the harness differences over the window; untraced runs
leave the program's tracing off.

The check, once the window has closed, works the scene out anew from the
configuration and the inputs (``reference/sim_tod.py``,
``reference/screens_2d.py``), the TOD from the realization's seed, and
bins the program's TOD at the program's pixel ids as the mapper defines
it (``reference/bin_map.py``). It compares:

- ``atmosphere_gap``, ``cmb_gap``, ``noise_gap``: the largest gap
  between the program's field and the reference's over every sample, in
  units of the reference noise's rms;
- ``tod_rms_gap``: the rms of the gap of the fields' sum, in those units;
- ``noise_scale_gap``: |b - 1|, b the least-squares scale of the
  reference noise in the program's;
- ``ids_gap``: the share of samples whose map pixel id differs from the
  reference's float64 id in the reference's geometry;
- ``map_gap_I``, ``map_gap_Q``, ``map_gap_U``: over the bands, the
  largest gap between the program's map and the reference's in the
  norm of the map's weights, sqrt(sum w e^2 / sum w m^2), e the gap and
  m the reference's map: the norm in which the binned map is the
  least-squares answer;
- ``hits_gap``: the largest gap between the program's weight maps and the
  reference's, over the largest weight.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from .. import scene
from ..reference import bin_map as ref_map
from ..reference import sim_tod as ref
from ..reference.common import F64, rounder

STOKES = "IQU"
FIELDS = ("atmosphere", "cmb", "noise")


def instrument(config: dict):
    """The configuration's instrument: one array a name, each band made
    from its parameters."""
    import maria_torch
    from maria_torch.band import Band

    arrays = {name: {**{k: v for k, v in a.items() if k != "bands"}, "bands": [Band(**s) for s in a["bands"]]}
              for name, a in config["arrays"].items()}
    return maria_torch.get_instrument(arrays=arrays)


def simulation(config: dict, duration: float, seed: int, device):
    """The configuration's Simulation, as ``scene.simulation`` makes one
    of a single array."""
    import maria_torch

    sky = config["sky"]
    return maria_torch.Simulation(
        instrument(config), plans=[scene.plan(config, duration)], site=scene.site(config),
        atmosphere=sky.get("atmosphere"),
        atmosphere_kwargs=sky.get("atmosphere_kwargs", {}), cmb=sky.get("cmb"), cmb_kwargs=sky.get("cmb_kwargs", {}),
        noise=config.get("noise", True), noise_kwargs=config.get("noise_kwargs", {}), seed=seed, device=device,
    )


SCREEN_INPUTS = ("h", "z", "res", "pwv_rms", "angle", "vx", "vy", "tx_min", "ty_min", "nx", "ny", "band")


def setup(config: dict, traffic: dict, seed: int, device) -> dict:
    sim = simulation(config, traffic["duration_s"], seed, device)
    sim.program()
    obs = sim.obs_list[0]
    atm, dets, b = obs.atmosphere, obs.instrument.dets, obs.boresight
    if atm.groups or any(s.W is None for s in atm.screens):
        raise ValueError("the reference covers the 2-D atmosphere's Fourier screens")
    inputs = {
        "config": config, "offsets": np.asarray(obs.offsets, dtype=np.float64),
        "gamma": np.asarray(dets.gamma, dtype=np.float64), "band_name": np.asarray(dets.band_name),
        "t": np.asarray(b.t, dtype=np.float64), "bs_az": np.asarray(b.az, dtype=np.float64),
        "bs_el": np.asarray(b.el, dtype=np.float64), "sample_rate": float(obs.sample_rate),
        "timestep": float(atm.timestep), "mean_pwv": float(atm.weather.pwv),
        "base_temperature": float(atm.weather.temperature[0]), "spectrum_path": atm.spectrum.cache_path,
        "screens": [{k: getattr(s, k) for k in SCREEN_INPUTS} for s in atm.screens],
        "cmb": sim.cmb.data, "nside": int(sim.cmb.nside), "cmb_frame": sim.cmb.frame,
        "mapper": {**config.get("mapper", {}), **traffic.get("mapper", {})},
    }
    return {"sim": sim, "config": config, "traffic": traffic, "device": device, "inputs": inputs}


def _program_tracing(on: bool):
    """The program's tracing turned on for the block where ``on`` (and the
    program has it), else nothing."""
    from maria_torch.io import logging

    if not on or not hasattr(logging, "tracing"):
        return contextlib.nullcontext()
    return logging.tracing(True)


def realize(state: dict, seed: int, span) -> dict:
    import maria_torch

    sim, m = state["sim"], state["inputs"]["mapper"]
    with _program_tracing(getattr(span, "on", False)):
        sim.generator.manual_seed(seed)
        with span("synthesis"):
            tod = sim.run()[0]
        with span("map"):
            mapper = maria_torch.BinMapper(tod, frame=m["frame"], resolution=m["resolution"])
            out = mapper.run()
    state["n_pix"] = mapper.n_x * mapper.n_y
    return {"tod": tod, "data": out.data, "weight": out.weight, "stokes": mapper.stokes,
            "bands": [band.name for band in mapper.bands],
            "geometry": {"center": tuple(mapper.center), "res": mapper.res, "n_x": mapper.n_x, "n_y": mapper.n_y},
            "inputs": state["inputs"]}


def held_bytes(out: dict) -> int:
    return sum(t.numel() * t.element_size() for t in out["tod"].data.values() if t.is_cuda)


def samples(state: dict) -> int:
    return len(state["inputs"]["offsets"]) * len(state["inputs"]["t"])


def counters() -> dict:
    """The kernels' launch counters, and the program's counters and span
    host seconds since its start (those that tracing recorded)."""
    from maria_torch.io import logging
    from maria_torch.ops.bin_map import bin_map
    from maria_torch.ops.los_sample import los_sample
    from maria_torch.ops.pink_noise import pink_noise

    out = {"bin_map": bin_map.launches, "pink_noise": pink_noise.launches, "los_sample": los_sample.launches}
    if hasattr(logging, "trace_summary"):
        summary = logging.trace_summary()
        out.update({f"program.{k}": v for k, v in summary["counters"].items() if not k.endswith(".launches")})
        out.update({f"span.{k}": v["host_s"] for k, v in summary["spans"].items()})
    return out


def work(state: dict) -> dict:
    """K2 as BinMapper's binning, a launch a band: its least work, the
    band's TOD and ids read once, each detector's I, Q, U weights and
    their magnitudes read once, six maps (sums and weights) written once;
    ``calls`` left to K2's launch counter."""
    inputs = state["inputs"]
    rows = len(inputs["offsets"]) // len(np.unique(inputs["band_name"]))
    return {"k2": {"calls": None, "values": rows * len(inputs["t"]), "weights": 6 * rows,
                   "n_pix": state.get("n_pix", 0), "maps": 6}}


def reference_start(inputs: dict, device) -> dict:
    """The reference's scene, worked out once per run, after the window."""
    if "reference" not in inputs:
        start = ref.start(inputs["config"], inputs, device)
        ra, dec = (torch.as_tensor(a, dtype=F64, device=device) for a in (start["ra"], start["dec"]))
        res = math.radians(inputs["mapper"]["resolution"])
        start["geometry"] = ref_map.geometry(ra, dec, start["offsets"], res)
        inputs["reference"] = start
    return inputs["reference"]


def program_ids(out: dict, rows, device):
    """The program's map pixel ids of the detectors ``rows``."""
    from maria_torch.mappers.bin_mapper import radec_pixel_ids

    g = out["geometry"]
    return radec_pixel_ids(out["tod"].pointing[rows], g["center"], g["res"], g["n_x"], g["n_y"], device=device).to(
        device=device, dtype=torch.int64)


def reference_ids(start: dict, rows, device, q=lambda x: x):
    """The reference's float64 map pixel ids of the detectors ``rows``, in
    its own geometry, their (ra, dec) rounded by ``q``."""
    ra, dec = ref.det_radec(start, rows, device)
    return ref_map.pixel_ids(q(ra), q(dec), start["geometry"])


def readings(out: dict, seed: int, device, fields=None, ids_of=None, precision: str = "none") -> dict:
    """The check's numbers for one realization: the program's TOD
    ``out["tod"]`` (or ``fields``, {name: (n_det, n_t)}, in its place), its
    maps, and its pixel ids (``ids_of(rows)`` in place of the program's)."""
    start = reference_start(out["inputs"], device)
    fields = fields if fields is not None else out["tod"].data
    ids_of = ids_of or (lambda rows: program_ids(out, rows, device))
    gap = {k: 0.0 for k in FIELDS}
    gap_sq = noise_sq = cross = 0.0
    n = n_ids = n_diff = 0
    n_x = out["geometry"]["n_x"]
    n_pix = n_x * out["geometry"]["n_y"]
    names = [b["name"] for b in start["bands"]]
    order = ref_map.band_order(start["bands"])
    sums = torch.zeros((len(STOKES), len(names), n_pix), dtype=F64, device=device)
    wgts = torch.zeros_like(sums)
    sw = torch.as_tensor(start["sw"], dtype=F64, device=device)
    for b, rows, want in ref.fields(start, seed, device, precision):
        r = torch.as_tensor(rows, device=fields["noise"].device)
        got = {k: fields[k][r].to(device=device, dtype=F64) for k in FIELDS}
        for k in FIELDS:
            gap[k] = max(gap[k], float((got[k] - want[k]).abs().max()))
        total_gap = sum(got[k] - want[k] for k in FIELDS)
        gap_sq += float(total_gap.pow(2).sum())
        noise_sq += float(want["noise"].pow(2).sum())
        cross += float((got["noise"] * want["noise"]).sum())
        n += total_gap.numel()
        del total_gap, want
        ids = ids_of(rows)
        n_diff += int((ids != reference_ids(start, rows, device)).sum())
        n_ids += ids.numel()
        band = order.index(names.index(b["name"]))
        signal = sum(got[k] for k in FIELDS)
        s, w = ref_map.bin(signal, ids, sw[torch.as_tensor(rows, device=device)], n_pix)
        sums[:, band], wgts[:, band] = s, w
        del got, signal, ids
    noise_rms = (noise_sq / n) ** 0.5
    readings = {f"{k}_gap": gap[k] / noise_rms for k in FIELDS}
    readings.update(tod_rms_gap=(gap_sq / n) ** 0.5 / noise_rms, noise_scale_gap=abs(cross / noise_sq - 1.0),
                    ids_gap=n_diff / n_ids)
    want_map = ref_map.postprocess(sums, wgts)
    shape = (len(STOKES), len(names), n_pix)
    data, weight = (torch.as_tensor(out[k]) for k in ("data", "weight"))
    planes = (len(STOKES), len(names), 1, out["geometry"]["n_y"], n_x)
    if out["stokes"] != STOKES or out["bands"] != [names[i] for i in order] or tuple(data.shape) != planes:
        return {**readings, **{f"map_gap_{s}": math.inf for s in STOKES}, "hits_gap": math.inf}
    data = data.reshape(shape).to(device=device, dtype=F64)
    weight = weight.reshape(shape).to(device=device, dtype=F64)
    valid = wgts > 0
    e = torch.where(valid, data - torch.nan_to_num(want_map), 0.0)
    m = torch.where(valid, want_map, 0.0)
    for i, s in enumerate(STOKES):
        w = wgts[i]
        stray = bool((~valid[i] & (data[i] != 0)).any())  # a value where the reference has no weight
        ratio = float(((w * e[i] ** 2).sum(-1) / (w * m[i] ** 2).sum(-1)).max()) ** 0.5
        readings[f"map_gap_{s}"] = math.inf if stray else ratio
    readings["hits_gap"] = float((weight - wgts).abs().max() / wgts.abs().max())
    return readings


def judge(kept: list, config: dict, traffic: dict, device) -> dict:
    """The worst reading of each number over the checked realizations."""
    worst = {}
    for _, seed, out in kept:
        for k, v in readings(out, seed, device).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def control(out: dict, seed: int, device) -> dict:
    """The check's numbers with the control in the program's place: the
    reference's TOD computed in bfloat16, its pixel ids from the
    detectors' (ra, dec) rounded to bfloat16, and its maps and weights
    summed in bfloat16 from those."""
    start = reference_start(out["inputs"], device)
    bf16 = rounder("bf16")
    n_det, n_t = len(start["offsets"]), start["n_t"]
    fields = {k: torch.empty((n_det, n_t), dtype=torch.float32, device=device) for k in FIELDS}
    ids = torch.empty((n_det, n_t), dtype=torch.int64, device=device)
    n_pix = start["geometry"]["n_x"] ** 2
    order = ref_map.band_order(start["bands"])
    names = [b["name"] for b in start["bands"]]
    sums = torch.zeros((len(STOKES), len(names), n_pix), dtype=F64, device=device)
    wgts = torch.zeros_like(sums)
    sw = torch.as_tensor(start["sw"], dtype=F64, device=device)
    for b, rows, got in ref.fields(start, seed, device, precision="control"):
        r = torch.as_tensor(rows, device=device)
        for k in FIELDS:
            fields[k][r] = got[k].to(torch.float32)
        ids[r] = reference_ids(start, rows, device, bf16)
        band = order.index(names.index(b["name"]))
        sums[:, band], wgts[:, band] = ref_map.bin(sum(got[k] for k in FIELDS), ids[r], sw[r], n_pix, bf16)
    m = ref_map.postprocess(sums, wgts)
    n_x = start["geometry"]["n_x"]
    mine = {**out, "data": torch.nan_to_num(m).reshape(len(STOKES), len(names), 1, n_x, n_x),
            "weight": wgts.reshape(len(STOKES), len(names), 1, n_x, n_x), "stokes": STOKES,
            "geometry": {**out["geometry"], "n_x": n_x, "n_y": n_x}}
    return readings(mine, seed, device, fields=fields, ids_of=lambda rows: ids[torch.as_tensor(rows, device=device)])


def fault(out: dict, seed: int, device, kind: str) -> dict:
    """The check's numbers for a fault planted in the program's map:
    "qu_swapped", its Q and U planes exchanged; "band_left_out", the first
    band's planes and weights left empty, as if its sums were lost."""
    data, weight = torch.as_tensor(out["data"]).clone(), torch.as_tensor(out["weight"]).clone()
    if kind == "qu_swapped":
        data[[1, 2]] = data[[2, 1]]
        weight[[1, 2]] = weight[[2, 1]]
    elif kind == "band_left_out":
        data[:, 0] = 0.0
        weight[:, 0] = 0.0
    else:
        raise ValueError(kind)
    return readings({**out, "data": data, "weight": weight}, seed, device)


# what the calibration reads besides the control: the faults planted in the program's map
VARIANTS = {
    "qu_swapped": lambda state, out, seed, device: fault(out, seed, device, "qu_swapped"),
    "band_left_out": lambda state, out, seed, device: fault(out, seed, device, "band_left_out"),
}
