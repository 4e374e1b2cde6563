"""Carry a maria_tpu scene into the port as plain arrays.

``plan_from_arrays``, ``map_from_arrays`` and ``healpix_map_from_arrays``
take the arrays of a maria_tpu ``Plan`` (or an ``Observation``'s plan),
``ProjectionMap`` and ``HEALPixMap`` or ``CMB`` and return the port's, so
that both packages compute on the same inputs. ``program_from_tables`` takes the tables of a maria_tpu ``TODProgram``
as plain numpy arrays and scalars and returns the port's ``TODProgram``;
``pixel_ids_from_tables`` turns (iy, ix) map indices into the flat int32
ids kernel K2 takes; ``ar_process_from_arrays`` builds the port's
``AutoregressiveProcess`` from a maria_tpu process's operators and
lookback indices; ``ml_state_from_arrays`` puts a maria_tpu ML mapper's
blocks (ids, Stokes weights, data, and optionally its noise model) into
the port's mapper; ``array_from_columns`` makes the port's ``Array`` of a
maria_tpu detector table's columns (its uuid-named arrays included);
``stream_state_from_arrays`` turns a maria_tpu ``StreamingExecutor``'s
state (its ``init_state`` or a checkpoint's leaves) into the port's;
``tod_from_arrays`` makes the port's ``TOD`` of a maria_tpu TOD's fields,
weights, factorized pointing and detector columns. Nothing here imports maria_tpu: the caller extracts
the arrays (the tests do).

``tables`` keys: offsets (n_det, 2), bs_az_coarse, bs_el_coarse,
t_coarse, t_fine, mueller_I, gain_error (or None), mean_pwv,
sample_rate, with_noise, screens (list of dicts with h, z, res, pwv_rms,
angle, vx, vy, tx_min, ty_min, nx, ny, W and optionally ty_res, win_x,
win_y, band), bands (list of dicts with name, det_index, pwv_side,
el_side, power_table, NEP, knee, noise_basis, corr_prop), and optionally
groups (list of dicts with the ``ScreenGroup`` fields: heights, zs,
pwv_rms, angle, vx, vy, res, tx_min, ty_min, nx, ny, W, M_cos, M_sin,
beam) and noise_matmul (a dict of the matrix-product noise stage: specs,
a list of dicts with start, stop, c, k_modes, mode_c, key_index; and
corr_cols, n_fft, shared_c, row_scale), which the program then uses as
its own.
"""

from __future__ import annotations

import numpy as np
import torch

from .array import Array
from .atmosphere.atmosphere import LayerScreen, ScreenGroup
from .atmosphere.process import AutoregressiveProcess
from .cmb import CMB
from .map import HEALPixMap, ProjectionMap
from .noise.dft import NoiseBandSpec
from .ops.program import BandBlock, TODProgram
from .plan import Plan

__all__ = ["ar_process_from_arrays", "array_from_columns", "healpix_map_from_arrays", "map_from_arrays", "ml_state_from_arrays",
           "plan_from_arrays", "program_from_tables", "pixel_ids_from_tables", "stream_state_from_arrays",
           "tod_from_arrays"]


def plan_from_arrays(time, phi, theta, frame: str, site=None, roll: float = 0.0) -> Plan:
    """The port's Plan of a boresight track: unix ``time`` and
    (``phi``, ``theta``) in radians in ``frame``, at ``site`` (a name the
    port knows, or a ``Site``)."""
    return Plan(time=np.asarray(time, dtype=np.float64), phi=np.asarray(phi, dtype=np.float64),
                theta=np.asarray(theta, dtype=np.float64), roll=roll, frame=str(frame), site=site)


def map_from_arrays(data, center, width: float, height: float, frame: str = "ra/dec", stokes: str = None,
                    nu=None, t=None, units: str = "K_RJ", weight=None) -> ProjectionMap:
    """The port's ProjectionMap of a (stokes, nu, t, n_y, n_x) cube:
    ``center``, ``width`` and ``height`` in radians, as maria_tpu's map
    holds them (``center``, ``width.rad``, ``height.rad``)."""
    return ProjectionMap(data=np.asarray(data, dtype=np.float32), center=center, width=float(width),
                         height=float(height), frame=frame, stokes=stokes, nu=nu, t=t, units=units,
                         weight=None if weight is None else np.asarray(weight, dtype=np.float32), degrees=False)


def healpix_map_from_arrays(data, stokes: str, frame: str = "galactic", units: str = "K_CMB", nu=None,
                            cmb: bool = False) -> HEALPixMap:
    """The port's HEALPixMap (a CMB with ``cmb``) of a (stokes, nu, t,
    npix) RING-ordered cube, as maria_tpu's map holds it, on the host."""
    cls = CMB if cmb else HEALPixMap
    return cls(data=np.asarray(data, dtype=np.float32), stokes=stokes, frame=frame, units=units, nu=nu)


_SCREEN_FIELDS = ("h", "z", "res", "pwv_rms", "angle", "vx", "vy", "tx_min", "ty_min",
                  "nx", "ny", "W", "ty_res", "win_x", "win_y", "band")
_GROUP_FIELDS = ("heights", "zs", "pwv_rms", "angle", "vx", "vy", "res", "tx_min", "ty_min", "nx", "ny",
                 "W", "M_cos", "M_sin", "beam")
_SPEC_FIELDS = ("start", "stop", "c", "k_modes", "mode_c", "key_index")
_BAND_FIELDS = ("name", "det_index", "pwv_side", "el_side", "power_table", "NEP", "knee",
                "noise_basis", "corr_prop")


def program_from_tables(tables: dict) -> TODProgram:
    screens = []
    for s in tables["screens"]:
        kw = {k: s[k] for k in _SCREEN_FIELDS if k in s and s[k] is not None}
        kw["W"] = np.asarray(kw["W"], dtype=np.float32)
        for k in ("nx", "ny"):
            kw[k] = int(kw[k])
        screens.append(LayerScreen(**kw))
    bands = []
    for b in tables["bands"]:
        kw = {k: b.get(k) for k in _BAND_FIELDS}
        kw["det_index"] = np.asarray(kw["det_index"], dtype=np.int64)
        if kw["noise_basis"] is not None:
            kw["noise_basis"] = np.asarray(kw["noise_basis"], dtype=np.float64)
        kw["corr_prop"] = float(kw["corr_prop"] or 0.0)
        bands.append(BandBlock(**kw))
    groups = []
    for g in tables.get("groups", []):
        kw = {k: g.get(k) for k in _GROUP_FIELDS}
        for k in ("W", "M_cos", "M_sin", "beam"):
            kw[k] = None if kw[k] is None else np.asarray(kw[k], dtype=np.float32)
        for k in ("heights", "zs", "pwv_rms"):
            kw[k] = np.asarray(kw[k], dtype=np.float64)
        kw["nx"], kw["ny"] = int(kw["nx"]), int(kw["ny"])
        groups.append(ScreenGroup(**kw))
    gain_error = tables.get("gain_error")
    program = TODProgram(
        screens=screens,
        groups=groups,
        mean_pwv=float(tables["mean_pwv"]),
        t_coarse=np.asarray(tables["t_coarse"], dtype=np.float64),
        t_fine=np.asarray(tables["t_fine"], dtype=np.float64),
        offsets=np.asarray(tables["offsets"], dtype=np.float32),
        bs_az_coarse=np.asarray(tables["bs_az_coarse"], dtype=np.float32),
        bs_el_coarse=np.asarray(tables["bs_el_coarse"], dtype=np.float32),
        mueller_I=np.asarray(tables["mueller_I"]),
        bands=bands,
        sample_rate=float(tables["sample_rate"]),
        with_noise=bool(tables.get("with_noise", True)),
        gain_error=None if gain_error is None else np.asarray(gain_error, dtype=np.float32),
    )
    if tables.get("n_real_det") is not None:  # a program padded by pad_detectors: rows past it stay off maps
        program.n_real_det = int(tables["n_real_det"])
    nm = tables.get("noise_matmul")
    if nm is not None:
        specs = [NoiseBandSpec(**{k: sp.get(k) for k in _SPEC_FIELDS}) for sp in nm["specs"]]

        def arr(x):
            return None if x is None else np.asarray(x, dtype=np.float32)

        program._noise_specs_cache = (
            specs, arr(nm["corr_cols"]), int(nm["n_fft"]), arr(nm["shared_c"]), arr(nm["row_scale"]),
        )
    return program


def pixel_ids_from_tables(iy, ix, n_y: int, n_x: int, device=None):
    """Flat int32 pixel ids iy * n_x + ix, -1 where either index is
    negative; raises on an index beyond the map."""
    iy = np.asarray(iy, dtype=np.int64)
    ix = np.asarray(ix, dtype=np.int64)
    if (iy >= n_y).any() or (ix >= n_x).any():
        raise ValueError("pixel index beyond the map")
    flat = np.where((iy >= 0) & (ix >= 0), iy * n_x + ix, -1).astype(np.int32)
    return torch.as_tensor(flat, device=device)


def ar_process_from_arrays(A, B, extrusion_sample_index, cross_section_sample_index) -> AutoregressiveProcess:
    """The port's process with the operators A (n_cross, n_sample) and B
    (n_cross, n_cross) of a maria_tpu ``AutoregressiveProcess``, held in
    float64. Its sizes follow from the arrays: n_cross from B and
    n_extrusion from the lookback's last ring (index n_extrusion - 1); its
    grids are unit-spaced (they only enter the covariance setup, which
    the given operators replace). The lookback indices must be the ones
    the port derives for those sizes, or this raises ValueError."""
    A = np.asarray(A, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    ext_idx = np.asarray(extrusion_sample_index)
    cross_idx = np.asarray(cross_section_sample_index)
    n_cross, n_ext = B.shape[0], int(ext_idx.max()) + 1
    process = AutoregressiveProcess(np.stack([np.arange(n_cross, dtype=float), np.zeros(n_cross)], axis=-1),
                                    np.arange(n_ext, dtype=float))
    if not (np.array_equal(process.extrusion_sample_index, ext_idx)
            and np.array_equal(process.cross_section_sample_index, cross_idx)):
        raise ValueError(f"the lookback indices are not those of a {n_ext} x {n_cross} process")
    if A.shape != (n_cross, process.n_sample) or B.shape != (n_cross, n_cross):
        raise ValueError(f"A must be ({n_cross}, {process.n_sample}) and B ({n_cross}, {n_cross}), "
                         f"got {A.shape} and {B.shape}")
    process.A, process.B, process._computed = A, B, True
    return process


def ml_state_from_arrays(mapper, blocks: list):
    """Put a maria_tpu ``MaximumLikelihoodMapper``'s blocks into the
    port's ``mapper`` (of the same TODs and geometry), on the devices of
    the port's own blocks, and recompute its hit and starting maps. A
    block is a dict of numpy arrays: ``pix`` (n_det, n_t) channel-offset
    ids in [0, mapper.n_cpix), ``sw`` (n_det, n_s), ``data`` (n_det, n_t),
    the sample rate ``fs``, and optionally the noise model ``A_inv``
    (n_det, n_f), ``U`` (n_det, k) and ``core`` (n_f, k, k). A mapper
    sharded over a mesh (``mesh=``) takes its rank's rows of each whole
    block, zero-padded as its own blocks are. Returns the mapper."""
    if len(blocks) != len(mapper.blocks):
        raise ValueError(f"{len(blocks)} blocks for a mapper of {len(mapper.blocks)} TODs")
    carried = []
    for own, block in zip(mapper.blocks, blocks):
        device = own["data"].device
        pix = np.asarray(block["pix"])
        if pix.min() < 0 or pix.max() >= mapper.n_cpix:
            raise ValueError(f"pixel ids must lie in [0, {mapper.n_cpix})")

        def f32(x):
            return torch.as_tensor(np.array(x, dtype=np.float32), device=device)

        n_det = pix.shape[0]
        start, n_real = own.get("row0", 0), own.get("n_real", n_det)
        pad = own["data"].shape[0] - n_real

        def rows(x, fill=0):
            x = np.asarray(x)[start:start + n_real]
            return np.concatenate([x, np.full((pad, *x.shape[1:]), fill, dtype=x.dtype)]) if pad else x

        new = {"pix": torch.as_tensor(rows(pix.astype(np.int32), mapper.n_pix), device=device),
               "sw": f32(rows(block["sw"])), "data": f32(rows(block["data"])), "fs": float(block["fs"]), "U": None,
               "n_det": n_det, "row0": start, "n_real": n_real}
        if n_det != own.get("n_det", n_det):
            raise ValueError(f"a block of {n_det} rows for a TOD of {own['n_det']}")
        for key in ("A_inv", "U"):
            if block.get(key) is not None:
                new[key] = f32(rows(block[key]))
        if block.get("core") is not None:
            new["core"] = f32(block["core"])
        if (new["U"] is None) != (new.get("core") is None):
            raise ValueError("U and core come together")
        carried.append(new)
    mapper.blocks = carried
    mapper._compute_naive_map()
    mapper.map = mapper._grid_to_map(mapper.naive_map, mapper.hits)
    return mapper


ARRAY_COLUMNS = ("xi", "eta", "gamma", "band_name", "pol_label", "base_det_index", "array_name", "primary_size",
                 "bath_temp", "time_constant")


def array_from_columns(columns: dict, bands, name: str = None) -> Array:
    """The port's Array of a maria_tpu ``Array``'s detector columns, as
    numpy arrays (``xi eta gamma band_name pol_label base_det_index
    array_name primary_size bath_temp time_constant``, and optionally the
    baselines, zero without them), with ``bands`` (the port's Bands, or
    registry names or dicts) and ``name`` (the "+"-joined array names
    without it). The rows keep their order and their arrays' names."""
    from .band import parse_band

    missing = [k for k in ARRAY_COLUMNS if k not in columns]
    if missing:
        raise ValueError(f"missing detector columns {missing}")
    n = len(np.asarray(columns["xi"]))
    dets = {}
    for key in ARRAY_COLUMNS + ("baseline_x", "baseline_y", "baseline_z"):
        value = columns.get(key, np.zeros(n))
        dets[key] = np.asarray(value, dtype=object if key in ("band_name", "pol_label", "array_name") else None)
    dets["base_det_index"] = dets["base_det_index"].astype(np.int64)
    for key in ("xi", "eta", "gamma", "primary_size", "bath_temp", "time_constant", "baseline_x", "baseline_y",
                "baseline_z"):
        dets[key] = dets[key].astype(np.float64)
    names = list(dict.fromkeys(dets["array_name"]))
    array = Array(name or "+".join(names), dets, [parse_band(b) for b in bands])
    array.dets["array_name"] = dets["array_name"]
    return array


STREAM_STATE_KEYS = ("lc_pad", "lc_last", "gains", "map_sum", "map_wgt", "psd_blocks", "bin_lost", "pwv_pad2",
                     "pwv_last", "el_pad2", "el_last")


def stream_state_from_arrays(executor, arrays, key: int = 0, base: dict = None) -> dict:
    """The port's ``StreamingExecutor`` state from maria_tpu's, as numpy:
    either the leaves of maria_tpu's ``init_state(key)`` as a dict (its
    keys of STREAM_STATE_KEYS, "noise" as a list a band of tuples of
    cascade states, "psd_sum" a list a band; its PRNG keys and sky fields
    are not taken: the port's executor keeps its sky itself), or the
    mutable leaves of a maria_tpu checkpoint (a list, ``leaf_i`` in order)
    laid over ``base``, the port's ``init_state``. ``key`` is the seed the
    port's generators use for any draw the caller does not hand in."""
    dev = executor.device

    def t(x):
        return torch.as_tensor(np.array(x, dtype=np.float32), device=dev)

    if not isinstance(arrays, dict):
        if base is None:
            raise ValueError("checkpoint leaves need the base state they are laid over (base=)")
        return executor.set_mutable_leaves(base, list(arrays))
    state = {k: t(arrays[k]) for k in STREAM_STATE_KEYS if k in arrays}
    state["key"] = int(key)
    state["noise"] = [tuple(t(x) for x in band) for band in arrays["noise"]]
    state["psd_sum"] = [t(x) for x in arrays["psd_sum"]]
    return state


def tod_from_arrays(data: dict, weight, phi, theta, t, offsets, q, columns: dict, bands, frame: str = "az/el",
                    earth_location=None, units: str = "K_RJ", metadata: dict = None, device="cpu"):
    """The port's TOD of a maria_tpu TOD's numpy arrays: the fields
    ``data`` (name -> (n_det, n_t)) and ``weight`` on ``device``; the
    boresight (``phi``, ``theta`` in ``frame``, unix ``t``) at
    ``earth_location`` (an ``EarthLocation``, or (lat_deg, lon_deg,
    height_m)); the detector ``offsets`` (n_det, 2) and the frame-rotation
    angle ``q`` (n_t,); the detector ``columns`` and ``bands``, through
    ``array_from_columns``."""
    from .coords import Coordinates, EarthLocation
    from .device import resolve_device
    from .tod import TOD, Pointing

    device = resolve_device(device)
    if earth_location is not None and not isinstance(earth_location, EarthLocation):
        earth_location = EarthLocation(*(float(x) for x in earth_location))
    location = {} if earth_location is None else {"earth_location": earth_location}
    boresight = Coordinates(np.asarray(phi, dtype=np.float64), np.asarray(theta, dtype=np.float64),
                            np.asarray(t, dtype=np.float64), frame=frame, **location)
    pointing = Pointing(boresight, np.asarray(offsets, dtype=np.float64),
                        None if q is None else np.asarray(q, dtype=np.float64))
    f32 = dict(dtype=torch.float32, device=device)
    return TOD(data={k: torch.as_tensor(np.array(v), **f32) for k, v in data.items()},
               pointing=pointing, weight=None if weight is None else torch.as_tensor(np.array(weight), **f32),
               units=units, dets=array_from_columns(columns, bands), metadata=dict(metadata or {}))
