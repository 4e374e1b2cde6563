"""Bounded-memory TOD synthesis: an observation of any length at
O(block) fine-rate memory (maria_tpu/ops/streaming_exec.py).

The memory wall is the fine-rate (n_det, n_t) fields: one field of
AtLAST-50k x 600 s at 50 Hz is 6.0 GB in float32, and the batch program
holds several. The coarse-rate stages are ~upsample_ratio x smaller and
cheap to keep whole. So the executor splits the program at the
coarse/fine boundary:

- ONE whole-observation coarse stage (``TODProgram.fields(upto=
  "coarse")``): pointing, screens, AR extrusion, line-of-sight sampling,
  bandpass integration -> loading_c (n_det, n_tc), from the same draws
  as the batch program.
- Fine-rate synthesis in fixed blocks of ``block_tc`` coarse cells: the
  phase-stencil cubic upsample on the block's slice of the padded coarse
  series (bit-equal to the whole-series upsample), the sky stages
  (``cmb=``, ``input_map=``) sampled along the block's pointing with the
  batch program's calibration tables, the gains, the streaming noise
  (``noise/streaming.py``: every band's pink cascade in one launch of
  kernel KC on the card), and the block binned into the carried
  (map_sum, map_wgt) by one launch of kernel K2 (the sums and K2's
  in-kernel hit count; off-map and beyond-n_t samples at id -1). Nothing
  of size (n_det, n_t) ever exists.

A block's draws depend only on (seed, band, block index): each (band,
block) seeds its own ``torch.Generator`` from the run's seed, so a run
does not depend on how blocks are grouped, and a run resumed from a
checkpoint equals the uninterrupted one. The noise is the streaming
cascade, not the batch FFT: the two match in PSD, not sample by sample.

What maria_tpu adds for the TPU is not ported: the windowed MXU binning
and its run plans, the fixed-shape phantom tail groups and the jit cache
(``mxu_binning=`` and ``use_runs=`` are taken and change nothing; the
binning is K2).

``run(mesh=)`` lays the carried state out over the mesh's "det" axis
(``maria_torch.parallel``), as maria_tpu's ``_shard_state`` does: a rank
holds its block of the detector-major leaves (the coarse loading, the
gains, its rows of every band's cascade state) and runs every block on
its rows alone (the upsample, the sky, the noise with KC on its rows, the
pixel ids and K2). Every draw is made at its global shape and the rank
keeps its rows, so the rank's TOD rows are the single-process run's. The
mode cascades are replicated. Each rank accumulates its part of the map
and the Welch sums; they are reduced (``all_reduce`` over "det") at the
end and before each checkpoint. A checkpoint holds the unsharded layout
(the cascades' states gathered to the global rows), is written by rank 0
alone, and resumes a run of any number of ranks.
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..coords import offsets_to_phi_theta, phi_theta_to_offsets
from ..device import resolve_device
from ..noise.streaming import StreamingBandNoise
from .bin_map import bin_map
from .interp import TableEval, _phase_stencil_matrix
from .pink_cascade import pink_cascade
from .pixel_ids import pixel_ids, sky_offsets

__all__ = [
    "StreamingExecutor",
    "StreamingResult",
    "pad_coarse_for_blocks",
    "pad_coarse_for_blocks_ext",
    "upsample_block_ext",
    "upsample_block_phases",
]

HBM_BUDGET = 2e9  # bytes of fine-rate working set block_tc="auto" sizes a block for
LIVE_BUFFERS = 8  # (n_det, B) float32 buffers that working set counts
WIDE_ARRAY = 4096  # detectors above which "auto" caps a block at 128 coarse cells
WIDE_BLOCK_TC = 128
PIXEL_ROWS = 8192  # detector rows of one pass of the pixel ids (bounds its temporaries)


def pad_coarse_for_blocks(values, block_tc: int, n_blocks: int):
    """Clamp-pad a coarse (..., n_c) series for ``upsample_block_phases``:
    one left clamp and enough right clamps that the last block's slice
    stays inside the array."""
    n_c = values.shape[-1]
    n_right = n_blocks * block_tc + 2 - n_c
    right = values[..., -1:].expand(*values.shape[:-1], n_right)
    return torch.cat([values[..., :1], values, right], dim=-1)


def pad_coarse_for_blocks_ext(values, block_tc: int, n_blocks: int):
    """As ``pad_coarse_for_blocks`` with TWO left clamps and one more right
    clamp, for ``upsample_block_ext``'s one-cell halo."""
    n_c = values.shape[-1]
    n_right = n_blocks * block_tc + 3 - n_c
    right = values[..., -1:].expand(*values.shape[:-1], n_right)
    return torch.cat([values[..., :1], values[..., :1], values, right], dim=-1)


def _stencil_cells(sl, n_cells: int, ratio: int, n_c: int, kind: str):
    """The phase stencil over ``n_cells`` coarse cells of the slice, in
    ``upsample_time_phases``'s order of operations (so the blockwise
    values are bit-equal to the whole series')."""
    if kind == "linear" or n_c < 4:
        taps = [sl[..., 1:n_cells + 1], sl[..., 2:n_cells + 2]]
        C = _phase_stencil_matrix(ratio, "linear")
    else:
        taps = [sl[..., k:n_cells + k] for k in range(4)]
        C = _phase_stencil_matrix(ratio, "cubic")
    Ct = torch.as_tensor(C, dtype=sl.dtype, device=sl.device)
    out = sum(taps[k][..., None] * Ct[k] for k in range(len(taps)))
    return out.reshape(*sl.shape[:-1], n_cells * ratio)


def upsample_block_phases(values_pad, c0: int, block_tc: int, ratio: int, n_c: int, v_last, kind: str = "cubic"):
    """Blockwise ``upsample_time_phases``, bit-equal on the block: the
    fine samples of coarse cells [c0, c0 + block_tc) from ``values_pad``
    (``pad_coarse_for_blocks``); fine samples past cell n_c - 2 repeat
    the last coarse value ``v_last`` (...,)."""
    sl = values_pad[..., c0:c0 + block_tc + 3]
    out = _stencil_cells(sl, block_tc, ratio, n_c, kind)
    g = c0 * ratio + torch.arange(block_tc * ratio, device=out.device)
    return torch.where(g >= (n_c - 1) * ratio, v_last[..., None], out)


def upsample_block_ext(values_pad2, c0: int, block_tc: int, ratio: int, n_c: int, v_last, kind: str = "cubic"):
    """The upsample over cells [c0 - 1, c0 + block_tc + 1): one coarse
    cell of halo on each side, for the integration kernel's context
    across blocks. ``values_pad2`` comes from ``pad_coarse_for_blocks_ext``;
    interior values equal ``upsample_block_phases``', halo cells beyond the
    series are for the caller to clamp."""
    n_cells = block_tc + 2
    sl = values_pad2[..., c0:c0 + n_cells + 3]
    out = _stencil_cells(sl, n_cells, ratio, n_c, kind)
    g = (c0 - 1) * ratio + torch.arange(n_cells * ratio, device=out.device)
    return torch.where(g >= (n_c - 1) * ratio, v_last[..., None], out)


@dataclass
class StreamingResult:
    """Accumulated products of a streaming run (pW), on the host."""

    map_sum: np.ndarray  # (n_y, n_x) sum of TOD power a pixel
    map_wgt: np.ndarray  # (n_y, n_x) hit counts
    n_samples: int
    n_x: int
    n_y: int
    center: tuple
    res: float
    # per-band Welch spectra: the mean detrended, Hann-windowed
    # periodogram over full blocks and the band's detectors, one-sided, pW^2/Hz
    psd_freqs: np.ndarray = None  # (B // 2 + 1,)
    psds: list = None  # [(n_freq,) a band]

    @property
    def map(self):
        with np.errstate(invalid="ignore"):
            return np.where(self.map_wgt > 0, self.map_sum / self.map_wgt, np.nan)


def _seed(key: int, *path: int) -> int:
    """A generator seed that depends only on (key, path)."""
    return int(np.random.SeedSequence([int(key) & 0xFFFFFFFF, *path]).generate_state(1, np.uint32)[0])


def _as_f32(x, device):
    """A handed-in draw as a float32 tensor on ``device`` (numpy is copied)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def _generator(device, key: int, *path: int):
    g = torch.Generator(device=device)
    g.manual_seed(_seed(key, *path))
    return g


def _normals(generator, shape, sel, given, device, out=None):
    """Rows ``sel`` of a ``shape`` draw of unit normals: of ``given`` (the
    whole draw) when handed in, else drawn whole from ``generator``;
    written into ``out`` when given (drawn in place when ``sel`` keeps
    every row, as in one process)."""
    if given is None and out is not None and out.shape[0] == shape[0]:
        return torch.randn(shape, generator=generator, dtype=torch.float32, device=device, out=out)
    x = (torch.randn(shape, generator=generator, dtype=torch.float32, device=device) if given is None
         else _as_f32(given, device))[sel]
    return x if out is None else out.copy_(x)


class StreamingExecutor:
    """Time-blocked executor over a TODProgram (see the module docstring).

    The program must be built without cmb/input_map; pass ``cmb=`` and
    ``input_map=`` (with ``obs=``) here, and the sky is sampled a block at
    a time. ``frame`` is the binning frame ("az/el" or "ra/dec"), and
    ``device`` where the blocks run (the card unless told otherwise)."""

    def __init__(self, program, obs=None, block_tc="auto", n_x: int = 128, n_y: int = 128, res: float = None,
                 center: tuple = None, T_ref: float = None, cmb=None, input_map=None, map_kwargs: dict = None,
                 frame: str = "az/el", device=None):
        if program.upsample_ratio is None:
            raise ValueError("StreamingExecutor needs an integer coarse/fine upsample ratio "
                             "(aligned uniform grids); this program has none.")
        if any(b.cmb_samples is not None or b.map_stages for b in program.bands):
            raise NotImplementedError(
                "This program carries whole-observation static sky timelines; build it without cmb/input_map "
                "and pass cmb=/input_map= to the executor instead: it samples the sky a block at a time.")
        if (cmb is not None or input_map is not None) and obs is None:
            raise ValueError("streaming sky stages need the Observation (obs=)")
        if frame not in ("az/el", "ra/dec"):
            raise ValueError(f"frame must be 'az/el' or 'ra/dec', not '{frame}'")
        if frame == "ra/dec" and obs is None:
            raise ValueError("binning in ra/dec needs the Observation (obs=)")
        self.device = resolve_device(device)
        self.frame = frame
        self.program = program
        self.r = int(program.upsample_ratio)
        if block_tc == "auto":
            # the largest block whose fine-rate working set (LIVE_BUFFERS
            # (n_det, B) float32 buffers) fits HBM_BUDGET; wide arrays cap
            # at WIDE_BLOCK_TC cells, maria_tpu's rule, so B is maria_tpu's
            per_cell = LIVE_BUFFERS * len(program.offsets) * self.r * 4
            n_tc = -(-len(program.t_fine) // self.r)
            block_tc = int(np.clip(HBM_BUDGET // max(per_cell, 1), 16, max(n_tc, 16)))
            if len(program.offsets) > WIDE_ARRAY:
                block_tc = min(block_tc, WIDE_BLOCK_TC)
        self.block_tc = int(block_tc)
        self.B = self.block_tc * self.r
        self.n_t = len(program.t_fine)
        self.n_c = len(program.t_coarse)
        self.n_det = len(program.offsets)
        self.n_det_global = self.n_det
        self.n_real_det = program.n_real_det  # rows past it are padding, kept out of the map
        # a rank's detector rows (start, stop) and, per band, the positions
        # of those rows in the band; the whole array in one process
        self.mesh = None
        self.rows = None
        self._band_sel = [slice(0, len(b.det_index)) for b in program.bands]
        self.n_blocks = -(-self.n_t // self.B)
        duration = float(program.t_fine[-1] - program.t_fine[0]) + 1.0
        T_ref = T_ref or max(4096.0, 2.0 * duration)

        # fine boresight track (O(n_t) scalars)
        if obs is not None:
            bs_az_f = np.asarray(obs.boresight.az, dtype=np.float32)
            bs_el_f = np.asarray(obs.boresight.el, dtype=np.float32)
        else:  # the program's coarse track, upsampled
            from .interp import upsample_time

            f32 = dict(dtype=torch.float32)
            bs_az_f = upsample_time(torch.as_tensor(program.bs_az_coarse, **f32), program.t_coarse,
                                    program.t_fine).numpy()
            bs_el_f = upsample_time(torch.as_tensor(program.bs_el_coarse, **f32), program.t_coarse,
                                    program.t_fine).numpy()
        self.pad_f = self.n_blocks * self.B - self.n_t
        self.bs_az_f = np.pad(bs_az_f, (0, self.pad_f), mode="edge")
        self.bs_el_f = np.pad(bs_el_f, (0, self.pad_f), mode="edge")
        self.bs_ra_f = self.bs_dec_f = self.q_f = None
        self._cq_f = self._sq_f = None
        if obs is not None and frame == "ra/dec":
            self._load_radec_tracks(obs)

        # map geometry (by default sized from the detector hull)
        self.n_x, self.n_y = int(n_x), int(n_y)
        phi_f, theta_f = (self.bs_ra_f, self.bs_dec_f) if frame == "ra/dec" else (self.bs_az_f, self.bs_el_f)
        c0 = center[0] if center else float(np.mean(phi_f))
        c1 = center[1] if center else float(np.mean(theta_f))
        self.center = (c0, c1)
        self.res = float(res) if res is not None else self._hull_res(phi_f, theta_f)

        self.noise_models = [
            StreamingBandNoise(program.sample_rate, b.knee, basis=b.noise_basis, corr_prop=b.corr_prop, T_ref=T_ref)
            for b in program.bands
        ]
        self._setup_cascade_rows()
        self.sky = None
        self._map_fi_f = self._map_whi_f = None
        self._tracks = None
        if cmb is not None or input_map is not None:
            self._build_sky(obs, cmb, input_map, map_kwargs or {})

    # -- setup ---------------------------------------------------------------------
    def _hull_res(self, phi_f, theta_f) -> float:
        """Pixel size bounding every detector x time sample: all detectors
        at a boresight subsample of ~1024 points, with 5% margin; float32
        on the executor's device a slab of detectors at a time."""
        step = max(1, len(phi_f) // 1024)
        f32 = dict(dtype=torch.float32, device=self.device)
        phi = torch.as_tensor(phi_f[::step], **f32)
        theta = torch.as_tensor(theta_f[::step], **f32)
        o_all = np.asarray(self.program.offsets, dtype=np.float32)
        if self.frame == "ra/dec":
            q = self.q_f[::step]
            cq, sq = torch.as_tensor(np.cos(q), **f32), torch.as_tensor(np.sin(q), **f32)
        half = 0.0
        for r0 in range(0, len(o_all), PIXEL_ROWS):
            o = torch.as_tensor(o_all[r0:r0 + PIXEL_ROWS], **f32)
            det_offs = sky_offsets(o, cq, sq) if self.frame == "ra/dec" else o[:, None, :]
            offs = phi_theta_to_offsets(offsets_to_phi_theta(det_offs, phi, theta), *self.center)
            half = max(half, float(offs.abs().max()))
        return 2 * (half * 1.05 + 1e-6) / self.n_x

    def _load_radec_tracks(self, obs):
        if self.bs_ra_f is not None:
            return
        pad = (0, self.pad_f)
        self.bs_ra_f = np.pad(np.asarray(obs.boresight.ra, dtype=np.float32), pad, mode="edge")
        self.bs_dec_f = np.pad(np.asarray(obs.boresight.dec, dtype=np.float32), pad, mode="edge")
        q = np.asarray(obs.q, dtype=np.float64)
        self.q_f = np.pad(q.astype(np.float32), pad, mode="edge")
        # the rotation's cos and sin from the host's float64 q, as
        # Pointing.offsets_radec takes them (the batch path's pointing)
        self._cq_f = np.pad(np.cos(q).astype(np.float32), pad, mode="edge")
        self._sq_f = np.pad(np.sin(q).astype(np.float32), pad, mode="edge")

    def _setup_cascade_rows(self):
        """The layout of KC's one launch a block: the detector rows of every
        band with a cascade, then the mode rows of every band with modes;
        one (p, a) table a band (all bands share K: it depends only on the
        sample rate and T_ref)."""
        casc = [i for i, m in enumerate(self.noise_models) if m.cascade is not None]
        self._casc_bands = casc
        self._casc_rows = None
        if not casc:
            return
        Ks = {self.noise_models[i].cascade.K for i in casc}
        if len(Ks) != 1:
            raise ValueError(f"the bands' cascades have different pole counts {sorted(Ks)}")
        spans, r0 = {}, 0
        for i in casc:
            n = self._band_sel[i].stop - self._band_sel[i].start
            spans[(i, 0)] = (r0, r0 + n)
            r0 += n
        for i in casc:
            k = self.noise_models[i].n_modes
            if k:
                spans[(i, 1)] = (r0, r0 + k)
                r0 += k
        table = np.zeros(r0, np.int32)
        for (i, _), (a, b) in spans.items():
            table[a:b] = casc.index(i)
        self._casc_rows = {"spans": spans, "n": r0, "table_np": table, "K": Ks.pop()}
        self._casc_t = {}

    def _casc_tensors(self, device):
        key = str(device)
        if key not in self._casc_t:
            cs = [self.noise_models[i].cascade for i in self._casc_bands]
            f32 = dict(dtype=torch.float32, device=device)
            self._casc_t[key] = {
                "p": torch.as_tensor(np.stack([c.p for c in cs]), **f32),
                "a": torch.as_tensor(np.stack([c.a for c in cs]), **f32),
                "table": torch.as_tensor(self._casc_rows["table_np"], dtype=torch.int32, device=device),
            }
        return self._casc_t[key]

    def shard(self, mesh) -> "StreamingExecutor":
        """This executor restricted to ``mesh``'s rank: its block of the
        detector rows along "det" (module docstring)."""
        if mesh.device != self.device:
            raise ValueError(f"the mesh's rank lies on {mesh.device}, the executor on {self.device}")
        ex = copy.copy(self)
        ex.mesh = mesh
        ex.rows = mesh.block(self.n_det_global, "det")
        ex.n_det = ex.rows[1] - ex.rows[0]
        ex._band_sel = self.program.band_row_slices(ex.rows)
        ex._setup_cascade_rows()
        return ex

    def _reduce(self, x):
        """A copy of ``x`` summed over the "det" ranks (``x`` in one process)."""
        return x if self.mesh is None else self.mesh.all_reduce(x.clone(), "det")

    def _build_sky(self, obs, cmb, input_map, map_kwargs: dict):
        """Setup of the per-block sky stages: the same calibration tables
        and beam-smoothed channel maps the batch program uses
        (``build_tod_program``), without its (n_det, n_t) timelines."""
        from ..sim.cmb import cmb_power_tables
        from ..sim.map import band_fwhm, check_map_observable, map_transmission_table

        atm = obs.atmosphere
        T_base = float(atm.weather.temperature[0])
        spectrum = atm.spectrum
        dev = self.device
        stokes_weight = np.asarray(obs.instrument.dets.stokes_weight(), dtype=np.float32)
        sky = {"cmb": None, "map": None, "bands": []}
        if cmb is not None:
            if cmb.frame not in ("galactic", "ra/dec"):
                raise ValueError(f"Cannot stream a CMB in frame '{cmb.frame}'.")
            sky["cmb"] = {"map": cmb, "fields": cmb.data[:, 0, 0].to(dev)}
        if input_map is not None:
            check_map_observable(input_map)
            n_frames = len(input_map.t)
            sky["map"] = {"center": (float(input_map.center[0]), float(input_map.center[1])),
                          "radec": input_map.frame in ("ra/dec", "icrs"),
                          "bilinear": map_kwargs.get("bilinear_sampling", True), "n_frames": n_frames}
            if n_frames > 1:
                # a time-evolving map: each sample's frame and blend weight,
                # as the batch path computes them (sim/map.py::_channel_samples)
                f32 = dict(dtype=torch.float32, device=dev)
                t0 = float(obs.t[0])
                t_rel = torch.as_tensor(np.asarray(obs.t, dtype=np.float64) - t0, **f32)
                frame_t = torch.as_tensor(np.asarray(input_map.t, dtype=np.float64) - t0, **f32)
                fi = torch.clamp(torch.searchsorted(frame_t, t_rel) - 1, 0, n_frames - 2)
                w_hi = torch.clamp((t_rel - frame_t[fi]) / (frame_t[fi + 1] - frame_t[fi]), 0.0, 1.0)
                self._map_fi_f = torch.cat([fi, fi[-1:].expand(self.pad_f)])
                self._map_whi_f = torch.cat([w_hi, w_hi[-1:].expand(self.pad_f)])
        for band, block in zip(obs.instrument.dets.bands, self.program.bands):
            entry = {"sw": torch.as_tensor(stokes_weight[block.det_index], device=dev)}
            if cmb is not None:
                pwv_side, el_side, P0, dPdT = cmb_power_tables(band, spectrum, T_base)
                entry["cmb_P0"] = TableEval(pwv_side, el_side, P0, device=dev)
                entry["cmb_dPdT"] = TableEval(pwv_side, el_side, dPdT, device=dev)
            if input_map is not None:
                channel_map = input_map.smooth(fwhm=band_fwhm(obs, band), device=dev).to("K_RJ", band=band)
                stages = []
                for channel, (nu_min, nu_max) in enumerate(input_map.nu_bin_bounds):
                    if band.nu.max() < nu_min or nu_max < band.nu.min():
                        continue
                    tab = map_transmission_table(band, input_map, channel, spectrum, T_base)
                    stages.append({"cal": TableEval(spectrum.side_zenith_pwv, spectrum.side_elevation, tab,
                                                    device=dev), "channel": channel, "map": channel_map})
                entry["map_stages"] = stages
            sky["bands"].append(entry)
        if cmb is not None or sky["map"]["radec"]:
            self._load_radec_tracks(obs)
        self.sky = sky

    def _device_tracks(self) -> dict:
        """The pointing tracks on the device, once: the fine az/el (and
        ra/dec, cos q, sin q) padded to whole blocks, and edge-padded by r
        on both sides for the sky stages' haloed blocks."""
        if self._tracks is None:
            f32 = dict(dtype=torch.float32, device=self.device)
            t = {"az": torch.as_tensor(self.bs_az_f, **f32), "el": torch.as_tensor(self.bs_el_f, **f32)}
            for name, arr in (("ra", self.bs_ra_f), ("dec", self.bs_dec_f), ("cq", self._cq_f), ("sq", self._sq_f)):
                if arr is not None:
                    t[name] = torch.as_tensor(arr, **f32)
            if self.sky is not None:
                r = self.r
                ext = {k: torch.cat([v[:1].expand(r), v, v[-1:].expand(r)]) for k, v in t.items()}
                if self._map_fi_f is not None:
                    ext["fi"] = torch.cat([self._map_fi_f[:1].expand(r), self._map_fi_f,
                                           self._map_fi_f[-1:].expand(r)])
                    ext["whi"] = torch.cat([self._map_whi_f[:1].expand(r), self._map_whi_f,
                                            self._map_whi_f[-1:].expand(r)])
                t["ext"] = ext
            self._tracks = t
        return self._tracks

    # -- state ---------------------------------------------------------------------
    def init_state(self, key: int = 0, draws: dict = None) -> dict:
        """(coarse fields, per-band noise states, gains, accumulators) of
        one realization with seed ``key``. ``draws`` optionally supplies
        maria_tpu's normals: "coarse" (as ``TODProgram.fields`` takes
        them), "gains" ((n_det,)), and "noise_init" (a band: () without a
        cascade, else a tuple of the (n_band_det, K) and, with modes,
        (k, K) normals of its start)."""
        draws = draws or {}
        p, dev = self.program, self.device
        coarse = p.fields(generator=_generator(dev, key, 0), draws=draws.get("coarse"), device=dev, upto="coarse",
                          rows=self.rows)
        gains = p.draw_gains(generator=_generator(dev, key, 1), draw=draws.get("gains"), device=dev, rows=self.rows)
        if gains is None:
            gains = torch.ones((self.n_det, 1), dtype=torch.float32, device=dev)
        noise = []
        for i, (band, model) in enumerate(zip(p.bands, self.noise_models)):
            z = draws["noise_init"][i] if "noise_init" in draws else None
            band_state = model.init_state(len(band.det_index), _generator(dev, key, 2, i), z=z, device=dev)
            # the whole band's start drawn, this executor's rows kept
            noise.append(tuple(x[self._band_sel[i]] if j == 0 else x for j, x in enumerate(band_state)))
        lc = coarse["loading_c"]
        state = {
            "key": int(key),
            "lc_pad": pad_coarse_for_blocks(lc, self.block_tc, self.n_blocks),
            "lc_last": lc[:, -1].clone(),
            "gains": gains,
            "noise": noise,
            "map_sum": torch.zeros(self.n_y * self.n_x, dtype=torch.float32, device=dev),
            "map_wgt": torch.zeros(self.n_y * self.n_x, dtype=torch.float32, device=dev),
            "psd_sum": [torch.zeros(self.B // 2 + 1, dtype=torch.float32, device=dev) for _ in p.bands],
            "psd_blocks": torch.zeros((), dtype=torch.float32, device=dev),
            "bin_lost": torch.zeros((), dtype=torch.float32, device=dev),
        }
        if self.sky is not None:
            state.update({
                "pwv_pad2": pad_coarse_for_blocks_ext(coarse["pwv_c"], self.block_tc, self.n_blocks),
                "pwv_last": coarse["pwv_c"][:, -1].clone(),
                "el_pad2": pad_coarse_for_blocks_ext(coarse["el_c"], self.block_tc, self.n_blocks),
                "el_last": coarse["el_c"][:, -1].clone(),
            })
        return state

    # -- one block -----------------------------------------------------------------
    def pixel_ids(self, b: int):
        """(n_det, B) int32 flat ids iy * n_x + ix of block b in the
        binning frame (``ops.pixel_ids.pixel_ids`` on the block's tracks,
        a slab of PIXEL_ROWS detectors at a time), -1 off the map, past
        n_t and on padded detectors (both set in place, where there are any)."""
        tr, dev = self._device_tracks(), self.device
        sl = slice(b * self.B, (b + 1) * self.B)
        phi, theta, *cq_sq = ((tr["ra"][sl], tr["dec"][sl], tr["cq"][sl], tr["sq"][sl]) if self.frame == "ra/dec"
                              else (tr["az"][sl], tr["el"][sl]))
        offsets = self.program._tensors(dev, self.rows)["offsets"]
        ids = torch.empty((self.n_det, self.B), dtype=torch.int32, device=dev)
        for r0 in range(0, self.n_det, PIXEL_ROWS):
            ids[r0:r0 + PIXEL_ROWS] = pixel_ids(offsets[r0:r0 + PIXEL_ROWS], phi, theta, self.center, self.res,
                                                self.n_x, self.n_y, *cq_sq)
        ids[:, self.n_t - b * self.B:] = -1  # the last block's samples past n_t
        ids[max(self.n_real_det - (0 if self.rows is None else self.rows[0]), 0):] = -1  # padded detectors
        return ids

    def atmosphere_block(self, state, b: int):
        """The ungained atmospheric loading of block b (n_det, B) pW."""
        return upsample_block_phases(state["lc_pad"], b * self.block_tc, self.block_tc, self.r, self.n_c,
                                     state["lc_last"], kind="cubic")

    def sky_block(self, state, b: int):
        """The ungained CMB and map loading of block b (n_det, B) pW: the
        batch program's cmb and map stages on the block."""
        p, sky, r, B = self.program, self.sky, self.r, self.B
        tabs = p._tensors(self.device, self.rows)
        offsets, mueller_I, band_rows = tabs["offsets"], tabs["mueller_I"], tabs["det_index"]
        c0 = b * self.block_tc
        pwv_ext = upsample_block_ext(state["pwv_pad2"], c0, self.block_tc, r, self.n_c, state["pwv_last"],
                                     kind="linear")
        el_ext = upsample_block_ext(state["el_pad2"], c0, self.block_tc, r, self.n_c, state["el_last"], kind="cubic")
        ext = {k: v[b * B:(b + 1) * B + 2 * r] for k, v in self._device_tracks()["ext"].items()}
        interior = slice(r, r + B)
        total = torch.zeros((self.n_det, B), dtype=torch.float32, device=self.device)

        if sky["cmb"] is not None:
            cmb = sky["cmb"]["map"]
            fields = sky["cmb"]["fields"]
            cq, sq = ext["cq"][interior], ext["sq"][interior]
            for i, entry in enumerate(sky["bands"]):
                rows = band_rows[i]
                pt = offsets_to_phi_theta(sky_offsets(offsets[rows], cq, sq), ext["ra"][interior], ext["dec"][interior])
                pix = cmb.radec_pixels(pt[..., 0], pt[..., 1])
                sw = entry["sw"][self._band_sel[i]]
                sample = 0.0
                for s in range(cmb.n_stokes):
                    sample = sample + sw[:, s][:, None] * fields[s][pix]
                pwv_b, el_b = pwv_ext[rows][:, interior], el_ext[rows][:, interior]
                total[rows] += entry["cmb_P0"](pwv_b, el_b) * mueller_I[rows, None] + entry["cmb_dPdT"](
                    pwv_b, el_b) * sample

        if sky["map"] is not None:
            mp = sky["map"]
            g = (c0 - 1) * r + torch.arange(B + 2 * r, device=self.device)
            idx = torch.clamp(g, 0, self.n_t - 1) - (c0 - 1) * r
            for i, entry in enumerate(sky["bands"]):
                if not entry["map_stages"]:
                    continue
                rows = band_rows[i]
                o = offsets[rows]
                if mp["radec"]:
                    pt = offsets_to_phi_theta(sky_offsets(o, ext["cq"], ext["sq"]), ext["ra"], ext["dec"])
                else:
                    pt = offsets_to_phi_theta(o[:, None, :], ext["az"], ext["el"])
                d = phi_theta_to_offsets(pt, *mp["center"])
                dx, dy = d[..., 0], d[..., 1]
                pwv_b, el_b = pwv_ext[rows], el_ext[rows]
                piece = 0.0
                for st in entry["map_stages"]:
                    cmap = st["map"]
                    sw = entry["sw"][self._band_sel[i]]
                    if mp["n_frames"] == 1:
                        samples = cmap.sample(dx, dy, stokes_weight=sw, nu_index=st["channel"],
                                              bilinear=mp["bilinear"])
                    else:
                        fi, whi = ext["fi"], ext["whi"]
                        samples = torch.zeros(dx.shape, dtype=torch.float32, device=self.device)
                        for f in range(mp["n_frames"]):
                            w_f = torch.where(fi == f, 1 - whi, 0.0) + torch.where(fi + 1 == f, whi, 0.0)
                            samples = samples + w_f[None, :] * cmap.sample(
                                dx, dy, stokes_weight=sw, nu_index=st["channel"], t_index=f,
                                bilinear=mp["bilinear"])
                    piece = piece + st["cal"](pwv_b, el_b) * samples
                # the integration kernel on the haloed product, clamped at
                # the series' ends as the batch kernel pads them
                x = piece[:, idx][:, r - 1:r + B + 1]
                total[rows] += 0.25 * x[:, :-2] + 0.5 * x[:, 1:-1] + 0.25 * x[:, 2:]
        return total

    def noise_block(self, state, b: int, fields_sum, draws: list = None):
        """(new noise states, noise (n_det, B) pW) of block b: every band's
        white noise and, through one KC launch, every cascade's pink
        noise; ``fields_sum`` is the block's ungained loading (for
        NEP_per_loading). ``draws`` optionally gives a band's (white,
        innovations, mode innovations) as ``StreamingBandNoise.draw``."""
        from .program import band_noise_scale

        p, dev, B = self.program, self.device, self.B
        key = state["key"]
        white = [None] * len(p.bands)
        cr = self._casc_rows
        w_all = torch.empty((cr["n"], B), dtype=torch.float32, device=dev) if cr else None
        for i, (band, model) in enumerate(zip(p.bands, self.noise_models)):
            # the band's whole draws in StreamingBandNoise.draw's order, this executor's rows kept
            g = None if draws is not None else _generator(dev, key, 3, i, b)
            given = (None, None, None) if draws is None else draws[i]
            sel, n_band = self._band_sel[i], len(band.det_index)
            white[i] = _normals(g, (n_band, B), sel, given[0], dev)
            if model.cascade is not None:
                a, z = cr["spans"][(i, 0)]
                _normals(g, (n_band, B), sel, given[1], dev, out=w_all[a:z])
                if model.n_modes:
                    a, z = cr["spans"][(i, 1)]
                    _normals(g, (model.n_modes, B), slice(None), given[2], dev, out=w_all[a:z])
        new_noise = list(state["noise"])
        pink_all = None
        if cr:
            order = [(i, j) for (i, j) in cr["spans"]]
            states = torch.cat([state["noise"][i][j] for i, j in order])
            t = self._casc_tensors(dev)
            pink_all, new_states = pink_cascade(w_all, states, t["p"], t["a"], t["table"])
            del w_all
            for (i, j) in order:
                a, z = cr["spans"][(i, j)]
                new_noise[i] = tuple(new_states[a:z] if jj == j else new_noise[i][jj]
                                     for jj in range(len(state["noise"][i])))
        noise = torch.empty((self.n_det, B), dtype=torch.float32, device=dev)
        band_rows = p._tensors(dev, self.rows)["det_index"]
        for i, (band, model) in enumerate(zip(p.bands, self.noise_models)):
            pink = mode_pink = None
            if model.cascade is not None:
                a, z = cr["spans"][(i, 0)]
                pink = pink_all[a:z]
                if model.n_modes:
                    a, z = cr["spans"][(i, 1)]
                    mode_pink = pink_all[a:z]
            rows = band_rows[i]
            unscaled = model.combine(white[i], pink, mode_pink, rows=self._band_sel[i])
            white[i] = None
            noise[rows] = band_noise_scale(band, [fields_sum[rows]] if band.NEP_per_loading else []) * unscaled
        return new_noise, noise

    def block(self, state, b: int, with_map: bool = True, with_psd: bool = False, draws: list = None):
        """(new state, TOD (n_det, B) pW) of block b: atmosphere (+ sky),
        gains, noise, and with ``with_map`` the K2 binning into the
        carried map, with ``with_psd`` the Welch accumulators."""
        p = self.program
        fields_sum = self.atmosphere_block(state, b)
        if self.sky is not None:
            fields_sum = fields_sum + self.sky_block(state, b)
        nep_loading = p.with_noise and any(band.NEP_per_loading for band in p.bands)
        tod = fields_sum * state["gains"] if nep_loading else fields_sum.mul_(state["gains"])
        new_state = dict(state)
        if p.with_noise:
            new_state["noise"], noise = self.noise_block(state, b, fields_sum, draws=draws)
            tod += noise
            del noise
        del fields_sum
        if with_map:
            binned = bin_map(tod[None], self.pixel_ids(b), self.n_y * self.n_x, count=True)
            new_state["map_sum"] = state["map_sum"] + binned[0]
            new_state["map_wgt"] = state["map_wgt"] + binned[1]
        if with_psd:
            new_state.update(self._welch(state, tod, b))
        return new_state, tod

    def _welch(self, state, tod, b: int) -> dict:
        """The block's detrended, Hann-windowed per-band periodograms,
        averaged over the band's detectors (full blocks only: a partial
        tail block's padding would bias the spectrum)."""
        B, dev = self.B, self.device
        full = float((b + 1) * B <= self.n_t)
        hann = 0.5 - 0.5 * torch.cos(2 * np.pi * torch.arange(B, device=dev, dtype=torch.float32) / B)
        one_sided = torch.full((B // 2 + 1,), 2.0, device=dev)
        one_sided[0] = 1.0
        if B % 2 == 0:
            one_sided[-1] = 1.0
        norm = one_sided / (self.program.sample_rate * torch.sum(hann**2))
        psd_sum = []
        for i, rows in enumerate(self.program._tensors(dev, self.rows)["det_index"]):
            x = tod[rows]
            x = x - x.mean(dim=-1, keepdim=True)
            spec = torch.fft.rfft(x * hann, dim=-1).abs() ** 2
            # a rank adds its rows' share of the band's mean; the shares are summed across ranks
            mean = spec.mean(dim=0) if self.rows is None else spec.sum(dim=0) / len(self.program.bands[i].det_index)
            psd_sum.append(state["psd_sum"][i] + full * norm * mean)
        return {"psd_sum": psd_sum, "psd_blocks": state["psd_blocks"] + full}

    # -- checkpoint / resume -------------------------------------------------------
    # Only the leaves a block changes are kept (the cascades' states, the
    # map and Welch accumulators), in maria_tpu's npz layout (leaf_i in the
    # order of its sorted-key tree flattening); the rest of the state is a
    # function of the seed, which resume recomputes.

    def mutable_leaves(self, state) -> list:
        leaves = [state["bin_lost"], state["map_sum"], state["map_wgt"]]
        for band_state in state["noise"]:
            leaves += list(band_state)
        return leaves + [state["psd_blocks"], *state["psd_sum"]]

    def set_mutable_leaves(self, state, leaves) -> dict:
        """``state`` with its mutable leaves replaced, in ``mutable_leaves``' order."""
        leaves = [x.to(device=self.device, dtype=torch.float32) if torch.is_tensor(x)
                  else torch.as_tensor(np.array(x, dtype=np.float32), device=self.device) for x in leaves]
        cur = self.mutable_leaves(state)
        if len(leaves) != len(cur):
            raise ValueError(f"{len(leaves)} leaves given, the state has {len(cur)}")
        for c, n in zip(cur, leaves):
            if tuple(c.shape) != tuple(n.shape):
                raise ValueError(f"leaf shape mismatch: {tuple(n.shape)} != {tuple(c.shape)}")
        it = iter(leaves)
        state = dict(state)
        state["bin_lost"], state["map_sum"], state["map_wgt"] = next(it), next(it), next(it)
        state["noise"] = [tuple(next(it) for _ in band_state) for band_state in state["noise"]]
        state["psd_blocks"] = next(it)
        state["psd_sum"] = [next(it) for _ in state["psd_sum"]]
        return state

    def _fingerprint(self) -> str:
        return (f"v3:scatter:{self.n_t}:{self.n_blocks}:{self.B}:{self.n_det_global}:{self.n_x}:{self.n_y}:"
                f"{self.res:.9g}:{self.center[0]:.9g}:{self.center[1]:.9g}:{self.frame}")

    DET_MAJOR_KEYS = ("lc_pad", "lc_last", "gains", "pwv_pad2", "pwv_last", "el_pad2", "el_last")

    def global_leaves(self, state) -> list:
        """The mutable leaves in the single-process layout: on a mesh, the
        accumulators summed over the "det" ranks and every band's cascade
        state gathered to the band's whole rows (a collective)."""
        if self.mesh is None:
            return self.mutable_leaves(state)
        leaves = [self._reduce(state[k]) for k in ("bin_lost", "map_sum", "map_wgt")]
        for i, band_state in enumerate(state["noise"]):
            for j, x in enumerate(band_state):
                if j == 0:  # detector rows; the mode cascades are replicated
                    whole = x.new_zeros((len(self.program.bands[i].det_index), *x.shape[1:]))
                    whole[self._band_sel[i]] = x
                    x = self.mesh.all_reduce(whole, "det")
                leaves.append(x)
        return leaves + [state["psd_blocks"], *[self._reduce(x) for x in state["psd_sum"]]]

    def local_leaves(self, state, leaves) -> list:
        """This rank's part of single-process-layout ``leaves`` laid over
        ``state``'s structure: its rows of the cascades' states, and the
        accumulators on the first "det" rank alone (the others add to zero)."""
        if self.mesh is None:
            return list(leaves)
        first = self.mesh.axis_index("det") == 0
        it = iter(_as_f32(x, self.device) for x in leaves)

        def acc(x):
            return x if first else torch.zeros_like(x)

        out = [acc(next(it)) for _ in range(3)]
        for i, band_state in enumerate(state["noise"]):
            out += [x[self._band_sel[i]] if j == 0 else x for j, x in zip(range(len(band_state)), it)]
        out.append(next(it))
        return out + [acc(x) for x in it]

    def shard_state(self, state) -> dict:
        """This rank's part of a single-process ``state`` (an
        ``init_state``, or one carried from maria_tpu): its rows of the
        detector-major leaves and of the cascades' states."""
        if self.mesh is None:
            return state
        r0, r1 = self.rows
        out = {k: (v[r0:r1] if k in self.DET_MAJOR_KEYS else v) for k, v in state.items()}
        out["noise"] = [tuple(x[self._band_sel[i]] if j == 0 else x for j, x in enumerate(band_state))
                        for i, band_state in enumerate(state["noise"])]
        if self.mesh.axis_index("det") != 0:  # the accumulators count once, on the first rank
            out.update({k: torch.zeros_like(state[k]) for k in ("bin_lost", "map_sum", "map_wgt")})
            out["psd_sum"] = [torch.zeros_like(x) for x in state["psd_sum"]]
        return out

    def _save_ckpt(self, path, state, next_block: int, key: int):
        payload = {f"leaf_{i}": x.detach().cpu().numpy() for i, x in enumerate(self.global_leaves(state))}
        if self.mesh is not None and self.mesh.rank != 0:
            return  # rank 0 writes the checkpoint
        tmp = f"{path}.tmp"
        np.savez(tmp, next_block=np.int64(next_block), fingerprint=np.str_(self._fingerprint()),
                 key_data=np.asarray([key], dtype=np.int64), **payload)
        os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)

    def _load_ckpt(self, path, state, key: int):
        """(state with its mutable leaves from ``path``, next block);
        raises ValueError on any mismatch."""
        with np.load(path, allow_pickle=False) as z:
            if str(z["fingerprint"]) != self._fingerprint():
                raise ValueError(f"checkpoint {path} was written for a different run "
                                 f"({z['fingerprint']} != {self._fingerprint()})")
            if not np.array_equal(z["key_data"], np.asarray([key], dtype=np.int64)):
                raise ValueError(f"checkpoint {path} was written with a different seed")
            n = len(self.mutable_leaves(state))
            leaves = self.local_leaves(state, [z[f"leaf_{i}"] for i in range(n)])
            return self.set_mutable_leaves(state, leaves), int(z["next_block"])

    # -- runs ----------------------------------------------------------------------
    def _blocks(self, state, start_block: int = 0, with_map: bool = True, with_psd: bool = False,
                draws: dict = None):
        """Yield (b, state after block b, block b's TOD)."""
        blocks = (draws or {}).get("blocks")
        for b in range(start_block, self.n_blocks):
            state, tod = self.block(state, b, with_map=with_map, with_psd=with_psd,
                                    draws=None if blocks is None else blocks[b])
            yield b, state, tod

    def run(self, key: int = None, group_size: int = 8, mesh=None, accumulate_psd: bool = False,
            checkpoint_path=None, checkpoint_every: int = None, mxu_binning: bool = None, draws: dict = None,
            state: dict = None) -> StreamingResult:
        """Synthesize and bin the whole observation with seed ``key``.
        ``group_size`` blocks make a group, the unit of checkpointing:
        ``checkpoint_path`` writes the accumulators atomically every
        ``checkpoint_every`` blocks (default: every group), and a run
        finding the file for the same seed and geometry continues where
        it stopped (the result is the uninterrupted run's).
        ``accumulate_psd`` adds the per-band Welch spectra. ``draws`` (see
        ``init_state``; and "blocks": a block's per-band draws, see
        ``noise_block``) or ``state`` (an ``init_state``, e.g. carried
        from maria_tpu by ``convert.stream_state_from_arrays``) replace the
        generators; both are global. With a ("det", ...) ``mesh`` every rank
        runs its detector rows and returns the same reduced result (module
        docstring). ``mxu_binning`` is maria_tpu's and changes nothing."""
        if mesh is not None:
            ex = self.shard(mesh)
            return ex.run(key, group_size=group_size, accumulate_psd=accumulate_psd, checkpoint_path=checkpoint_path,
                          checkpoint_every=checkpoint_every, draws=draws,
                          state=None if state is None else ex.shard_state(state))
        key = 0 if key is None else int(key)
        state = self.init_state(key, draws) if state is None else state
        start_block = 0
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            state, start_block = self._load_ckpt(checkpoint_path, state, key)
        every = checkpoint_every or group_size
        last_saved = start_block
        for b, state, _ in self._blocks(state, start_block, with_psd=accumulate_psd, draws=draws):
            done = b + 1  # a group ends every group_size blocks from the start
            if (checkpoint_path is not None and done < self.n_blocks and (done - start_block) % group_size == 0
                    and done - last_saved >= every):
                self._check_lost(state)
                self._save_ckpt(checkpoint_path, state, done, key)
                last_saved = done
        self._check_lost(state)
        psd_freqs = psds = None
        if accumulate_psd:
            n_blocks = max(float(state["psd_blocks"]), 1.0)
            psd_freqs = np.fft.rfftfreq(self.B, d=1.0 / self.program.sample_rate)
            psds = [self._reduce(s).cpu().numpy() / n_blocks for s in state["psd_sum"]]
        return StreamingResult(
            map_sum=self._reduce(state["map_sum"]).reshape(self.n_y, self.n_x).cpu().numpy(),
            map_wgt=self._reduce(state["map_wgt"]).reshape(self.n_y, self.n_x).cpu().numpy(),
            n_samples=self.n_real_det * self.n_t, n_x=self.n_x, n_y=self.n_y, center=self.center, res=self.res,
            psd_freqs=psd_freqs, psds=psds,
        )

    def _check_lost(self, state):
        lost = float(self._reduce(state["bin_lost"]))
        if lost:
            raise RuntimeError(f"the binning dropped {lost:.0f} in-map samples")

    def tod_blocks(self, key: int = None, group_size: int = 1, draws: dict = None, state: dict = None):
        """Yield (block index, TOD block (n_det, <= B) pW on the device) in
        stream order: the lazy TOD. ``draws`` and ``state`` as ``run``;
        ``group_size`` is maria_tpu's (its dispatch groups) and changes
        nothing."""
        key = 0 if key is None else int(key)
        state = self.init_state(key, draws) if state is None else state
        for b, state, tod in self._blocks(state, with_map=False, draws=draws):
            yield b, tod[:, :min(self.B, self.n_t - b * self.B)]
