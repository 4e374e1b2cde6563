"""The TOD-synthesis program (maria_tpu/ops/program.py): a static scene
(pointing, screens and screen groups, band tables, noise spec) and
functions that turn one realization's draws into detector loadings.

``fields`` is the per-field route ``Simulation.run`` takes (per-band
noise through kernel K1; AR screens extruded by one launch of the AR
kernel, ``ops/ar_extrude.py``, for all of a realization's processes).
``total_power_fn`` is the total-power route:
the signal times the gains plus the noise, with the whole banded noise
stage as one matrix product (``noise/dft.py``, kernel K3) whenever the
bands partition the detector axis. The port keeps these contracts and
drops the TPU devices around them (jit-argument tables, the no-gather
band slicing, detector permutation).

Both routes are differentiable in the pointing: ``fields`` and
``total_power_fn()``'s function take the detector ``offsets`` and the
coarse boresight track (``bs_az``, ``bs_el``) as optional tensors, and
``seed`` as the realization's handle, from which every call seeds its
own generator on the device, so one seed is one realization, inside
``torch.enable_grad()`` or out of it (``fields_fn``, ``example_args``:
maria_tpu's ``(key, offsets, bs_az_c, bs_el_c)`` functions). The
gradient flows through the line of sight, the bilinear samplers'
fractional weights, the band tables and, with ``NEP_per_loading``, the
noise scale; the screens, the tables, the static sky samples and the
noise draws are constants. The in-place assemblies (the per-band index
writes into fresh buffers, the signal's sum, the noise product's
epilogue) overwrite no tensor that autograd saved for the backward.

A rank of a detector mesh computes one range of rows: ``fields``,
``draw_gains`` and ``total_power_fn()``'s function take ``rows=(start,
stop)`` and build only that range's per-detector tables. Every draw is
consumed in the unsharded order at its global shape and the rank keeps
its rows (K3 draws only its own through ``row0``), so a rank's rows
equal the unsharded run's rows for the same seed. ``pad_detectors``
pads the detector axis to a multiple of the ranks, as maria_tpu does.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..array.rows import device_rows, row_span
from ..atmosphere.sampling import accumulate_pwv, gaussian_blur_weights, group_tensors
from ..coords import offsets_to_phi_theta
from ..device import resolve_device
from ..io.logging import count, span
from ..noise import generate_noise_with_knee
from .ar_extrude import ar_extrude, ar_plan
from .band_tables import BandStage, BandTables, band_tables
from .interp import TableEval, apply_integration_kernel, upsample_time, upsample_time_phases

__all__ = ["BandBlock", "TODProgram", "band_noise_basis", "build_tod_program", "gain_errors"]


@dataclass
class BandBlock:
    """Static per-band data of the program."""

    name: str
    det_index: np.ndarray  # rows of this band on the detector axis
    pwv_side: np.ndarray  # (pwv, el) -> pW loading table, cropped to the reachable window
    el_side: np.ndarray
    power_table: np.ndarray
    NEP: float
    knee: float
    noise_basis: np.ndarray = None  # (n_band_det, k) correlated-noise basis
    corr_prop: float = 0.0
    NEP_per_loading: float = 0.0
    # the CMB stage: static Stokes-weighted K_CMB samples (n_band_det, n_t)
    # on the device, and the (pwv, el) tables of P(T_CMB) in pW and of
    # dP/dT_CMB in pW/K_CMB on the band's window
    cmb_samples: object = None
    cmb_P0_table: np.ndarray = None
    cmb_dPdT_table: np.ndarray = None
    # the input map's stages: one (pW-per-K_RJ table on the band's (pwv, el)
    # window, static K_RJ samples (n_band_det, n_t) on the device) a channel
    map_stages: list = None


@dataclass
class TODProgram:
    """Static scene -> per-realization loadings."""

    screens: list  # LayerScreen list (Fourier or AR screens)
    mean_pwv: float
    t_coarse: np.ndarray  # relative seconds (n_tc,)
    t_fine: np.ndarray  # relative seconds (n_t,)
    offsets: np.ndarray  # (n_det, 2)
    bs_az_coarse: np.ndarray
    bs_el_coarse: np.ndarray
    mueller_I: np.ndarray  # (n_det,)
    groups: list = field(default_factory=list)  # ScreenGroup list (Fourier 3-D)
    bands: list = field(default_factory=list)
    sample_rate: float = 50.0
    with_noise: bool = True
    gain_error: np.ndarray = None

    def __post_init__(self):
        if len(self.t_coarse) > 1 and len(self.t_fine) > 1:
            dt_c = float(np.mean(np.diff(self.t_coarse)))
            dt_f = float(np.mean(np.diff(self.t_fine)))
            ratio = max(1, int(round(dt_c / dt_f)))
            aligned = np.allclose(
                self.t_coarse, self.t_fine[0] + np.arange(len(self.t_coarse)) * ratio * dt_f,
                atol=0.01 * dt_f,
            )
            self.upsample_ratio = ratio if aligned else None
        else:
            self.upsample_ratio = None
        self._device_cache = {}
        self._noise_specs_cache = None
        if getattr(self, "n_real_det", None) is None:
            self.n_real_det = len(self.offsets)  # rows past this are padding (pad_detectors)

        # band_order: the bands sorted by first row when they partition
        # the detector axis into non-empty contiguous slices, else None
        spans = [row_span(b.det_index) for b in self.bands]
        self.band_order = None
        if spans and all(s is not None and s[0] < s[1] for s in spans):
            order = sorted(range(len(spans)), key=lambda i: spans[i][0])
            starts, stops = zip(*(spans[i] for i in order))
            if starts[0] == 0 and stops[-1] == len(self.offsets) and starts[1:] == stops[:-1]:
                self.band_order = order

    @property
    def ar_processes(self) -> list:
        """The distinct AR processes of the screens, in screen order."""
        return ar_processes(self.screens)

    @property
    def n_det(self) -> int:
        return len(self.offsets)

    @property
    def n_t(self) -> int:
        return len(self.t_fine)

    def pad_detectors(self, multiple: int) -> int:
        """Pad the detector axis to a multiple of ``multiple`` (the ranks of
        a detector mesh) and return the number of rows added. The padded
        rows replicate the last detector (its band, pointing, tables and
        noise basis); ``n_real_det`` keeps the real count, and consumers
        keep rows from it on out of every map (the streaming executor
        bins them at id -1). The draws' shapes grow with the rows, so a
        padded program is another realization than the unpadded one for
        the same seed: compare sharded and unsharded runs of the same
        padded program."""
        n_det = len(self.offsets)
        pad = -n_det % int(multiple)
        if not pad:
            return 0
        self.offsets = np.pad(np.asarray(self.offsets), ((0, pad), (0, 0)), mode="edge")
        self.mueller_I = np.pad(np.asarray(self.mueller_I), (0, pad), mode="edge")
        if self.gain_error is not None:
            self.gain_error = np.pad(np.asarray(self.gain_error), (0, pad), mode="edge")
        band = max(self.bands, key=lambda b: b.det_index[-1] if len(b.det_index) else -1)
        band.det_index = np.concatenate([band.det_index, n_det + np.arange(pad)]).astype(band.det_index.dtype)

        def pad_rows(a):
            if a is None:
                return None
            if torch.is_tensor(a):
                return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])])
            return np.pad(np.asarray(a), ((0, pad), (0, 0)), mode="edge")

        band.noise_basis = pad_rows(band.noise_basis)
        band.cmb_samples = pad_rows(band.cmb_samples)
        if band.map_stages:
            band.map_stages = [(table, pad_rows(samples)) for table, samples in band.map_stages]
        self.__post_init__()  # band contiguity, caches
        return pad

    def check_rows(self, rows):
        """``rows`` as a (start, stop) pair inside the detector axis, or None."""
        if rows is None:
            return None
        start, stop = int(rows[0]), int(rows[1])
        if not 0 <= start <= stop <= self.n_det:
            raise ValueError(f"rows ({start}, {stop}) lie outside the {self.n_det} detectors")
        return start, stop

    def band_row_slices(self, rows) -> list:
        """For each band, the slice of its ``det_index`` entries that lie in
        ``rows`` = (start, stop): a rank keeps these positions of a band's
        global draw."""
        start, stop = rows
        out = []
        for b in self.bands:
            idx = np.asarray(b.det_index)
            if np.any(np.diff(idx) <= 0):
                raise ValueError(f"band {b.name}'s detector rows are not in increasing order")
            out.append(slice(int(np.searchsorted(idx, start)), int(np.searchsorted(idx, stop))))
        return out

    def band_bounds(self):
        """Contiguous (start, stop) detector slices in band_order, or None
        when the bands do not partition the detector axis."""
        if self.band_order is None:
            return None
        return [row_span(self.bands[i].det_index) for i in self.band_order]

    def _tensors(self, device, rows=None):
        """The static tables as tensors on ``device`` (built once per device),
        the per-detector ones only for ``rows`` = (start, stop) when given.
        "det_index" holds each band's rows among them, counted from start
        (``device_rows``: a slice where they are contiguous), and
        "band_sel" the positions of those rows in the band."""
        key = str(device) if rows is None else (str(device), rows)
        if key not in self._device_cache:
            f32 = dict(dtype=torch.float32, device=device)
            r0, r1 = (0, self.n_det) if rows is None else rows
            sel = [slice(None)] * len(self.bands) if rows is None else self.band_row_slices(rows)
            band_rows = [np.asarray(b.det_index)[s] - r0 for b, s in zip(self.bands, sel)]
            self._device_cache[key] = {
                "band_sel": sel,
                "offsets": torch.tensor(np.asarray(self.offsets[r0:r1], dtype=np.float32), **f32),
                "bs_az": torch.tensor(np.asarray(self.bs_az_coarse, dtype=np.float32), **f32),
                "bs_el": torch.tensor(np.asarray(self.bs_el_coarse, dtype=np.float32), **f32),
                "t_c": torch.tensor(np.asarray(self.t_coarse, dtype=np.float32), **f32),
                "mueller_I": torch.tensor(np.asarray(self.mueller_I[r0:r1], dtype=np.float32), **f32),
                "W": [None if s.W is None else torch.tensor(s.W, **f32) for s in self.screens],
                "blur": [
                    None if s.W is not None or not s.beam_sigma else torch.as_tensor(gaussian_blur_weights(
                        s.ny, s.nx, s.beam_sigma, s.beam_sigma, s.ty_res if s.ty_res is not None else s.res, s.res,
                    ), device=device)
                    for s in self.screens
                ],
                "ar_plan": ar_plan(self.ar_processes, device) if self.ar_processes and device.type == "cuda" else None,
                "groups": [group_tensors(g, device) for g in self.groups],
                "power": BandTables([BandStage(r, b.pwv_side, b.el_side, (b.power_table,))
                                     for b, r in zip(self.bands, band_rows)], r1 - r0, device),
                "cmb": None if all(b.cmb_samples is None for b in self.bands) else BandTables([
                    BandStage(r, b.pwv_side, b.el_side) if b.cmb_samples is None else BandStage(
                        r, b.pwv_side, b.el_side, (b.cmb_P0_table, b.cmb_dPdT_table), b.cmb_samples[s].to(device))
                    for b, s, r in zip(self.bands, sel, band_rows)
                ], r1 - r0, device),
                "map": [
                    [(TableEval(b.pwv_side, b.el_side, table, device=device), samples[s].to(device))
                     for table, samples in b.map_stages or []]
                    for b, s in zip(self.bands, sel)
                ],
                "det_index": [device_rows(r, device) for r in band_rows],
                "basis": [  # whole bands: generate_noise_with_knee keeps "band_sel"'s rows
                    None if b.noise_basis is None else torch.tensor(np.asarray(b.noise_basis), **f32)
                    for b in self.bands
                ],
            }
        return self._device_cache[key]

    def _pointing(self, tabs, device, rows, offsets=None, bs_az=None, bs_el=None):
        """(offsets, bs_az, bs_el) of one call on ``device``: each handed-in
        tensor as float32 (``offsets`` at its global (n_det, 2) shape, the
        ``rows`` kept), else the program's own from ``tabs``."""
        def given(x, shape, name):
            if tuple(x.shape) != shape:
                raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
            return torch.as_tensor(x).to(device=device, dtype=torch.float32)

        n_tc = len(self.t_coarse)
        if offsets is not None:
            offsets = given(offsets, (self.n_det, 2), "offsets")
            offsets = offsets if rows is None else offsets[rows[0]:rows[1]]
        return (
            tabs["offsets"] if offsets is None else offsets,
            tabs["bs_az"] if bs_az is None else given(bs_az, (n_tc,), "bs_az"),
            tabs["bs_el"] if bs_el is None else given(bs_el, (n_tc,), "bs_el"),
        )

    def _upsample(self, values, kind):
        if self.upsample_ratio is not None:
            return upsample_time_phases(values, self.upsample_ratio, self.n_t, kind=kind)
        return upsample_time(values, self.t_coarse, self.t_fine, kind=kind)

    def fields(self, generator=None, draws: dict = None, device=None, upto: str = None, rows=None, offsets=None,
               bs_az=None, bs_el=None, seed: int = None):
        """One realization: ({field: (n_det, n_t) pW}, pwv_fine).

        Gains are not applied here (see ``draw_gains`` and
        ``Simulation.run_obs``). ``draws`` optionally supplies the
        realization's unit normals: "screens" (one (ny, nx//2+1, 2) per
        Fourier screen), "groups" (one (2J, ny, nx//2+1, 2) per screen
        group), "ar" (one (buffer_init, noise) pair per AR process, in
        ``ar_processes`` order, see ``AutoregressiveProcess.draw``),
        "noise" and "modes" (one per band, see
        ``generate_noise_with_knee``). What is not supplied comes from
        ``generator`` in this order: screens, groups, AR processes, noise
        (a program holds Fourier screens and groups or AR processes,
        never both: the atmosphere's method applies to all its layers).
        ``upto`` stops early: "pwv" ->
        {"pwv": coarse pwv}, "coarse" -> the streaming executor's
        whole-observation stage at the coarse rate, {"loading_c": the
        atmospheric loading, "pwv_c", "el_c": the clipped elevation} (each
        (n_det, n_tc)), "atmosphere" -> {"atmosphere": the upsampled
        atmospheric loading}, "signal" -> every field but the noise (the
        atmosphere and, with a CMB or an input map, "cmb" and "map").
        ``rows`` = (start, stop) computes only those detectors' rows of
        every field, from the same draws (handed-in draws stay global).

        ``offsets`` (n_det, 2) and ``bs_az``, ``bs_el`` (n_tc,) optionally
        replace the program's detector offsets and coarse boresight track
        (tensors, through which autograd differentiates; ``offsets`` stays
        global with ``rows``). ``seed`` draws the realization from a
        generator seeded with it on ``device`` in place of ``generator``.
        """
        device = resolve_device(device)
        generator = seeded(generator, seed, device)
        draws = draws or {}
        rows = self.check_rows(rows)
        tabs = self._tensors(device, rows)
        n_rows = self.n_det if rows is None else rows[1] - rows[0]

        with span("program.pointing"):
            _, el_clip, px, py = line_of_sight(*self._pointing(tabs, device, rows, offsets, bs_az, bs_el))
        with span("atmosphere.synthesize"):
            ar_values = ar_screen_values(self.screens, generator, draws.get("ar"), device, plan=tabs["ar_plan"])
        pwv = accumulate_pwv(
            self.mean_pwv, self.screens, px, py, tabs["t_c"], W=tabs["W"],
            generator=generator, draws=draws.get("screens"),
            groups=self.groups, group_tables=tabs["groups"], group_draws=draws.get("groups"),
            ar_values=ar_values, blur=tabs["blur"],
        )
        if upto == "pwv":
            return {"pwv": pwv}

        with span("program.loading"):
            loading_c = band_tables(tabs["power"], pwv, el_clip, tabs["mueller_I"])
        if upto == "coarse":
            return {"loading_c": loading_c, "pwv_c": pwv, "el_c": el_clip}
        with span("program.upsample"):
            fields = {"atmosphere": self._upsample(loading_c, "cubic")}
        if upto == "atmosphere":
            return fields

        # the CMB and input-map stages: the sky timelines are static; their
        # calibration to pW is evaluated at the fine rate, where the pwv
        # carries the fast fluctuations that modulate the transmission
        pwv_f = el_f = None
        if any(b.cmb_samples is not None or b.map_stages for b in self.bands):
            with span("program.upsample"):
                pwv_f, el_f = self._upsample(pwv, "linear"), self._upsample(el_clip, "cubic")
        if tabs["cmb"] is not None:
            with span("program.cmb"):
                fields["cmb"] = band_tables(tabs["cmb"], pwv_f, el_f, tabs["mueller_I"])
        # the map's integration kernel comes after its calibration
        if any(b.map_stages for b in self.bands):
            with span("program.map"):
                map_field = torch.zeros((n_rows, self.n_t), dtype=torch.float32, device=device)
                for i in range(len(self.bands)):
                    if not tabs["map"][i]:
                        continue
                    idx = tabs["det_index"][i]
                    pwv_b, el_b = pwv_f[idx], el_f[idx]
                    map_field[idx] = sum(cal(pwv_b, el_b) * samples for cal, samples in tabs["map"][i])
                fields["map"] = apply_integration_kernel(map_field)
                del map_field
        del el_f
        if upto == "signal":
            return fields

        if self.with_noise:
            with span("noise"):
                noise = torch.empty((n_rows, self.n_t), dtype=torch.float32, device=device)
                for i, band in enumerate(self.bands):
                    idx = tabs["det_index"][i]
                    with span("noise.k1"):
                        unscaled = generate_noise_with_knee(
                            (len(band.det_index), self.n_t), sample_rate=self.sample_rate, knee=band.knee,
                            basis=tabs["basis"][i], corr_prop=band.corr_prop, generator=generator,
                            white=None if "noise" not in draws else draws["noise"][i],
                            mode_white=None if "modes" not in draws else draws["modes"][i],
                            device=device, rows=tabs["band_sel"][i],
                        )
                    noise[idx] = band_noise_scale(band, [v[idx] for v in fields.values()]) * unscaled
                fields["noise"] = noise
        if pwv_f is None:
            with span("program.upsample"):
                pwv_f = self._upsample(pwv, "linear")
        return fields, pwv_f

    def draw_gains(self, generator=None, draw=None, device=None, rows=None):
        """(n_det, 1) multiplicative gain errors exp(gain_error * N(0, 1)),
        or None when the program carries none; ``draw`` optionally
        supplies the (n_det,) normals. With ``rows`` = (start, stop) the
        normals are drawn whole and those rows returned."""
        if self.gain_error is None:
            return None
        rows = self.check_rows(rows)
        return gain_errors(self.gain_error, generator, draw, device, rows=None if rows is None else slice(*rows))

    def use_noise_matmul(self) -> bool:
        """Whether ``total_power_fn`` runs the noise stage as one matrix
        product (``noise/dft.py``): the structural condition of
        maria_tpu's ``use_noise_matmul`` (noise on, the bands partition
        the detector axis, more than one sample), on every device."""
        return (
            self.with_noise and self.band_order is not None and len(self.bands) > 0
            and all(not b.NEP_per_loading for b in self.bands) and len(self.t_fine) > 1
        )

    def _noise_matmul_specs(self):
        """(specs, corr_cols, n_fft, shared_c, row_scale) of
        ``noise_total_matmul``, host numpy, built once, in band_order.
        When every band shares one normalized spectral shape, shared_c is
        that shape, row_scale the per-row 1e12 NEP, and corr_cols carry
        sqrt(cp) * basis without the NEP; otherwise both are None and the
        NEP rides each band's c and columns."""
        if self._noise_specs_cache is not None:
            return self._noise_specs_cache
        from ..atmosphere.fourier import good_fft_size
        from ..noise.dft import NoiseBandSpec, band_half_spectrum

        n_fft = good_fft_size(self.n_t)
        specs, shapes, col_blocks = [], [], []
        k_total = 0
        for i, (start, stop) in zip(self.band_order, self.band_bounds()):
            b = self.bands[i]
            cp = b.corr_prop if b.noise_basis is not None else 0.0
            shape = band_half_spectrum(self.sample_rate, b.knee, 1.0, n_fft, corr_prop=cp)
            shapes.append(shape)
            k_modes, mode_c = 0, None
            if cp > 0:
                k_modes = int(np.asarray(b.noise_basis).shape[-1])
                mode_c = band_half_spectrum(self.sample_rate, b.knee, 1.0, n_fft, pink_only=True)
                col_blocks.append((start, stop, k_total, b.NEP, np.sqrt(cp) * np.asarray(b.noise_basis)))
                k_total += k_modes
            specs.append(NoiseBandSpec(start=start, stop=stop, c=1e12 * b.NEP * shape, k_modes=k_modes,
                                       mode_c=mode_c, key_index=i))
        shared = all(np.allclose(s, shapes[0], rtol=1e-6) for s in shapes[1:])
        shared_c = shapes[0] if shared else None
        row_scale = None
        if shared:
            row_scale = np.zeros((self.n_det, 1), np.float32)
            for i, sp in zip(self.band_order, specs):
                row_scale[sp.start:sp.stop] = 1e12 * self.bands[i].NEP
        corr_cols = None
        if k_total:
            corr_cols = np.zeros((self.n_det, k_total), np.float32)
            for start, stop, col0, nep, block in col_blocks:
                scale = 1.0 if shared else 1e12 * nep
                corr_cols[start:stop, col0:col0 + block.shape[-1]] = scale * block
        self._noise_specs_cache = (specs, corr_cols, n_fft, shared_c, row_scale)
        return self._noise_specs_cache

    def total_power_fn(self):
        """fn(generator=None, draws=None, device=None, rows=None, offsets=None,
        bs_az=None, bs_el=None, seed=None) -> (n_det, n_t) float32 total
        pW, gain errors included (only the detectors ``rows`` = (start,
        stop) when given, equal to those rows of the unsharded total).
        ``offsets``, ``bs_az``, ``bs_el`` and ``seed`` are as ``fields``
        takes them: the total is differentiable in the pointing.

        With ``use_noise_matmul()`` the noise stage is one matrix product
        whose epilogue adds the gained signal (``noise_total_matmul``); V
        is kernel K3's draw when the bands share a spectral shape. Else
        it is the ``fields`` route: the per-band noise (kernel K1) plus
        the gained signal. ``draws`` optionally supplies the normals:
        "screens", "groups", "ar" and "gains" as ``fields`` and
        ``draw_gains`` take them, and for the matrix product "v"
        ((n_det, 2, m+1), the white draw) and "modes" (per band,
        (k, 2, m+1)); on the fields route "noise" and "modes" as
        ``fields`` takes them.
        """
        if not self.use_noise_matmul():
            def fields_total(generator=None, draws=None, device=None, rows=None, offsets=None, bs_az=None,
                             bs_el=None, seed=None):
                device = resolve_device(device)
                generator = seeded(generator, seed, device)
                draws = draws or {}
                fields, _ = self.fields(generator=generator, draws=draws, device=device, rows=rows, offsets=offsets,
                                        bs_az=bs_az, bs_el=bs_el)
                with span("program.gains"):
                    gains = self.draw_gains(generator=generator, draw=draws.get("gains"), device=device, rows=rows)
                    total = 0.0
                    for name, v in fields.items():
                        total = total + (v if name == "noise" or gains is None else v * gains)
                return total

            return fields_total

        from ..noise.dft import noise_total_matmul

        specs, corr_cols, n_fft, shared_c, row_scale = self._noise_matmul_specs()

        def matmul_total(generator=None, draws=None, device=None, rows=None, offsets=None, bs_az=None, bs_el=None,
                         seed=None):
            device = resolve_device(device)
            generator = seeded(generator, seed, device)
            draws = draws or {}
            rows = self.check_rows(rows)
            tabs = self._tensors(device, rows)
            if "noise_cols" not in tabs:
                f32 = dict(dtype=torch.float32, device=device)
                r0, r1 = (0, self.n_det) if rows is None else rows
                tabs["noise_cols"] = None if corr_cols is None else torch.as_tensor(corr_cols[r0:r1], **f32)
                tabs["row_scale"] = None if row_scale is None else torch.as_tensor(row_scale[r0:r1], **f32)
            signal = self.fields(generator=generator, draws=draws, device=device, upto="signal", rows=rows,
                                 offsets=offsets, bs_az=bs_az, bs_el=bs_el)
            A = signal.pop("atmosphere")
            for v in signal.values():
                A += v
            del signal
            with span("program.gains"):
                gains = self.draw_gains(generator=generator, draw=draws.get("gains"), device=device, rows=rows)
                if gains is not None:
                    A = gains * A
            with span("noise"):
                return noise_total_matmul(
                    A, specs, n=self.n_t, n_fft=n_fft, corr_cols=tabs["noise_cols"], shared_c=shared_c,
                    row_scale=tabs["row_scale"], generator=generator, z=draws.get("v"), mode_z=draws.get("modes"),
                    device=device, rows=rows,
                )

        return matmul_total

    def fields_fn(self):
        """fn(seed, offsets=None, bs_az=None, bs_el=None, device=None,
        draws=None, rows=None) -> (fields, pwv_fine): ``fields`` of the
        realization ``seed`` as a function of the pointing (maria_tpu's
        ``fields_fn``)."""
        def fields_of(seed, offsets=None, bs_az=None, bs_el=None, device=None, draws=None, rows=None):
            return self.fields(seed=seed, draws=draws, device=device, rows=rows, offsets=offsets, bs_az=bs_az,
                               bs_el=bs_el)

        return fields_of

    def example_args(self, seed: int = 0, device=None) -> tuple:
        """(seed, offsets, bs_az, bs_el): the arguments that give the
        program's own realization ``seed``, the pointing as new float32
        tensors on ``device`` (the card unless another is named), ready
        for ``requires_grad_()``."""
        device = resolve_device(device)
        f32 = dict(dtype=torch.float32, device=device)
        return (
            int(seed),
            torch.tensor(np.asarray(self.offsets, dtype=np.float32), **f32),
            torch.tensor(np.asarray(self.bs_az_coarse, dtype=np.float32), **f32),
            torch.tensor(np.asarray(self.bs_el_coarse, dtype=np.float32), **f32),
        )


def _crop_table(x_side, y_side, table, x_lo, x_hi, y_lo, y_hi):
    """Restrict a (x, y) -> value table to the reachable window plus one
    guard cell: bilinear values inside the window are unchanged."""
    x = np.asarray(x_side)
    y = np.asarray(y_side)
    i0 = max(int(np.searchsorted(x, x_lo)) - 1, 0)
    i1 = min(int(np.searchsorted(x, x_hi)) + 1, len(x))
    j0 = max(int(np.searchsorted(y, y_lo)) - 1, 0)
    j1 = min(int(np.searchsorted(y, y_hi)) + 1, len(y))
    i1 = max(i1, i0 + 2)
    j1 = max(j1, j0 + 2)
    i0 = min(i0, len(x) - 2)
    j0 = min(j0, len(y) - 2)
    return x[i0:i1], y[j0:j1], np.asarray(table)[i0:i1, j0:j1]


def seeded(generator, seed, device):
    """``generator``, or with ``seed`` a new generator on ``device`` seeded
    with it: one seed, one realization, in every call."""
    if seed is None:
        return generator
    if generator is not None:
        raise ValueError("pass a generator or a seed, not both")
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def line_of_sight(offsets, bs_az, bs_el):
    """(det_el, el_clip, px, py), each (n_det, n_t): the detectors'
    elevation at the boresight's steps, clamped to [5, 90] deg, and the
    unit-height line-of-sight projection (x east, y north) of the
    offsets (n_det, 2) about the boresight (n_t,) tensors. The clamp, as
    maria_tpu's ``jnp.clip``, passes no gradient where it clips."""
    pt = offsets_to_phi_theta(offsets[:, None, :], bs_az, bs_el)
    det_az, det_el = pt[..., 0], pt[..., 1]
    el_clip = torch.clamp(det_el, float(np.float32(np.radians(5.0))), float(np.float32(np.pi / 2)))
    cot_el = 1 / torch.tan(el_clip)
    return det_el, el_clip, torch.sin(det_az) * cot_el, torch.cos(det_az) * cot_el


def ar_processes(screens) -> list:
    """The distinct AR processes of ``screens``, in screen order."""
    seen = {}
    for s in screens:
        if s.process is not None:
            seen.setdefault(id(s.process), s.process)
    return list(seen.values())


def ar_screen_values(screens, generator, draws, device, plan=None):
    """{screen index: (ny, nx) extruded values} of the AR screens, or
    None without AR processes: every process extruded by one launch of
    the AR kernel (its plain loop on the CPU). ``draws`` optionally gives
    each process's (buffer_init, noise) in ``ar_processes`` order;
    ``plan`` is the kernel's ``ar_plan`` (made here on a card without one)."""
    processes = ar_processes(screens)
    if not processes:
        return None
    if draws is None:
        draws = [p.draw(generator, device) for p in processes]
    elif len(draws) != len(processes):
        raise ValueError(f"draws['ar'] must hold one (buffer_init, noise) pair per process ({len(processes)})")
    if plan is None and torch.device(device).type == "cuda":
        plan = ar_plan(processes, device)
    buffers = [torch.as_tensor(d[0], dtype=torch.float32, device=device) for d in draws]
    noises = [torch.as_tensor(d[1], dtype=torch.float32, device=device) for d in draws]
    values = dict(zip(map(id, processes), ar_extrude(processes, buffers, noises, plan=plan)))
    return {i: values[id(s.process)][:, s.ar_columns].T for i, s in enumerate(screens) if s.process is not None}


def band_noise_scale(band, loadings):
    """The factor taking a band's unit-NEP noise to pW: 1e12 NEP, plus
    with ``NEP_per_loading`` its photon-loading term, 1e12 (NEP +
    NEP_per_loading P) with P the sum of ``loadings`` (the band's
    non-noise fields, (n_band_det, n_t) pW each) in W, sample by sample."""
    if not band.NEP_per_loading or not loadings:
        return float(np.float32(1e12 * band.NEP))
    loading_W = 1e-12 * sum(loadings)
    return 1e12 * (band.NEP + band.NEP_per_loading * loading_W)


def gain_errors(gain_error, generator=None, draw=None, device=None, rows=None):
    """(n_det, 1) multiplicative gain errors exp(gain_error * N(0, 1))
    on ``device``; ``draw`` optionally supplies the (n_det,) normals.
    ``rows`` (a slice of the detectors) keeps those rows of the whole
    draw, so they equal the same rows of the call without it."""
    device = resolve_device(device)
    rows = slice(None) if rows is None else rows
    n_det = len(gain_error)
    if draw is None:
        draw = torch.randn((n_det,), generator=generator, device=device, dtype=torch.float32)
    elif tuple(draw.shape) != (n_det,):
        raise ValueError(f"gain draw must have shape ({n_det},), got {tuple(draw.shape)}")
    g = torch.as_tensor(np.asarray(gain_error, dtype=np.float32)[rows], device=device)
    return torch.exp(g * draw[rows].to(device=device, dtype=torch.float32))[:, None]


def band_noise_basis(band_offsets, noise_kwargs: dict):
    """(basis, corr_prop) of one band's correlated detector noise: the
    (n_band_det, 5) spatial basis over the band's focal plane and the
    share of the pink power it carries, or (None, 0.0) for a band too
    small for one or with the share set to 0."""
    from ..utils import compute_diameter, generate_spatial_basis

    cp = noise_kwargs.get("correlated_noise_proportion", 0.0)
    fov = compute_diameter(band_offsets)
    if cp > 0 and fov > 0 and len(band_offsets) > 16:
        count("noise.basis_builds")
        return generate_spatial_basis(
            offsets=band_offsets, k=5, n_side=16,
            scale=fov * noise_kwargs.get("correlated_noise_spatial_scale", 1.0),
        ), cp
    return None, 0.0


def build_tod_program(obs, with_noise: bool = True, noise_kwargs: dict = {}, cmb=None, input_map=None,
                      map_kwargs: dict = {}, device=None) -> TODProgram:
    """Assemble the program from an initialized Observation. With ``cmb``
    (a HEALPixMap in K_CMB) and ``input_map`` (a ProjectionMap) the CMB
    and map stages run in the program: their sky timelines are made
    here, band by band on ``device`` (the pointing is static), and their
    pwv- and elevation-dependent calibration is evaluated per
    realization."""
    from ..sim.cmb import cmb_power_tables
    from ..sim.map import map_transmission_table, static_map_samples
    from ..tod import Pointing

    atm = obs.atmosphere
    T_base = float(atm.weather.temperature[0])
    t0 = float(obs.t[0])

    # reachable (pwv, el) window of the band tables: weather mean +- 8
    # sigma of the summed rms of the screens and of every group layer;
    # the boresight elevations +- the array extent
    sigma_pwv = float(np.sqrt(
        sum(float(s.pwv_rms) ** 2 for s in atm.screens)
        + sum(float(np.sum(np.asarray(g.pwv_rms) ** 2)) for g in atm.groups)
    ))
    mean_pwv = float(atm.weather.pwv)
    pwv_lo = max(0.0, mean_pwv - 8 * sigma_pwv)
    pwv_hi = mean_pwv + 8 * sigma_pwv
    bs_el = np.asarray(atm.boresight.el, dtype=np.float64)
    off_max = float(np.abs(np.asarray(obs.offsets)).max()) if len(obs.offsets) else 0.0
    el_lo = max(np.radians(5.0), float(bs_el.min()) - 2 * off_max)
    el_hi = min(np.pi / 2, float(bs_el.max()) + 2 * off_max)

    bands = []
    dets = obs.instrument.dets
    if cmb is not None:
        stokes_weight = torch.as_tensor(np.asarray(dets.stokes_weight(), dtype=np.float32),
                                        device=resolve_device(device))
    for i, (band, det_index) in enumerate(zip(dets.bands, dets.band_rows())):
        # float32 tables, as the JAX package stores them (Band.atmosphere_power reads the same)
        pwv_side, el_side, table = band.power_table32(atm.spectrum, T_base)
        xs, ys, tab = _crop_table(pwv_side, el_side, table, pwv_lo, pwv_hi, el_lo, el_hi)

        basis, corr_prop = band_noise_basis(dets.offsets[det_index], noise_kwargs) if with_noise else (None, 0.0)

        cmb_samples = cmb_P0 = cmb_dPdT = None
        if cmb is not None:
            cmb_samples = cmb.sample_stokes(Pointing(obs.boresight, obs.offsets[det_index], obs.q),
                                            stokes_weight[dets.band_rows_on(stokes_weight.device)[i]])
            _, _, P0, dPdT = cmb_power_tables(band, atm.spectrum, T_base)
            cmb_P0, cmb_dPdT = (_crop_table(pwv_side, el_side, t, pwv_lo, pwv_hi, el_lo, el_hi)[2] for t in (P0, dPdT))

        map_stages = None
        if input_map is not None:
            map_stages = []
            for channel, samples in static_map_samples(
                input_map, band, det_index, obs, bilinear=map_kwargs.get("bilinear_sampling", True),
                device=resolve_device(device),
            ):
                cal = map_transmission_table(band, input_map, channel, atm.spectrum, T_base)
                map_stages.append((_crop_table(pwv_side, el_side, cal, pwv_lo, pwv_hi, el_lo, el_hi)[2], samples))
        bands.append(BandBlock(
            name=band.name, det_index=det_index, pwv_side=xs, el_side=ys, power_table=tab,
            NEP=band.NEP, knee=band.knee, noise_basis=basis, corr_prop=corr_prop,
            NEP_per_loading=band.NEP_per_loading, cmb_samples=cmb_samples, cmb_P0_table=cmb_P0,
            cmb_dPdT_table=cmb_dPdT, map_stages=map_stages,
        ))

    # the AR processes' covariance operators are factorized here, on the
    # host in float64, before any realization runs their extrusion
    for s in atm.screens:
        if s.process is not None:
            s.process.run_setup()

    return TODProgram(
        screens=list(atm.screens),
        groups=list(atm.groups),
        mean_pwv=mean_pwv,
        t_coarse=np.asarray(atm.boresight.t, dtype=np.float64) - t0,
        t_fine=np.asarray(obs.t, dtype=np.float64) - t0,
        offsets=np.asarray(obs.offsets, dtype=np.float32),
        bs_az_coarse=np.asarray(atm.boresight.az, dtype=np.float32),
        bs_el_coarse=np.asarray(atm.boresight.el, dtype=np.float32),
        mueller_I=dets.mueller()[:, 0, 0],
        bands=bands,
        sample_rate=obs.sample_rate,
        with_noise=with_noise,
        gain_error=np.asarray(dets.gain_error, dtype=np.float32),
    )
