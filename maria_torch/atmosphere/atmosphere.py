"""Correlated atmospheric emission, host setup
(maria_tpu/atmosphere/atmosphere.py, ``Atmosphere.initialize``).

``initialize`` builds the layer table, the per-process wind and the
aligning rotation; then, with method="fourier", for model="2d" one
Fourier screen (or a fine/coarse band pair) per layer, and for
model="3d" one ``ScreenGroup``: L layer slices of a single 3-D Matérn
field on a common grid. With method="ar", for model="2d" one
autoregressive process per layer (a screen each), and for model="3d"
one process over the stacked cross-section of all the layers, whose
columns ``ar_columns`` are each layer's screen. The per-realization
synthesis or extrusion and the line-of-sight sampling run on device in
``TODProgram`` (``sampling.accumulate_pwv``).
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass

import numpy as np
import torch

from ..coords import offsets_to_phi_theta
from ..spectrum import AtmosphericSpectrum
from ..utils import principal_angle_2d
from ..weather import Weather
from .fourier import (
    band_split_spectral_weights_2d,
    field_spectral_weights_2d,
    good_fft_size,
    layered_field_spectral_weights,
)
from .layers import generate_layers
from .process import AutoregressiveProcess

_MIN_EXTENT_R0_FACTOR = 4.0
_MAX_EXTENT_CELLS = 4096


def _min_spectral_extent_cells(res: float, r0: float) -> int:
    return int(min(_MIN_EXTENT_R0_FACTOR * r0 / max(res, 1e-6), _MAX_EXTENT_CELLS))


@dataclass
class LayerScreen:
    """Static geometry of one Fourier or AR screen (host-built)."""

    h: float
    z: float
    res: float
    pwv_rms: float
    angle: float  # rotation of the extrusion frame
    vx: float  # wind east, m/s
    vy: float  # wind north, m/s
    tx_min: float
    ty_min: float
    nx: int
    ny: int
    W: np.ndarray = None  # (ny, nx//2+1) spectral weights (Fourier screens)
    process: AutoregressiveProcess = None  # AR screens
    ar_columns: slice = None  # this screen's columns of the process's cross-section
    beam_sigma: float = 0.0  # AR screens: the beam blur, m
    ty_res: float = None
    win_x: int = None
    win_y: int = None
    band: str = "full"


@dataclass
class ScreenGroup:
    """A vertically correlated stack of L layer screens on one grid (the
    Fourier 3-D model): slices of one 3-D Matérn field, synthesized
    jointly by ``fourier.synthesize_layered_matern_2d``."""

    heights: np.ndarray  # (L,) layer heights above the site
    zs: np.ndarray  # (L,) line-of-sight distances
    pwv_rms: np.ndarray  # (L,)
    angle: float
    vx: float
    vy: float
    res: float
    tx_min: float
    ty_min: float
    nx: int
    ny: int
    W: np.ndarray  # (J, ny, nx//2+1) per-node spectral amplitudes
    M_cos: np.ndarray  # (L, J)
    M_sin: np.ndarray  # (L, J)
    beam: np.ndarray = None  # (L, ny, nx//2+1)


SUPPORTED_MODELS = ["2d", "3d"]
SUPPORTED_METHODS = ["fourier", "ar"]


class Atmosphere:
    """The atmosphere of an observation. ``seed`` seeds ``simulate_pwv``
    when it is given no generator (a simulation's fused program draws
    from the simulation's generator instead). ``disable_progress_bars``
    is taken for maria_tpu's signature: the port draws no progress bars.
    ``sampler_dec_tol`` tunes maria_tpu's decimated TPU group sampler; the
    port samples every layer exactly at every step, so it takes the value
    and changes nothing."""

    def __init__(self, model: str = "2d", timestamp: float = None, region: str = "princeton",
                 altitude: float = None, weather: dict = {}, weather_quantiles: dict = {},
                 weather_source: str = "synthetic", spectrum_source: str = "synthetic/v1",
                 pwv_rms_frac: float = 0.03, max_height: float = 5e3, timestep: float = None,
                 method: str = "fourier", n_layers: int = None, min_height: float = None,
                 outer_scale: float = None, seed: int = None, disable_progress_bars: bool = True,
                 sampler_dec_tol: float = None):
        if model not in SUPPORTED_MODELS:
            raise ValueError(f"Invalid model '{model}'. Supported models are {SUPPORTED_MODELS}.")
        if method not in SUPPORTED_METHODS:
            raise ValueError(f"Invalid method '{method}'. Supported methods are {SUPPORTED_METHODS}.")
        self.seed = seed
        self.disable_progress_bars = disable_progress_bars
        self.sampler_dec_tol = sampler_dec_tol
        self.model = model
        self.method = method
        self.spectrum = AtmosphericSpectrum(region=region, source=spectrum_source)
        self.weather = Weather(
            region=region,
            time=timestamp if timestamp is not None else _time.time(),
            altitude=altitude,
            override=weather,
            quantiles=weather_quantiles,
            source=weather_source,
        )
        self.pwv_rms_frac = pwv_rms_frac
        self.max_height = max_height
        self.min_height = min_height
        self.outer_scale = outer_scale
        self.timestep = timestep
        # the 3-D model defaults to 12 log-spaced slabs, as in maria_tpu
        self.n_layers = n_layers if n_layers is not None else (12 if model == "3d" else None)

    def initialize(self, obs):
        self.layers = generate_layers(
            instrument=obs.instrument, boresight=obs.boresight, weather=self.weather,
            site=obs.site, mode=self.model, max_height=self.max_height,
            pwv_rms_frac=self.pwv_rms_frac, n_layers=self.n_layers, min_height=self.min_height,
        )
        layers = self.layers
        if self.timestep is None:
            min_fwhm = float(obs.instrument.dets.angular_fwhm(z=self.max_height).min())
            max_wind = float((layers["wind_speed"] / layers["h"]).max())
            self.timestep = max(1e-1, min_fwhm / max_wind)
            # snap to an integer multiple of the sample interval (integer
            # coarse/fine upsample ratio)
            dt_f = 1.0 / float(obs.sample_rate)
            self.timestep = max(dt_f, round(self.timestep / dt_f) * dt_f)

        self.boresight = obs.boresight.downsample(timestep=self.timestep)
        self.offsets = np.asarray(obs.offsets, dtype=np.float32)
        self.t0 = float(obs.t[0])  # the coarse times are taken relative to the observation's first sample
        n_t = self.boresight.shape[-1]
        dt = self.timestep
        outer_offsets = obs.instrument.dets.outer().offsets
        bs_az, bs_el = self.boresight.az, self.boresight.el

        pt = offsets_to_phi_theta(outer_offsets[:, None, :], bs_az, bs_el)
        hull_az, hull_el = pt[..., 0], pt[..., 1]
        cot_el = 1 / np.tan(np.clip(hull_el, np.radians(5), None))
        hull_px = np.sin(hull_az) * cot_el
        hull_py = np.cos(hull_az) * cot_el
        bs_cot = 1 / np.tan(np.clip(bs_el, np.radians(5), None))
        bs_px = np.sin(bs_az) * bs_cot
        bs_py = np.cos(bs_az) * bs_cot

        self.screens: list[LayerScreen] = []
        self.groups: list[ScreenGroup] = []
        w = layers["total_water"] * layers["temperature"]
        t_rel = dt * np.arange(n_t)

        for process_index in sorted(np.unique(layers["process_index"])):
            in_process = layers["process_index"] == process_index
            wp = w[in_process]
            vx = float((layers["wind_east"][in_process] * wp).sum() / wp.sum())
            vy = float((layers["wind_north"][in_process] * wp).sum() / wp.sum())
            hs_all = layers["h"][in_process]

            pts = []
            for h in {hs_all[0], hs_all[-1]}:
                px = h * hull_px + vx * t_rel
                py = h * hull_py + vy * t_rel
                pts.append(np.stack([px.ravel(), py.ravel()], axis=-1))
            pts = np.concatenate(pts, axis=0)

            angle = float(principal_angle_2d(pts))
            ca, sa = np.cos(angle), np.sin(angle)
            tx = ca * pts[:, 0] + sa * pts[:, 1]
            ty = -sa * pts[:, 0] + ca * pts[:, 1]
            outer_scale = self.outer_scale or max(1e3, 300 + float(hs_all.mean()) / 10)
            nu = 5 / 6 if self.model == "2d" else 1 / 3

            def window_bounds(h, res, nx, ny):
                rel_x = h * (hull_px - bs_px[None])
                rel_y = h * (hull_py - bs_py[None])
                span_x = float(np.abs(ca * rel_x + sa * rel_y).max())
                span_y = float(np.abs(-sa * rel_x + ca * rel_y).max())
                win_x = min(nx, int(-(-(2 * span_x / res + 6) // 8) * 8))
                win_y = min(ny, int(-(-(2 * span_y / res + 6) // 8) * 8))
                return win_x, win_y

            if self.model == "3d" and self.method == "ar":
                # one process over the stacked cross-section of every
                # layer, extruded at the finest layer resolution
                res_min = float(layers["res"][in_process].min())
                extrusion = np.arange(tx.min() - 2 * res_min, tx.max() + 2 * res_min, res_min)
                cross_list, col_slices = [], []
                start = 0
                for i in np.where(in_process)[0]:
                    res_i = float(layers["res"][i])
                    n_cross = max(2, int((ty.max() - ty.min() + 2 * res_i) / res_i))
                    cross_side = np.linspace(ty.min() - res_i, ty.max() + res_i, n_cross)
                    cross_list.append(np.stack([cross_side, np.full(n_cross, float(layers["h"][i]))], axis=-1))
                    col_slices.append(slice(start, start + n_cross))
                    start += n_cross
                process = AutoregressiveProcess(
                    cross_section=np.concatenate(cross_list, axis=0), extrusion=extrusion,
                    callback_kwargs={"nu": nu, "r0": outer_scale},
                )
                for i, cols, cross in zip(np.where(in_process)[0], col_slices, cross_list):
                    z = float(layers["z"][i])
                    self.screens.append(LayerScreen(
                        h=float(layers["h"][i]), z=z, res=res_min, pwv_rms=float(layers["pwv_rms"][i]),
                        angle=angle, vx=vx, vy=vy, tx_min=float(extrusion[0]), ty_min=float(cross[0, 0]),
                        nx=len(extrusion), ny=cols.stop - cols.start, process=process, ar_columns=cols,
                        ty_res=float(cross[1, 0] - cross[0, 0]),
                        beam_sigma=float(obs.instrument.dets.physical_fwhm(z).mean()) / 2.355,
                    ))
                continue

            if self.model == "3d":
                # one vertically correlated stack per process on the
                # finest layer resolution (the TPU's windowed, decimated
                # and static-hat sampler settings are not carried: the
                # port samples every layer with the exact bilinear gather)
                res = float(layers["res"][in_process].min())
                margin = 2 * res
                tx_min, tx_max = tx.min() - margin, tx.max() + margin
                ty_min, ty_max = ty.min() - margin, ty.max() + margin
                min_cells = _min_spectral_extent_cells(res, outer_scale)
                nx = good_fft_size(max(int(1.3 * ((tx_max - tx_min) / res + 2)) + 8, min_cells))
                ny = good_fft_size(max(int(1.3 * ((ty_max - ty_min) / res + 2)) + 8, min_cells))
                zs = layers["z"][in_process].astype(float)
                beam_sigmas = np.array([float(obs.instrument.dets.physical_fwhm(z).mean()) / 2.355 for z in zs])
                W, M_cos, M_sin, beam = layered_field_spectral_weights(
                    ny, nx, res, res, hs_all.astype(float), nu=nu, r0=outer_scale, beam_sigmas=beam_sigmas,
                )
                self.groups.append(ScreenGroup(
                    heights=hs_all.astype(float), zs=zs, pwv_rms=layers["pwv_rms"][in_process].astype(float),
                    angle=angle, vx=vx, vy=vy, res=res, tx_min=tx_min, ty_min=ty_min, nx=nx, ny=ny,
                    W=W, M_cos=M_cos, M_sin=M_sin, beam=beam,
                ))
                continue

            for i in np.where(in_process)[0]:
                h, z = float(layers["h"][i]), float(layers["z"][i])
                res = float(layers["res"][i])
                pwv_rms = float(layers["pwv_rms"][i])
                margin = 2 * res
                tx_min, tx_max = tx.min() - margin, tx.max() + margin
                ty_min, ty_max = ty.min() - margin, ty.max() + margin
                nx_needed = int((tx_max - tx_min) / res) + 2
                ny_needed = int((ty_max - ty_min) / res) + 2
                beam_sigma = float(obs.instrument.dets.physical_fwhm(z).mean()) / 2.355
                common = dict(h=h, z=z, pwv_rms=pwv_rms, angle=angle, vx=vx, vy=vy)

                if self.method == "ar":
                    # one process per slab on the footprint grid
                    process = AutoregressiveProcess(
                        cross_section=np.stack([ty_min + res * np.arange(ny_needed), np.full(ny_needed, h)], axis=-1),
                        extrusion=tx_min + res * np.arange(nx_needed),
                        callback_kwargs={"nu": nu, "r0": outer_scale},
                    )
                    self.screens.append(LayerScreen(
                        res=res, tx_min=tx_min, ty_min=ty_min, nx=nx_needed, ny=ny_needed, process=process,
                        ar_columns=slice(0, ny_needed), ty_res=res, beam_sigma=beam_sigma, **common,
                    ))
                    continue

                min_cells = _min_spectral_extent_cells(res, outer_scale)
                nx_fp = good_fft_size(max(int(1.3 * nx_needed) + 8, 32))
                ny_fp = good_fft_size(max(int(1.3 * ny_needed) + 8, 32))

                if min_cells > 2 * max(nx_fp, ny_fp):
                    # the footprint box is much smaller than the spectral
                    # extent: carry the spectrum as a fine/coarse pair
                    def pair_sizes(t):
                        ny_t, nx_t = max(ny_fp, t), max(nx_fp, t)
                        res_ct = min(ny_t, nx_t) * res / 8.0
                        cc = good_fft_size(int(min_cells * res / res_ct) + 2)
                        return ny_t, nx_t, res_ct, cc

                    cands = sorted({good_fft_size(t) for t in (min(nx_fp, ny_fp), 48, 64, 96, 128, 192, 256)})
                    ny_f, nx_f, res_c, cells_c = min(
                        (pair_sizes(t) for t in cands if t <= max(min_cells, 32)),
                        key=lambda s: s[0] * s[1] + s[3] ** 2,
                    )
                    L_min = min(nx_f, ny_f) * res
                    W_f, W_c = band_split_spectral_weights_2d(
                        ny_f, nx_f, res, cells_c, cells_c, res_c, 4 * np.pi / L_min,
                        nu=nu, r0=outer_scale, beam_sigma=beam_sigma,
                    )
                    win_x, win_y = window_bounds(h, res, nx_f, ny_f)
                    win_xc, win_yc = window_bounds(h, res_c, cells_c, cells_c)
                    self.screens.append(LayerScreen(
                        res=res, tx_min=tx_min, ty_min=ty_min, nx=nx_f, ny=ny_f, W=W_f,
                        win_x=win_x, win_y=win_y, band="fine", **common,
                    ))
                    Lc = cells_c * res_c
                    self.screens.append(LayerScreen(
                        res=res_c, tx_min=tx_min - (Lc - nx_f * res) / 2,
                        ty_min=ty_min - (Lc - ny_f * res) / 2, nx=cells_c, ny=cells_c, W=W_c,
                        win_x=win_xc, win_y=win_yc, band="coarse", **common,
                    ))
                    continue

                nx = good_fft_size(max(nx_fp, min_cells))
                ny = good_fft_size(max(ny_fp, min_cells))
                W = field_spectral_weights_2d(ny, nx, res, res, nu=nu, r0=outer_scale, beam_sigma=beam_sigma)
                win_x, win_y = window_bounds(h, res, nx, ny)
                self.screens.append(LayerScreen(
                    res=res, tx_min=tx_min, ty_min=ty_min, nx=nx, ny=ny, W=W,
                    win_x=win_x, win_y=win_y, **common,
                ))
        return self

    def simulate_pwv(self, instrument=None, generator=None, draws: dict = None, device=None):
        """The zenith-scaled pwv (n_det, n_coarse) in mm of one realization,
        on ``device``: the mean plus every screen's and layer's sample
        along the lines of sight at the coarse steps (``accumulate_pwv``,
        the program's own sampler). The draws come from ``generator``, or
        from one seeded with ``seed`` (a random seed without one); ``draws``
        optionally supplies "screens", "groups" and "ar" as
        ``TODProgram.fields`` takes them. ``instrument`` is taken for
        maria_tpu's signature: the detectors are the observation's. Sets
        ``zenith_scaled_pwv`` and ``det_el`` (n_det, n_coarse)."""
        from ..device import resolve_device
        from ..ops.program import ar_screen_values, line_of_sight
        from .sampling import accumulate_pwv

        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device)
            generator.manual_seed(int(self.seed) if self.seed is not None else int(np.random.randint(2**31)))
        draws = draws or {}
        f32 = dict(dtype=torch.float32, device=device)
        det_el, _, px, py = line_of_sight(
            torch.as_tensor(self.offsets, **f32), torch.as_tensor(np.asarray(self.boresight.az, np.float32), **f32),
            torch.as_tensor(np.asarray(self.boresight.el, np.float32), **f32),
        )
        t_rel = torch.as_tensor(np.asarray(self.boresight.t, np.float64) - self.t0, **f32)
        ar_values = ar_screen_values(self.screens, generator, draws.get("ar"), device)
        self.zenith_scaled_pwv = accumulate_pwv(
            self.weather.pwv, self.screens, px, py, t_rel, generator=generator, draws=draws.get("screens"),
            groups=self.groups, group_draws=draws.get("groups"), ar_values=ar_values,
        )
        self.det_el = det_el
        return self.zenith_scaled_pwv
