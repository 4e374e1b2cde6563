"""Correlated atmospheric emission, host setup for the 2-D Fourier model
(maria_tpu/atmosphere/atmosphere.py, ``Atmosphere.initialize`` with
model="2d", method="fourier").

``initialize`` builds the layer table, the per-layer wind, the aligning
rotation and one Fourier screen (or a fine/coarse band pair) per layer;
the per-realization synthesis and line-of-sight sampling run on device
in ``TODProgram`` (``sampling.accumulate_pwv``).
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass

import numpy as np

from ..coords import offsets_to_phi_theta
from ..spectrum import AtmosphericSpectrum
from ..utils import principal_angle_2d
from ..weather import Weather
from .fourier import band_split_spectral_weights_2d, field_spectral_weights_2d, good_fft_size
from .layers import generate_layers

_MIN_EXTENT_R0_FACTOR = 4.0
_MAX_EXTENT_CELLS = 4096


def _min_spectral_extent_cells(res: float, r0: float) -> int:
    return int(min(_MIN_EXTENT_R0_FACTOR * r0 / max(res, 1e-6), _MAX_EXTENT_CELLS))


@dataclass
class LayerScreen:
    """Static geometry of one Fourier screen (host-built)."""

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
    W: np.ndarray  # (ny, nx//2+1) spectral weights
    ty_res: float = None
    win_x: int = None
    win_y: int = None
    band: str = "full"


class Atmosphere:
    def __init__(self, model: str = "2d", timestamp: float = None, region: str = "princeton",
                 altitude: float = None, weather: dict = {}, weather_quantiles: dict = {},
                 weather_source: str = "synthetic", spectrum_source: str = "synthetic/v1",
                 pwv_rms_frac: float = 0.03, max_height: float = 5e3, timestep: float = None,
                 method: str = "fourier", min_height: float = None, outer_scale: float = None):
        if model != "2d" or method != "fourier":
            raise NotImplementedError(
                f"atmosphere model '{model}', method '{method}': only the 2-D Fourier model is "
                "ported (ROADMAP queue 1, item 7: 3-D layered screens and AR extrusion)"
            )
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

    def initialize(self, obs):
        self.layers = generate_layers(
            instrument=obs.instrument, boresight=obs.boresight, weather=self.weather,
            site=obs.site, min_height=self.min_height, pwv_rms_frac=self.pwv_rms_frac,
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
            nu = 5 / 6

            def window_bounds(h, res, nx, ny):
                rel_x = h * (hull_px - bs_px[None])
                rel_y = h * (hull_py - bs_py[None])
                span_x = float(np.abs(ca * rel_x + sa * rel_y).max())
                span_y = float(np.abs(-sa * rel_x + ca * rel_y).max())
                win_x = min(nx, int(-(-(2 * span_x / res + 6) // 8) * 8))
                win_y = min(ny, int(-(-(2 * span_y / res + 6) // 8) * 8))
                return win_x, win_y

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

                min_cells = _min_spectral_extent_cells(res, outer_scale)
                nx_fp = good_fft_size(max(int(1.3 * nx_needed) + 8, 32))
                ny_fp = good_fft_size(max(int(1.3 * ny_needed) + 8, 32))
                common = dict(h=h, z=z, pwv_rms=pwv_rms, angle=angle, vx=vx, vy=vy)

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
