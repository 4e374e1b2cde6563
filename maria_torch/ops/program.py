"""The TOD-synthesis program (maria_tpu/ops/program.py): a static scene
(pointing, screens, band tables, noise spec) and a function that turns
one realization's draws into per-field detector loadings.

The port keeps the contract of ``TODProgram._loadings`` up to the noise
stage and drops the TPU devices around it (jit-argument tables, the
no-gather band slicing, detector padding, the noise-matmul branch).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..atmosphere.sampling import accumulate_pwv
from ..coords import offsets_to_phi_theta
from ..device import resolve_device
from ..noise import generate_noise_with_knee
from .interp import TableEval, upsample_time, upsample_time_phases

__all__ = ["BandBlock", "TODProgram", "build_tod_program"]


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

    def __post_init__(self):
        if self.NEP_per_loading:
            raise NotImplementedError(
                "NEP_per_loading (ROADMAP queue 1, item 13: the photon-loading noise term)"
            )


@dataclass
class TODProgram:
    """Static scene -> per-realization loadings."""

    screens: list  # LayerScreen list (Fourier screens)
    mean_pwv: float
    t_coarse: np.ndarray  # relative seconds (n_tc,)
    t_fine: np.ndarray  # relative seconds (n_t,)
    offsets: np.ndarray  # (n_det, 2)
    bs_az_coarse: np.ndarray
    bs_el_coarse: np.ndarray
    mueller_I: np.ndarray  # (n_det,)
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

    @property
    def n_det(self) -> int:
        return len(self.offsets)

    @property
    def n_t(self) -> int:
        return len(self.t_fine)

    def _tensors(self, device):
        """The static tables as tensors on ``device`` (built once per device)."""
        key = str(device)
        if key not in self._device_cache:
            f32 = dict(dtype=torch.float32, device=device)
            self._device_cache[key] = {
                "offsets": torch.tensor(np.asarray(self.offsets, dtype=np.float32), **f32),
                "bs_az": torch.tensor(np.asarray(self.bs_az_coarse, dtype=np.float32), **f32),
                "bs_el": torch.tensor(np.asarray(self.bs_el_coarse, dtype=np.float32), **f32),
                "t_c": torch.tensor(np.asarray(self.t_coarse, dtype=np.float32), **f32),
                "mueller_I": torch.tensor(np.asarray(self.mueller_I, dtype=np.float32), **f32),
                "W": [torch.tensor(s.W, **f32) for s in self.screens],
                "power": [TableEval(b.pwv_side, b.el_side, b.power_table, device=device) for b in self.bands],
                "det_index": [torch.tensor(b.det_index, dtype=torch.int64, device=device) for b in self.bands],
                "basis": [
                    None if b.noise_basis is None else torch.tensor(np.asarray(b.noise_basis), **f32)
                    for b in self.bands
                ],
            }
        return self._device_cache[key]

    def _upsample(self, values, kind):
        if self.upsample_ratio is not None:
            return upsample_time_phases(values, self.upsample_ratio, self.n_t, kind=kind)
        return upsample_time(values, self.t_coarse, self.t_fine, kind=kind)

    def fields(self, generator=None, draws: dict = None, device=None, upto: str = None):
        """One realization: ({field: (n_det, n_t) pW}, pwv_fine).

        Gains are not applied here (see ``draw_gains`` and
        ``Simulation.run_obs``). ``draws`` optionally supplies the
        realization's unit normals: "screens" (one (ny, nx//2+1, 2) per
        screen), "noise" and "modes" (one per band, see
        ``generate_noise_with_knee``). ``upto`` stops early for stage
        tests: "pwv" -> {"pwv": coarse pwv}, "atmosphere" -> the
        upsampled atmospheric loading only.
        """
        device = resolve_device(device)
        draws = draws or {}
        tabs = self._tensors(device)

        # detector az/el at the coarse timestep and the unit-height
        # line-of-sight projection (x=E, y=N)
        pt = offsets_to_phi_theta(tabs["offsets"][:, None, :], tabs["bs_az"], tabs["bs_el"])
        det_az, det_el = pt[..., 0], pt[..., 1]
        el_clip = torch.clamp(det_el, float(np.float32(np.radians(5.0))), float(np.float32(np.pi / 2)))
        cot_el = 1 / torch.tan(el_clip)
        px = torch.sin(det_az) * cot_el
        py = torch.cos(det_az) * cot_el

        pwv = accumulate_pwv(
            self.mean_pwv, self.screens, px, py, tabs["t_c"], W=tabs["W"],
            generator=generator, draws=draws.get("screens"),
        )
        if upto == "pwv":
            return {"pwv": pwv}

        loading_c = torch.empty_like(pwv)
        for i in range(len(self.bands)):
            idx = tabs["det_index"][i]
            p = tabs["power"][i](pwv[idx], el_clip[idx])
            loading_c[idx] = tabs["mueller_I"][idx, None] * p
        fields = {"atmosphere": self._upsample(loading_c, "cubic")}
        if upto == "atmosphere":
            return fields

        if self.with_noise:
            noise = torch.empty((self.n_det, self.n_t), dtype=torch.float32, device=device)
            for i, band in enumerate(self.bands):
                unscaled = generate_noise_with_knee(
                    (len(band.det_index), self.n_t), sample_rate=self.sample_rate, knee=band.knee,
                    basis=tabs["basis"][i], corr_prop=band.corr_prop, generator=generator,
                    white=None if "noise" not in draws else draws["noise"][i],
                    mode_white=None if "modes" not in draws else draws["modes"][i],
                    device=device,
                )
                noise[tabs["det_index"][i]] = float(np.float32(1e12 * band.NEP)) * unscaled
            fields["noise"] = noise
        return fields, self._upsample(pwv, "linear")

    def draw_gains(self, generator=None, draw=None, device=None):
        """(n_det, 1) multiplicative gain errors exp(gain_error * N(0, 1)),
        or None when the program carries none; ``draw`` optionally
        supplies the (n_det,) normals."""
        if self.gain_error is None:
            return None
        device = resolve_device(device)
        if draw is None:
            draw = torch.randn((self.n_det,), generator=generator, device=device, dtype=torch.float32)
        elif tuple(draw.shape) != (self.n_det,):
            raise ValueError(f"gain draw must have shape ({self.n_det},), got {tuple(draw.shape)}")
        g = torch.as_tensor(np.asarray(self.gain_error, dtype=np.float32), device=device)
        return torch.exp(g * draw.to(device=device, dtype=torch.float32))[:, None]


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


def build_tod_program(obs, with_noise: bool = True, noise_kwargs: dict = {}) -> TODProgram:
    """Assemble the program from an initialized Observation."""
    from ..utils import compute_diameter, generate_spatial_basis

    atm = obs.atmosphere
    T_base = float(atm.weather.temperature[0])
    t0 = float(obs.t[0])

    # reachable (pwv, el) window of the band tables: weather mean +- 8
    # sigma of the summed screen rms; the boresight elevations +- the
    # array extent
    sigma_pwv = float(np.sqrt(sum(float(s.pwv_rms) ** 2 for s in atm.screens)))
    mean_pwv = float(atm.weather.pwv)
    pwv_lo = max(0.0, mean_pwv - 8 * sigma_pwv)
    pwv_hi = mean_pwv + 8 * sigma_pwv
    bs_el = np.asarray(atm.boresight.el, dtype=np.float64)
    off_max = float(np.abs(np.asarray(obs.offsets)).max()) if len(obs.offsets) else 0.0
    el_lo = max(np.radians(5.0), float(bs_el.min()) - 2 * off_max)
    el_hi = min(np.pi / 2, float(bs_el.max()) + 2 * off_max)

    bands = []
    dets = obs.instrument.dets
    for band in dets.bands:
        det_index = np.where(dets.band_name == band.name)[0]
        pwv_side, el_side, table = band.atmosphere_power_table(atm.spectrum, T_base)
        # float32 tables, as the JAX package stores them
        pwv_side, el_side, table = (np.asarray(a, dtype=np.float32) for a in (pwv_side, el_side, table))
        xs, ys, tab = _crop_table(pwv_side, el_side, table, pwv_lo, pwv_hi, el_lo, el_hi)

        basis, corr_prop = None, 0.0
        cp = noise_kwargs.get("correlated_noise_proportion", 0.0)
        band_offsets = dets.offsets[det_index]
        fov = compute_diameter(band_offsets)
        if with_noise and cp > 0 and fov > 0 and len(det_index) > 16:
            basis = generate_spatial_basis(
                offsets=band_offsets, k=5, n_side=16,
                scale=fov * noise_kwargs.get("correlated_noise_spatial_scale", 1.0),
            )
            corr_prop = cp
        bands.append(BandBlock(
            name=band.name, det_index=det_index, pwv_side=xs, el_side=ys, power_table=tab,
            NEP=band.NEP, knee=band.knee, noise_basis=basis, corr_prop=corr_prop,
            NEP_per_loading=band.NEP_per_loading,
        ))

    return TODProgram(
        screens=list(atm.screens),
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
