"""Time-ordered data (maria_tpu/tod/tod.py): fields are (n_det, n_t)
float32 tensors on the simulation's device; the pointing stays
factorized as the boresight track times static detector offsets.
``TOD.to`` converts between the quantities of ``VALID_TOD_QUANTITIES``
through the calibration graph, on the TOD's device. ``TOD.process``
runs the ops of ``tod.processing``."""

from __future__ import annotations

import numpy as np
import torch

from ..coords import offsets_to_phi_theta
from ..device import resolve_device
from ..units import parse_units

__all__ = ["TOD", "Pointing", "VALID_TOD_QUANTITIES"]

VALID_TOD_QUANTITIES = ["power", "rayleigh_jeans_temperature", "cmb_temperature_anisotropy", "brightness_temperature"]


def _f32(x, device):
    return torch.as_tensor(np.asarray(x, dtype=np.float32), dtype=torch.float32, device=resolve_device(device))


class Pointing:
    """Factorized pointing: the boresight track, the detector offsets
    (az/el frame) and the az/el -> ra/dec frame-rotation angle q(t),
    which only the ra/dec pointing needs."""

    def __init__(self, boresight, offsets, q=None):
        self.boresight = boresight
        self.offsets = np.asarray(offsets)
        self.q = None if q is None else np.asarray(q)

    @property
    def t(self):
        return self.boresight.t

    @property
    def shape(self):
        return (len(self.offsets), len(self.t))

    def det_azel(self, device=None, idx=None):
        """(az, el) float32 tensors of shape (n_det, n_t) on ``device``,
        of the detectors ``idx`` (all by default)."""
        offsets = self.offsets if idx is None else self.offsets[idx]
        pt = offsets_to_phi_theta(
            _f32(offsets[:, None, :], device), _f32(self.boresight.az, device), _f32(self.boresight.el, device)
        )
        return pt[..., 0], pt[..., 1]

    def offsets_radec(self, device=None, idx=None):
        """Detector offsets in the ra/dec frame, R(q(t)) @ offsets, a
        float32 tensor (n_det, n_t, 2) built on ``device`` from the host's
        float64 q."""
        if self.q is None:
            raise ValueError("this Pointing was made without the frame-rotation angle q")
        offsets = _f32(self.offsets if idx is None else self.offsets[idx], device)
        c, s = _f32(np.cos(self.q), device), _f32(np.sin(self.q), device)
        x, y = offsets[:, None, 0], offsets[:, None, 1]
        return torch.stack([c * x - s * y, s * x + c * y], dim=-1)

    def det_radec(self, device=None, idx=None):
        """(ra, dec) float32 tensors of shape (n_det, n_t), as ``det_azel``."""
        pt = offsets_to_phi_theta(
            self.offsets_radec(device=device, idx=idx), _f32(self.boresight.ra, device),
            _f32(self.boresight.dec, device),
        )
        return pt[..., 0], pt[..., 1]


def interp(x, xp, fp):
    """``jnp.interp``'s piecewise-linear interpolation of the points (xp,
    fp), 1-D tensors with xp increasing, at the tensor x: the ends held
    beyond the table."""
    n = len(xp)
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, n - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    dx = xp[i] - x0
    flat = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(flat, f0, f0 + (x - x0) / torch.where(flat, torch.ones_like(dx), dx) * (fp[i] - f0))
    return torch.where(x < xp[0], fp[0], torch.where(x > xp[-1], fp[-1], f))


def _table_convert(cal, d):
    """A non-linear elementwise chain on the field ``d`` (a float32
    tensor): evaluated on the host in float64 at 1,025 points over the
    field's range widened by 1% a side, then interpolated on the device in
    coordinates offset by the table's first point, which keep float32's
    precision (maria_tpu/tod/tod.py:280-299)."""
    lo, hi = float(d.min()), float(d.max())
    span = max(hi - lo, 1e-9 * max(abs(hi), abs(lo), 1.0))
    grid = np.linspace(lo - 0.01 * span, hi + 0.01 * span, 1025)
    y_grid = np.asarray(cal(grid), dtype=float)
    y0 = y_grid[0]
    f32 = dict(dtype=torch.float32, device=d.device)
    out = interp(d - float(np.float32(grid[0])), torch.as_tensor(grid - grid[0], **f32),
                 torch.as_tensor(y_grid - y0, **f32))
    return out + float(np.float32(y0))


class TOD:
    def __init__(self, data: dict, pointing: Pointing = None, weight=None, units: str = "K_RJ",
                 dets=None, metadata: dict = {}, spectrum=None):
        self.pointing = pointing
        self._spectrum = spectrum
        self.dets = dets
        self.units = units
        self.metadata = dict(metadata)
        self.data = {k: v.to(torch.float32) for k, v in sorted(data.items())}
        first = self.data[self.fields[0]]
        self.weight = weight if weight is not None else torch.ones_like(first)

    @property
    def fields(self):
        return sorted(self.data)

    @property
    def device(self):
        return self.data[self.fields[0]].device

    @property
    def signal(self):
        total = 0
        for field in self.fields:
            total = total + self.data[field]
        return total

    @property
    def shape(self):
        return tuple(self.data[self.fields[0]].shape)

    @property
    def time(self):
        return self.pointing.t

    @property
    def fs(self) -> float:
        """The sample rate in Hz."""
        return float(1 / np.mean(np.diff(self.time)))

    @property
    def el(self):
        """The detectors' elevation (n_det, n_t), a float32 tensor on the TOD's device."""
        return self.pointing.det_azel(device=self.device)[1]

    @property
    def boresight(self):
        return self.pointing.boresight

    @property
    def spectrum(self):
        """The atmospheric spectrum the TOD was simulated with (loaded
        for its region when the TOD was made without one)."""
        if self._spectrum is None and self.metadata.get("atmosphere"):
            from ..spectrum import AtmosphericSpectrum

            self._spectrum = AtmosphericSpectrum(self.metadata["region"])
        return self._spectrum

    def calibration_kwargs(self, band, idx=None) -> dict:
        """The calibration keywords of the band's detectors ``idx``: the
        polarized factor (maria_tpu's: the band counts as polarized when
        any of its detectors is, ROADMAP queue 3, hazard 8) and, with an
        atmosphere, the spectrum, the observation's pwv and base
        temperature and the detectors' elevations, a tensor on the TOD's
        device."""
        if idx is None:
            idx = np.where(self.dets.band_name == band.name)[0]
        kwargs = {"polarized": bool(~np.isnan(self.dets.gamma[idx]).all()), "spectrum": None}
        if self.metadata.get("atmosphere"):
            _, el = self.pointing.det_azel(device=self.device, idx=idx)
            kwargs.update(spectrum=self.spectrum, zenith_pwv=self.metadata["pwv"],
                          base_temperature=self.metadata["base_temperature"],
                          elevation=torch.clamp(el, max=float(np.pi / 2)))
        return kwargs

    def to(self, units: str) -> "TOD":
        """The TOD in ``units``, band by band through the calibration graph.
        A linear chain is one factor a sample (a tensor of the band's
        elevations with an atmosphere), computed on the TOD's device. A
        non-linear chain with an atmosphere is evaluated on the device
        sample by sample (or raises, as maria_tpu's chain raises); in a
        vacuum it is maria_tpu's 1,025-point host table over the field's
        range, interpolated on the device."""
        if units == self.units:
            return self
        u = parse_units(units)
        if u.quantity not in VALID_TOD_QUANTITIES:
            raise ValueError(f"Cannot convert TOD to units '{units}' (quantity '{u.quantity}').")
        new_data = {k: v.clone() for k, v in self.data.items()}
        for band in self.dets.bands:
            idx = np.where(self.dets.band_name == band.name)[0]
            if len(idx) == 0:
                continue
            kwargs = self.calibration_kwargs(band, idx)
            cal = band.cal(f"{self.units} -> {units}", **kwargs)
            rows = torch.as_tensor(idx, device=self.device)
            if cal.linear():
                factor = cal(1.0)
                factor = factor if isinstance(factor, torch.Tensor) else float(factor)
                for field in self.fields:
                    new_data[field][rows] = self.data[field][rows] * factor
            elif kwargs["spectrum"] is not None:
                for field in self.fields:
                    new_data[field][rows] = cal(self.data[field][rows]).to(torch.float32)
            else:
                for field in self.fields:
                    new_data[field][rows] = _table_convert(cal, self.data[field][rows])
        return TOD(data=new_data, pointing=self.pointing, weight=self.weight, units=units,
                   dets=self.dets, metadata=self.metadata, spectrum=self._spectrum)

    def process(self, **config) -> "TOD":
        """The TOD processed by ``tod.processing.process_tod``: one "signal" field."""
        from .processing import process_tod

        return process_tod(self, **config)

    def __repr__(self):
        return f"TOD(shape={self.shape}, fields={self.fields}, units={self.units}, device={self.device})"
