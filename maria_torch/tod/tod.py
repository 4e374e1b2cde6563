"""Time-ordered data (maria_tpu/tod/tod.py): fields are (n_det, n_t)
float32 tensors on the simulation's device; the pointing stays
factorized as the boresight track times static detector offsets.
``TOD.process`` runs the ops of ``tod.processing``."""

from __future__ import annotations

import numpy as np
import torch

from ..calibration import conversion_factor
from ..coords import offsets_to_phi_theta
from ..device import resolve_device

__all__ = ["TOD", "Pointing"]


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

    def to(self, units: str) -> "TOD":
        if units == self.units:
            return self
        new_data = {k: v.clone() for k, v in self.data.items()}
        for band in self.dets.bands:
            idx = np.where(self.dets.band_name == band.name)[0]
            if len(idx) == 0:
                continue
            kwargs = {}
            if self.metadata.get("atmosphere"):
                _, el = self.pointing.det_azel(device=self.device, idx=idx)
                kwargs = dict(spectrum=self.spectrum, zenith_pwv=self.metadata["pwv"],
                              base_temperature=self.metadata["base_temperature"],
                              elevation=torch.clamp(el, max=float(np.pi / 2)))
            factor = conversion_factor(
                self.units, units, band, polarized=bool(~np.isnan(self.dets.gamma[idx]).all()), **kwargs
            )
            rows = torch.as_tensor(idx, device=self.device)
            for field in self.fields:
                new_data[field][rows] = self.data[field][rows] * factor
        return TOD(data=new_data, pointing=self.pointing, weight=self.weight, units=units,
                   dets=self.dets, metadata=self.metadata, spectrum=self._spectrum)

    def process(self, **config) -> "TOD":
        """The TOD processed by ``tod.processing.process_tod``: one "signal" field."""
        from .processing import process_tod

        return process_tod(self, **config)

    def __repr__(self):
        return f"TOD(shape={self.shape}, fields={self.fields}, units={self.units}, device={self.device})"
