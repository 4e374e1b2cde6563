"""Time-ordered data (maria_tpu/tod/tod.py): fields are (n_det, n_t)
float32 tensors on the simulation's device; the pointing stays
factorized as the boresight track times static detector offsets."""

from __future__ import annotations

import numpy as np
import torch

from ..calibration import conversion_factor
from ..coords import offsets_to_phi_theta

__all__ = ["TOD", "Pointing"]


class Pointing:
    """Boresight az/el track + detector offsets (az/el frame)."""

    def __init__(self, boresight, offsets):
        self.boresight = boresight
        self.offsets = np.asarray(offsets)

    @property
    def t(self):
        return self.boresight.t

    def det_azel(self, device=None, idx=None):
        """(az, el) float32 tensors of shape (n_det, n_t)."""
        offsets = self.offsets if idx is None else self.offsets[idx]
        f32 = dict(dtype=torch.float32, device=device)
        pt = offsets_to_phi_theta(
            torch.as_tensor(np.asarray(offsets[:, None, :], dtype=np.float32), **f32),
            torch.as_tensor(np.asarray(self.boresight.az, dtype=np.float32), **f32),
            torch.as_tensor(np.asarray(self.boresight.el, dtype=np.float32), **f32),
        )
        return pt[..., 0], pt[..., 1]

    def det_radec(self):
        raise NotImplementedError(
            "ra/dec pointing needs the ephemeris and the frame-rotation angle q (ROADMAP queue 1, item 13)"
        )


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
            if not self.metadata.get("atmosphere"):
                raise NotImplementedError("calibration without an atmosphere (ROADMAP queue 1, item 13)")
            _, el = self.pointing.det_azel(device=self.device, idx=idx)
            factor = conversion_factor(
                self.units, units, band,
                polarized=bool(~np.isnan(self.dets.gamma[idx]).all()),
                spectrum=self.spectrum,
                zenith_pwv=self.metadata["pwv"],
                base_temperature=self.metadata["base_temperature"],
                elevation=torch.clamp(el, max=float(np.pi / 2)),
            )
            rows = torch.as_tensor(idx, device=self.device)
            for field in self.fields:
                new_data[field][rows] = self.data[field][rows] * factor
        return TOD(data=new_data, pointing=self.pointing, weight=self.weight, units=units,
                   dets=self.dets, metadata=self.metadata, spectrum=self._spectrum)

    def __repr__(self):
        return f"TOD(shape={self.shape}, fields={self.fields}, units={self.units}, device={self.device})"
