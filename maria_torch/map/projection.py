"""Flat-sky projected maps (maria_tpu/map/base.py and projection.py):
the input skies a simulation scans and the maps the mappers return.

Data and weight are float32 tensors of shape (stokes, nu, t, n_y, n_x).
Units convert through the calibration graph (``Map.to``, one call per
frequency channel). The maps that ``map.get`` and the mappers make live
on the host;
``smooth(fwhm, device=)`` computes on ``device`` (the card when there is
one) and its result stays there. ``sample`` (a bilinear or nearest-pixel
gather) and ``pixel_index`` run on the device of the offsets they are
given.
Angles are floats in radians (``center``, ``width``, ``height``,
``resolution``); the constructor takes degrees unless told otherwise.
Plotting, FITS/HDF files, resampling and the transfer function are not
ported (ROADMAP queue 1, item 12).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.interp import interp_bilinear_grid
from ..units import as_radians
from .base import Map, check_map_units

__all__ = ["ProjectionMap", "gaussian_beam_fft_filter", "STOKES_ORDER"]

STOKES_ORDER = "IQUV"


def gaussian_beam_fft_filter(shape, res_y: float, res_x: float, fwhm: float, dtype=torch.float32):
    """Fourier transfer function of a Gaussian beam of ``fwhm`` on a
    (n_y, n_x) grid, for the half spectrum of ``rfft2``; a host tensor."""
    sigma = fwhm / (2 * np.sqrt(2 * np.log(2)))
    ky = 2 * np.pi * np.fft.fftfreq(shape[0], d=res_y)
    kx = 2 * np.pi * np.fft.rfftfreq(shape[1], d=res_x)
    return torch.as_tensor(np.exp(-0.5 * sigma**2 * (ky[:, None] ** 2 + kx[None, :] ** 2)), dtype=dtype)


def _as_float32(x):
    """A float32 tensor of ``x``; a tensor stays on its device."""
    return x.to(torch.float32) if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x), dtype=torch.float32)


class ProjectionMap(Map):
    """A tangent-plane map around ``center`` in ``frame``. The third
    slice axis carries one label: time ``t`` (the default), redshift
    ``z`` or velocity ``v``."""

    def __init__(self, data, center=(0.0, 0.0), width=None, height=None, resolution=None,
                 frame: str = "ra/dec", stokes: str = None, nu=None, t=None, z=None, v=None,
                 units: str = "K_RJ", weight=None, degrees: bool = True):
        self.units = check_map_units(units)
        self.frame = frame

        # normalize to (stokes, nu, t, n_y, n_x): missing slice axes go
        # where the metadata says they belong
        data = _as_float32(data)
        given = {k: val for k, val in (("t", t), ("z", z), ("v", v)) if val is not None}
        if len(given) > 1:
            raise ValueError(f"Give at most one of t/z/v (got {sorted(given)}).")
        self.axis3_label = next(iter(given), "t")
        axis3 = given.get(self.axis3_label)
        if data.ndim > 5:
            raise ValueError(f"Map data has too many dims ({data.ndim}).")
        if data.ndim < 5:
            target = (
                len(stokes) if stokes else 1,
                len(np.atleast_1d(nu)) if nu is not None else 1,
                len(np.atleast_1d(axis3)) if axis3 is not None else 1,
                *data.shape[-2:],
            )
            if data.numel() == int(np.prod(target)):
                data = data.reshape(target)
            else:
                data = data.reshape((1,) * (5 - data.ndim) + tuple(data.shape))
        self.data = data

        self.stokes = stokes or STOKES_ORDER[: data.shape[0]]
        if len(self.stokes) != data.shape[0]:
            raise ValueError(f"Stokes '{self.stokes}' does not match data shape {tuple(data.shape)}.")
        self.nu = np.atleast_1d(np.asarray(nu if nu is not None else [150e9], dtype=float))
        if len(self.nu) != data.shape[1]:
            raise ValueError(f"nu axis ({len(self.nu)}) does not match data shape {tuple(data.shape)}.")
        self.t = np.atleast_1d(np.asarray(axis3 if axis3 is not None else [0.0], dtype=float))
        if len(self.t) != data.shape[2]:
            raise ValueError(f"{self.axis3_label} axis ({len(self.t)}) does not match data shape {tuple(data.shape)}.")
        self.weight = _as_float32(weight).reshape(data.shape) if weight is not None else torch.ones_like(data)

        n_eta, n_xi = data.shape[-2:]
        to_rad = np.pi / 180 if degrees else 1.0
        self.center = (float(center[0]) * to_rad, float(center[1]) * to_rad)
        if resolution is not None:
            res = float(resolution) * to_rad
            width, height = res * n_xi, res * n_eta
        elif width is not None:
            width = float(width) * to_rad
            height = float(height) * to_rad if height is not None else width * n_eta / n_xi
            res = width / n_xi
        else:
            raise ValueError("Supply either 'width' or 'resolution'.")
        self.width, self.height, self.resolution = width, height, res

        # pixel centres as tangent-plane offsets from the map centre
        self.x_side = (np.arange(n_xi) - (n_xi - 1) / 2) * res
        self.y_side = (np.arange(n_eta) - (n_eta - 1) / 2) * (height / n_eta)

    def _replace(self, **kwargs) -> "ProjectionMap":
        params = dict(
            data=self.data, center=np.degrees(self.center), width=np.degrees(self.width),
            height=np.degrees(self.height), frame=self.frame, stokes=self.stokes, nu=self.nu,
            units=self.units, weight=self.weight, degrees=True, **{self.axis3_label: self.t},
        )
        if any(k in kwargs for k in ("t", "z", "v")):
            params.pop(self.axis3_label, None)
        params.update(kwargs)
        return ProjectionMap(**params)

    # -- structure -----------------------------------------------------------------
    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def n_stokes(self) -> int:
        return len(self.stokes)

    @property
    def n_nu(self) -> int:
        return len(self.nu)

    @property
    def n_x(self) -> int:
        return self.data.shape[-1]

    @property
    def n_y(self) -> int:
        return self.data.shape[-2]

    @property
    def x_res(self) -> float:
        return float(self.resolution)

    @property
    def y_res(self) -> float:
        return float(self.height / self.n_y)

    @property
    def nu_bin_bounds(self):
        """(nu_min, nu_max) in Hz of every channel: the midpoints between
        adjacent nu; one channel takes every frequency."""
        if self.n_nu == 1:
            return [(0.0, np.inf)]
        edges = [0.0, *(0.5 * (self.nu[1:] + self.nu[:-1])), np.inf]
        return list(zip(edges[:-1], edges[1:]))

    @property
    def pixel_area(self) -> float:
        """The solid angle of a pixel in sr."""
        return float(self.resolution * (self.height / self.n_y))

    def _calibration_kwargs(self) -> dict:
        return {"pixel_area": self.pixel_area}

    # -- sampling --------------------------------------------------------------------
    def sample(self, dx, dy, stokes_weight=None, nu_index: int = 0, t_index: int = 0, bilinear: bool = True):
        """The map at tangent-plane offsets (dx, dy) from its centre
        (tensors; the result is on their device), Stokes-weighted:
        sum_s w_s map_s(dx, dy) with ``stokes_weight`` (n_det, n_stokes),
        Stokes I alone without it. Samples outside the map give 0."""
        out = 0.0
        for s in range(self.n_stokes):
            if stokes_weight is None:
                if s > 0:
                    continue
                w = 1.0
            else:
                w = stokes_weight[:, s][:, None]
            field = self.data[s, nu_index, t_index].to(dx.device)
            if bilinear:
                vals = interp_bilinear_grid(field, dx, dy, self.x_side, self.y_side)
            else:
                x0, y0 = float(self.x_side[0]), float(self.y_side[0])
                ix = torch.clamp(torch.round((dx - x0) / self.x_res).to(torch.int64), 0, self.n_x - 1)
                iy = torch.clamp(torch.round((dy - y0) / self.y_res).to(torch.int64), 0, self.n_y - 1)
                inside = (
                    (dx >= x0 - self.x_res / 2) & (dx <= float(self.x_side[-1]) + self.x_res / 2)
                    & (dy >= y0 - self.y_res / 2) & (dy <= float(self.y_side[-1]) + self.y_res / 2)
                )
                vals = torch.where(inside, field[iy, ix], torch.zeros_like(dx))
            out = out + w * vals
        return out

    def pixel_index(self, dx, dy):
        """(flat, inside): the flattened nearest-pixel index iy * n_x + ix
        of the offsets, clipped to the map, and whether each lies on it."""
        ix = torch.round((dx - float(self.x_side[0])) / self.x_res).to(torch.int32)
        iy = torch.round((dy - float(self.y_side[0])) / self.y_res).to(torch.int32)
        inside = (ix >= 0) & (ix < self.n_x) & (iy >= 0) & (iy < self.n_y)
        flat = torch.clamp(iy, 0, self.n_y - 1) * self.n_x + torch.clamp(ix, 0, self.n_x - 1)
        return flat, inside

    # -- image-space operations ------------------------------------------------------
    def smooth(self, fwhm, device=None) -> "ProjectionMap":
        """The map smoothed by a Gaussian beam of ``fwhm`` (radians, or an
        angle ``Quantity``), as
        one multiply in Fourier space, computed and kept on ``device``."""
        device = resolve_device(device)
        F = gaussian_beam_fft_filter((self.n_y, self.n_x), self.y_res, self.x_res, as_radians(fwhm)).to(device)
        flat = self.data.to(device).reshape(-1, self.n_y, self.n_x)
        smoothed = torch.fft.irfft2(torch.fft.rfft2(flat) * F, s=(self.n_y, self.n_x))
        return self._replace(data=smoothed.reshape(self.data.shape), weight=self.weight.to(device))

    def __repr__(self):
        axis3 = "" if self.axis3_label == "t" and len(self.t) == 1 else (
            f", {self.axis3_label}=[{self.t.min():.3g}..{self.t.max():.3g}] (n={len(self.t)})"
        )
        return (
            f"ProjectionMap(shape={self.shape}, stokes='{self.stokes}', "
            f"nu={[f'{n / 1e9:.0f} GHz' for n in self.nu]}{axis3}, units='{self.units}', "
            f"center=({np.degrees(self.center[0]):.2f}, {np.degrees(self.center[1]):.2f}) deg, "
            f"resolution={np.degrees(self.resolution):.3g} deg, frame='{self.frame}')"
        )
