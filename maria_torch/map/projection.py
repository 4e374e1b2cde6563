"""Flat-sky projected maps (maria_tpu/map/base.py and projection.py):
the input skies a simulation scans and the maps the mappers return.

Data and weight are float32 tensors of shape (stokes, nu, t, n_y, n_x).
Units convert through the calibration graph (``Map.to``, one call per
frequency channel). The maps that ``map.get`` and the mappers make live
on the host;
``smooth(fwhm, device=)`` computes on ``device`` (the card when there is
one) and its result stays there. ``sample`` (a bilinear or nearest-pixel
gather) and ``pixel_index`` run on the device of the offsets they are
given; ``recenter``, ``resample`` and ``sampled_onto`` gather on the
map's device (``sampled_onto`` on the one it is given), ``zero_pad``,
``trim`` and ``reduce`` stay there too.
``width``, ``height``, ``resolution``, ``xi_res`` and ``eta_res`` are
angle Quantities, as maria_tpu's are (``m.resolution.arcmin``); ``x_res``
and ``y_res`` are floats in radians. The constructor takes degrees unless
told otherwise. ``to_fits``, ``to_hdf`` (h5py) and ``plot`` (matplotlib)
write and draw on the host; ``transfer_function`` compares the map with
the sky it was made from (``map.transfer``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.interp import interp_bilinear_grid
from ..units import Quantity, as_radians
from .base import STOKES_ORDER, Map

__all__ = ["ProjectionMap", "gaussian_beam_fft_filter", "STOKES_ORDER"]


def gaussian_beam_fft_filter(shape, res_y: float, res_x: float, fwhm: float, dtype=torch.float32):
    """Fourier transfer function of a Gaussian beam of ``fwhm`` on a
    (n_y, n_x) grid, for the half spectrum of ``rfft2``; a host tensor."""
    sigma = fwhm / (2 * np.sqrt(2 * np.log(2)))
    ky = 2 * np.pi * np.fft.fftfreq(shape[0], d=res_y)
    kx = 2 * np.pi * np.fft.rfftfreq(shape[1], d=res_x)
    return torch.as_tensor(np.exp(-0.5 * sigma**2 * (ky[:, None] ** 2 + kx[None, :] ** 2)), dtype=dtype)


class ProjectionMap(Map):
    """A tangent-plane map around ``center`` in ``frame``. The third
    slice axis carries one label: time ``t`` (the default), redshift
    ``z`` or velocity ``v``."""

    map_dims = ("eta", "xi")

    def __init__(self, data, center=(0.0, 0.0), width=None, height=None, resolution=None,
                 frame: str = "ra/dec", stokes: str = None, nu=None, t=None, z=None, v=None,
                 units: str = "K_RJ", weight=None, dtype=torch.float32, degrees: bool = True):
        super().__init__(data, stokes=stokes, nu=nu, t=t, z=z, v=v, units=units, weight=weight, dtype=dtype)
        self.frame = frame
        data = self.data
        if self.weight is None:
            self.weight = torch.ones_like(data)

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
        self._width, self._height, self._res = width, height, res

        # pixel centres as tangent-plane offsets from the map centre
        self.x_side = (np.arange(n_xi) - (n_xi - 1) / 2) * res
        self.y_side = (np.arange(n_eta) - (n_eta - 1) / 2) * (height / n_eta)

    def _replace(self, **kwargs) -> "ProjectionMap":
        params = dict(
            data=self.data, center=np.degrees(self.center), width=np.degrees(self._width),
            height=np.degrees(self._height), frame=self.frame, stokes=self.stokes, nu=self.nu,
            units=self.units, weight=self.weight, degrees=True, **{self.axis3_label: self.t},
        )
        if any(k in kwargs for k in ("t", "z", "v")):
            params.pop(self.axis3_label, None)
        params.update(kwargs)
        return ProjectionMap(**params)

    def __getitem__(self, key) -> "ProjectionMap":
        """The map cut along its leading (stokes, nu, t) dims, every axis
        kept: ``m[:, 0]`` a frequency channel, ``m[:, :, -1]`` a time
        frame. The map dims stay whole: ``trim`` and ``reduce`` crop."""
        key = key if isinstance(key, tuple) else (key,)
        if len(key) > 5:
            raise IndexError(f"Too many indices for a 5-D map: {key}.")
        full = list(key) + [slice(None)] * (5 - len(key))
        if full[3] != slice(None) or full[4] != slice(None):
            raise NotImplementedError("Use trim/reduce to crop map dims.")
        norm = []
        for ax, k in enumerate(full[:3]):
            if isinstance(k, (int, np.integer)):
                k = int(k) % self.data.shape[ax]
                k = slice(k, k + 1)
            norm.append(k)
        sl = tuple(norm)
        return self._replace(data=self.data[sl], weight=self.weight[sl], stokes=self.stokes[norm[0]],
                             nu=self.nu[norm[1]], **{self.axis3_label: self.t[norm[2]]})

    # -- structure -----------------------------------------------------------------
    @property
    def n_x(self) -> int:
        return self.data.shape[-1]

    @property
    def n_y(self) -> int:
        return self.data.shape[-2]

    @property
    def width(self) -> Quantity:
        return Quantity(self._width, "rad")

    @property
    def height(self) -> Quantity:
        return Quantity(self._height, "rad")

    @property
    def resolution(self) -> Quantity:
        return Quantity(self._res, "rad")

    @property
    def xi_res(self) -> Quantity:
        return Quantity(self._res, "rad")

    @property
    def eta_res(self) -> Quantity:
        return Quantity(self._height / self.n_y, "rad")

    @property
    def x_res(self) -> float:
        return float(self._res)

    @property
    def y_res(self) -> float:
        return float(self._height / self.n_y)

    @property
    def pixel_area(self) -> float:
        """The solid angle of a pixel in sr."""
        return float(self._res * (self._height / self.n_y))

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

    def _geometry(self, **kwargs) -> dict:
        """The constructor keywords of a map of this one's slice dims,
        frame and units (degrees), updated by ``kwargs``."""
        params = dict(center=np.degrees(self.center), frame=self.frame, stokes=self.stokes, nu=self.nu,
                      units=self.units, degrees=True, **{self.axis3_label: self.t})
        params.update(kwargs)
        return params

    def _gather(self, cube, dx, dy):
        """Every (stokes, nu, t) plane of ``cube`` sampled bilinearly at
        the float32 offset tensors (dx, dy) from this map's centre, on
        their device."""
        flat = cube.to(dx.device).reshape(-1, self.n_y, self.n_x)
        out = torch.stack([interp_bilinear_grid(f, dx, dy, self.x_side, self.y_side) for f in flat])
        return out.reshape(*cube.shape[:3], *dx.shape)

    def zero_pad(self, factor: float = 1.5) -> "ProjectionMap":
        """The map centred in a grid ``factor`` times as wide, zeros
        around it, at the same resolution (weights of one)."""
        new_ny, new_nx = int(self.n_y * factor), int(self.n_x * factor)
        pad_y, pad_x = (new_ny - self.n_y) // 2, (new_nx - self.n_x) // 2
        padded = torch.nn.functional.pad(
            self.data, (pad_x, new_nx - self.n_x - pad_x, pad_y, new_ny - self.n_y - pad_y))
        return ProjectionMap(data=padded, **self._geometry(resolution=np.degrees(self._res)))

    def recenter(self, center, degrees: bool = True) -> "ProjectionMap":
        """The map resampled onto the same grid around ``center``: each new
        pixel's position in this map's offsets on the host in float64, the
        bilinear gather on the map's device."""
        from ..coords import offsets_to_phi_theta, phi_theta_to_offsets

        new_center = np.radians(np.asarray(center, dtype=float)) if degrees else np.asarray(center, dtype=float)
        X, Y = np.meshgrid(self.x_side, self.y_side)
        pt = offsets_to_phi_theta(np.stack([X, Y], axis=-1), new_center[0], new_center[1])
        old = np.asarray(phi_theta_to_offsets(pt, self.center[0], self.center[1]))
        dx, dy = (torch.as_tensor(old[..., i], dtype=torch.float32, device=self.data.device) for i in (0, 1))
        return ProjectionMap(data=self._gather(self.data, dx, dy), weight=self._gather(self.weight, dx, dy),
                             **self._geometry(center=np.degrees(new_center), resolution=np.degrees(self._res)))

    def trim(self) -> "ProjectionMap":
        """The map cropped to the bounding box of its nonzero weight."""
        w = self.weight.sum(dim=(0, 1, 2))
        rows = torch.nonzero(w.sum(dim=1) > 0).reshape(-1).tolist()
        cols = torch.nonzero(w.sum(dim=0) > 0).reshape(-1).tolist()
        if not rows:
            return self
        sl = (..., slice(rows[0], rows[-1] + 1), slice(cols[0], cols[-1] + 1))
        return ProjectionMap(data=self.data[sl], weight=self.weight[sl],
                             **self._geometry(resolution=np.degrees(self._res)))

    def reduce(self, factor: int) -> "ProjectionMap":
        """The map averaged over blocks of ``factor`` x ``factor`` pixels
        (the edge beyond a whole block dropped; weights of one)."""
        ny, nx = (self.n_y // factor) * factor, (self.n_x // factor) * factor
        d = self.data[..., :ny, :nx].reshape(*self.data.shape[:3], ny // factor, factor, nx // factor, factor)
        return ProjectionMap(data=d.mean(dim=(-3, -1)), **self._geometry(resolution=np.degrees(self._res * factor)))

    def resample(self, resolution=None, shape=None) -> "ProjectionMap":
        """The map resampled bilinearly onto a grid of the same extent with
        pixels ``resolution`` (radians) wide, or of ``shape`` (n_y, n_x)."""
        if resolution is not None:
            res = as_radians(resolution)
            nx, ny = int(self._width / res), int(self._height / res)
        else:
            ny, nx = shape
        new_x = (np.arange(nx) - (nx - 1) / 2) * self._width / nx
        new_y = (np.arange(ny) - (ny - 1) / 2) * self._height / ny
        X, Y = np.meshgrid(new_x, new_y)
        dx, dy = (torch.as_tensor(a, dtype=torch.float32, device=self.data.device) for a in (X, Y))
        return ProjectionMap(data=self._gather(self.data, dx, dy),
                             **self._geometry(width=np.degrees(self._width), height=np.degrees(self._height)))

    def sampled_onto(self, other: "ProjectionMap", device=None) -> torch.Tensor:
        """This map sampled bilinearly at ``other``'s pixel centres, a
        float32 tensor (n_stokes, n_nu, n_t, other.n_y, other.n_x) on
        ``device`` (this map's device by default). The centres become
        offsets from this map's centre on the host in float64 (through
        the sphere where the centres differ), then float32."""
        from ..coords import offsets_to_phi_theta, phi_theta_to_offsets

        X, Y = np.meshgrid(other.x_side, other.y_side)
        pts = np.stack([X, Y], axis=-1)
        if not np.allclose(self.center, other.center):
            pt = offsets_to_phi_theta(pts, other.center[0], other.center[1])
            pts = phi_theta_to_offsets(pt, self.center[0], self.center[1])
        device = self.data.device if device is None else torch.device(device)
        dx, dy = (torch.as_tensor(np.asarray(pts[..., i], dtype=np.float32), device=device) for i in (0, 1))
        return self._gather(self.data, dx, dy)

    # -- files and plots -------------------------------------------------------------
    def to_hdf(self, path: str):
        """The map as HDF5 in maria_tpu's layout (needs h5py)."""
        import h5py

        with h5py.File(path, "w") as f:
            f.create_dataset("data", data=self.data.detach().cpu().numpy())
            f.create_dataset("weight", data=self.weight.detach().cpu().numpy())
            f.attrs["stokes"] = self.stokes
            f.attrs["units"] = self.units
            f.attrs["frame"] = self.frame
            f.attrs["center_deg"] = np.degrees(self.center)
            f.attrs["resolution_deg"] = np.degrees(self._res)
            f.create_dataset("nu", data=self.nu)
            f.attrs["axis3_label"] = self.axis3_label
            f.create_dataset("t", data=self.t)

    def to_fits(self, path: str):
        """The map's data as a FITS image (``io.fits.write_fits_map``)."""
        from ..io.fits import write_fits_map

        write_fits_map(self, path)

    def plot(self, slices=None, nu_index=None, t_index=None, stokes=None, ax=None, cmap="cmb", **kwargs):
        """A grid of panels over the slice dims (``slices="all"`` or e.g.
        ``{"stokes": ["I", "Q"], "nu": [[0], [1]]}``), or one panel with
        ``nu_index``, ``t_index``, ``stokes`` or ``ax`` (needs matplotlib)."""
        if slices is None and ax is None and (nu_index, t_index, stokes) == (None, None, None):
            slices = {}
        if slices is not None:
            from ..plotting.map import plot_map_slices

            return plot_map_slices(self, slices=slices, cmap=cmap, **kwargs)
        from ..plotting.map import plot_projection_map

        return plot_projection_map(self, nu_index=nu_index or 0, t_index=t_index or 0, stokes=stokes or "I", ax=ax,
                                   cmap=cmap, **kwargs)

    def transfer_function(self, input_map=None, n_bins: int = 20, stokes: str = "I", slices: dict = None,
                          t_index: int = 0, window="hann", taper: float = 0.1, pad_factor: float = 1.0):
        """The spatial transfer function of this map against ``input_map``
        (by default the sky the mapper's TODs were simulated from), a
        ``TransferFunction`` with a curve a frequency channel
        (``slices=dict(nu=[...])`` picks them). The input is sampled onto
        this map's grid and converted to its units first."""
        from .transfer import TransferFunction, compute_transfer_function

        input_map = input_map if input_map is not None else getattr(self, "_input_map", None)
        if input_map is None:
            raise ValueError("No input map: pass input_map=, or build this map with a mapper whose TODs came from "
                             "a Simulation(map=...).")
        same_grid = (tuple(input_map.data.shape[-2:]) == tuple(self.data.shape[-2:])
                     and np.allclose(input_map.center, self.center)
                     and np.isclose(input_map.x_res, self.x_res, rtol=1e-3))
        if same_grid:
            aligned = input_map
        else:
            sampled = input_map.sampled_onto(self, device=self.data.device)
            aligned = self._replace(data=sampled, weight=torch.ones_like(sampled), stokes=input_map.stokes,
                                    nu=input_map.nu, units=input_map.units,
                                    **{input_map.axis3_label: input_map.t})
        if aligned.units != self.units:
            aligned = aligned.to(self.units)
        s_idx = self.stokes.index(stokes) if isinstance(stokes, str) else int(stokes)
        nu_sel = range(self.n_nu)
        if slices and "nu" in slices:
            nu_sel = np.atleast_1d(np.asarray(slices["nu"])).ravel().tolist()
        curves, k_ref = [], None
        for j in nu_sel:
            tf_j = compute_transfer_function(aligned, self, window=window, taper=taper, n_bins=n_bins,
                                             pad_factor=pad_factor, stokes_index=s_idx,
                                             nu_index=int(j) % self.n_nu, t_index=t_index)
            curves.append(tf_j.tf)
            k_ref = tf_j.k if k_ref is None or len(tf_j.k) < len(k_ref) else k_ref
        curves = [np.interp(k_ref, k_ref[:len(c)], c[:len(k_ref)]) if len(c) != len(k_ref) else c for c in curves]
        beam = getattr(self, "_beam_fwhm", None)
        if beam is not None:
            beam = [beam[int(j) % len(beam)] for j in nu_sel]
        return TransferFunction(k=k_ref, tf=np.stack(curves) if len(curves) > 1 else curves[0], input_map=input_map,
                                output_map=self, nu=[self.nu[int(j) % self.n_nu] for j in nu_sel], beam_fwhm=beam)

    def __repr__(self):
        axis3 = "" if self.axis3_label == "t" and len(self.t) == 1 else (
            f", {self.axis3_label}=[{self.t.min():.3g}..{self.t.max():.3g}] (n={len(self.t)})"
        )
        return (
            f"ProjectionMap(shape={self.shape}, stokes='{self.stokes}', "
            f"nu={[f'{n / 1e9:.0f} GHz' for n in self.nu]}{axis3}, units='{self.units}', "
            f"center=({np.degrees(self.center[0]):.2f}, {np.degrees(self.center[1]):.2f}) deg, "
            f"resolution={np.degrees(self._res):.3g} deg, frame='{self.frame}')"
        )
