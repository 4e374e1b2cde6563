"""All-sky HEALPix maps (maria_tpu/map/healpix.py).

Data are float32 tensors of shape (stokes, nu, t, npix), in RING order.
Sampling along a line of sight is ``ang2pix_ring`` and a gather, on the
device of the pointing it is asked for; ``smooth`` runs the spherical
harmonic transforms (``maria_torch.healpix``) on the card unless told
otherwise. ``plot`` (matplotlib) draws a Mollweide view and ``to_hdf``
(h5py) writes maria_tpu's layout, both on the host.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..coords.ephemeris import ICRS_TO_GAL
from ..device import resolve_device
from ..healpix.core import ang2pix_ring, npix2nside
from ..units import as_radians
from .base import Map

__all__ = ["HEALPixMap"]

logger = logging.getLogger("maria_torch")


class HEALPixMap(Map):
    """An all-sky map in ``frame`` ("galactic" or "ra/dec"). A tensor's
    data stay on their device; anything else lands on the host."""

    map_dims = ("pixel",)

    def __init__(self, data, frame: str = "galactic", stokes: str = None, nu=None, t=None, z=None, v=None,
                 units: str = "K_CMB", weight=None, dtype=torch.float32, degrees: bool = True, resolution=None):
        # the weights (inverse variances) are carried only where given: a CMB has none
        super().__init__(data, stokes=stokes, nu=nu, t=t, z=z, v=v, units=units, weight=weight, dtype=dtype)
        self.frame = frame
        self.nside = npix2nside(self.data.shape[-1])
        if resolution is not None:
            # npix fixes a HEALPix grid's resolution: one that differs by
            # more than a factor of ~2 is reported and ignored
            res = float(resolution) * (np.pi / 180 if degrees else 1.0)
            if not 0.4 < res / self.resolution < 2.5:
                logger.warning(f"Requested resolution {res:.2e} rad differs from the HEALPix nside={self.nside} "
                               f"native {self.resolution:.2e} rad; ignoring.")

    def _replace(self, **kwargs) -> "HEALPixMap":
        params = dict(data=self.data, frame=self.frame, stokes=self.stokes, nu=self.nu, units=self.units,
                      weight=self.weight, **{self.axis3_label: self.t})
        if any(k in kwargs for k in ("t", "z", "v")):
            params.pop(self.axis3_label, None)
        params.update(kwargs)
        return type(self)(**params)

    @property
    def npix(self) -> int:
        return self.data.shape[-1]

    @property
    def resolution(self) -> float:
        """The side of a pixel of equal area, in radians."""
        return float(np.sqrt(4 * np.pi / self.npix))

    def _calibration_kwargs(self) -> dict:
        return {"pixel_area": 4 * np.pi / self.npix}

    # -- sampling --------------------------------------------------------------------------
    def pixel_index(self, phi, theta_lat):
        """int32 RING pixel of (longitude, latitude) tensors in the map's frame."""
        return ang2pix_ring(self.nside, np.pi / 2 - theta_lat, phi)

    def radec_pixels(self, ra, dec):
        """int64 RING pixels of ICRS (ra, dec) tensors, rotated into the
        map's frame first (ICRS -> galactic is one 3 x 3 rotation)."""
        if self.frame == "galactic":
            R = torch.as_tensor(ICRS_TO_GAL, dtype=torch.float32, device=ra.device)
            cos_d = torch.cos(dec)
            v = torch.stack([torch.cos(ra) * cos_d, torch.sin(ra) * cos_d, torch.sin(dec)], dim=-1)
            v_gal = torch.einsum("ij,...j->...i", R, v)
            phi = torch.atan2(v_gal[..., 1], v_gal[..., 0])
            lat = torch.asin(torch.clamp(v_gal[..., 2], -1, 1))
        elif self.frame == "ra/dec":
            phi, lat = ra, dec
        else:
            raise ValueError(f"Cannot sample a HEALPixMap in frame '{self.frame}'.")
        return self.pixel_index(phi, lat).to(torch.int64)

    def sample_stokes(self, pointing, stokes_weight, nu_index: int = 0, t_index: int = 0, device=None):
        """Stokes-weighted sample along each line of sight, (n_det, n_t):
        ``pointing`` a tod.Pointing, ``stokes_weight`` (n_det, n_stokes).
        Runs on the device of ``stokes_weight`` when it is a tensor (or
        ``device``): ra/dec of the detectors there, their pixels
        (``radec_pixels``), then the gather."""
        if device is None and isinstance(stokes_weight, torch.Tensor):
            device = stokes_weight.device
        device = resolve_device(device)
        weight = torch.as_tensor(stokes_weight, dtype=torch.float32, device=device)
        pix = self.radec_pixels(*pointing.det_radec(device=device))
        out = 0.0
        for s in range(self.n_stokes):
            field = self.data[s, nu_index, t_index].to(device)
            out = out + weight[:, s][:, None] * field[pix]
        return out

    def smooth(self, fwhm, device=None) -> "HEALPixMap":
        """The map smoothed by a Gaussian beam of ``fwhm`` (radians, or an
        angle ``Quantity``) in
        harmonic space, on ``device``: every scalar slice in one batched
        transform, Q and U by the spin-2 transform (smoothing them as
        scalars would mix E and B power near the poles)."""
        from ..healpix.sht import alm2map, alm2map_spin, map2alm, map2alm_spin

        device = resolve_device(device)
        sigma = as_radians(fwhm) / (2 * np.sqrt(2 * np.log(2)))
        lmax = min(3 * self.nside - 1, 2048)
        ells = np.arange(lmax + 1)
        beam = torch.as_tensor(np.exp(-0.5 * ells * (ells + 1) * sigma**2)[:, None], dtype=torch.float32,
                               device=device)
        data = self.data.to(device)
        new_data = data.clone()
        n_slices = self.n_nu * len(self.t)
        scalar = [i for i, s in enumerate(self.stokes) if s not in "QU"]
        if scalar:
            alm = map2alm(data[scalar].reshape(len(scalar) * n_slices, -1), lmax=lmax)
            new_data[scalar] = alm2map(alm * beam, self.nside).reshape(len(scalar), self.n_nu, len(self.t), -1)
        if "Q" in self.stokes and "U" in self.stokes:
            iq, iu = self.stokes.index("Q"), self.stokes.index("U")
            aE, aB = map2alm_spin(data[iq].reshape(n_slices, -1), data[iu].reshape(n_slices, -1), lmax=lmax)
            Qs, Us = alm2map_spin(aE * beam, aB * beam, self.nside)
            new_data[iq] = Qs.reshape(self.n_nu, len(self.t), -1)
            new_data[iu] = Us.reshape(self.n_nu, len(self.t), -1)
        return self._replace(data=new_data)

    def to_hdf(self, path: str):
        """The map as HDF5 in maria_tpu's layout (needs h5py)."""
        import h5py

        with h5py.File(path, "w") as f:
            f.create_dataset("data", data=self.data.detach().cpu().numpy())
            f.attrs["stokes"] = self.stokes
            f.attrs["units"] = self.units
            f.attrs["frame"] = self.frame
            f.attrs["axis3_label"] = self.axis3_label
            f.create_dataset("nu", data=self.nu)
            f.create_dataset("t", data=self.t)

    def plot(self, slices=None, **kwargs):
        """A Mollweide view of one slice (``plotting.healpix``), or with
        ``slices`` ("all" or a dict, as ``ProjectionMap.plot``) a grid of
        them (needs matplotlib)."""
        if slices is not None:
            from ..plotting.map import plot_map_slices

            return plot_map_slices(self, slices=slices, **kwargs)
        from ..plotting.healpix import plot_healpix_map

        return plot_healpix_map(self, **kwargs)

    def __repr__(self):
        return (f"{type(self).__name__}(shape={self.shape}, stokes='{self.stokes}', "
                f"nu={[f'{n / 1e9:.0f} GHz' for n in self.nu]}, units='{self.units}', nside={self.nside}, "
                f"frame='{self.frame}')")
