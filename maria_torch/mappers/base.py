"""Mapper base (maria_tpu/mappers/base.py): each TOD processed by
``tod_preprocessing`` (``TOD.process``) and converted to the map's units,
map geometry from the TODs' pointing, Stokes and band inference, time
bins, and the shared postprocessing (optional smoothing, the zero-mean
convention). A unit of a TOD quantity is accumulated as it is; a
map-only unit (Jy/pixel, Jy/beam, Jy/sr, compton y) is accumulated in
K_RJ and the final map converted.

``BaseMapper`` holds what does not depend on the map's geometry: the
TODs (``add_tod`` processes and converts one more), the Stokes and band
inference, the time bins and ``postprocess``; ``BaseProjectionMapper``
adds the tangent-plane grid. A TOD given by ``add_tod`` after the mapper
is made is binned with the others, on the bands and time bins that the
first TODs set."""

from __future__ import annotations

import numpy as np
import torch

from ..coords import Frame
from ..io.logging import span
from ..map import ProjectionMap
from ..tod.tod import VALID_TOD_QUANTITIES
from ..units import Quantity, parse_units


class BaseMapper:
    """``progress_bars`` is kept for maria_tpu's signature (its mappers
    store it and draw none)."""

    def __init__(self, tods, frame: str = "ra/dec", units: str = "K_RJ", tod_preprocessing: dict = {},
                 map_postprocessing: dict = {}, t_bins: int = 1, timestep: float = None, stokes: str = None,
                 progress_bars: bool = False):
        self.frame = Frame(frame)
        self.units = units
        self.tod_units = units if parse_units(units).quantity in VALID_TOD_QUANTITIES else "K_RJ"
        self.t_bins = t_bins
        self.progress_bars = progress_bars
        self.map_postprocessing = dict(map_postprocessing)
        self.tods = []
        for tod in tods if isinstance(tods, (list, tuple)) else [tods]:
            self.add_tod(tod, preprocessing=tod_preprocessing)

        sw = np.concatenate([tod.dets.stokes_weight() for tod in self.tods], axis=0)
        # the simulation's input map rides along on the TODs' metadata
        input_maps = [tod.metadata["input_map"] for tod in self.tods if tod.metadata.get("input_map") is not None]
        self.input_map = input_maps[0] if input_maps else None

        self.stokes = stokes or "".join(s for i, s in enumerate("IQUV") if np.abs(sw[:, i]).max() > 1e-8)

        self.bands, seen = [], set()
        for tod in self.tods:
            for band in tod.dets.bands:
                if band.name not in seen:
                    self.bands.append(band)
                    seen.add(band.name)
        self.bands.sort(key=lambda b: b.center)
        self.nu = np.array([b.center for b in self.bands])

        t_min = min(float(tod.time.min()) for tod in self.tods)
        t_max = max(float(tod.time.max()) for tod in self.tods) + 1e-6
        if timestep is not None:  # seconds a time bin, in place of t_bins
            self.t_bins = t_bins = max(int(np.ceil((t_max - t_min) / float(timestep))), 1)
        self.t_edges = np.linspace(t_min, t_max, t_bins + 1)
        self.t_centers = 0.5 * (self.t_edges[1:] + self.t_edges[:-1])

    def add_tod(self, tod, preprocessing: dict = {}):
        """One more TOD, processed by ``preprocessing`` (``TOD.process``)
        and converted to the units the mapper accumulates."""
        with span("mapper.preprocess"):
            self.tods.append((tod.process(**preprocessing) if preprocessing else tod).to(self.tod_units))

    def postprocess(self, sums, weights):
        """(map, weights) of the (stokes, band, time, y, x) sums and
        weights, float64: the optional filters, sums / weights less its
        mean over the weighted pixels of each (stokes, band, time) map,
        NaN where the weight is not positive. Arrays in, arrays out; tensors
        stay on their device (the filters run on the host)."""
        from scipy.ndimage import gaussian_filter, median_filter

        as_array = not torch.is_tensor(sums)
        sums = torch.as_tensor(sums, dtype=torch.float64)
        weights = torch.as_tensor(weights, dtype=torch.float64, device=sums.device)
        sigma = self.map_postprocessing.get("gaussian_filter", {}).get("sigma", 0)
        size = self.map_postprocessing.get("median_filter", {}).get("size", 0)
        if sigma or (size and size > 1):
            s, w = sums.cpu().numpy(), weights.cpu().numpy()
            if sigma:
                s = gaussian_filter(s, sigma=(0, 0, 0, sigma, sigma))
                w = gaussian_filter(w, sigma=(0, 0, 0, sigma, sigma))
            if size and size > 1:
                s = median_filter(s, size=(1, 1, 1, size, size))
                w = median_filter(w, size=(1, 1, 1, size, size))
            sums, weights = (torch.as_tensor(a, device=sums.device) for a in (s, w))
        valid = weights > 0
        m = sums / weights
        if not self.map_postprocessing.get("keep_mean", False):
            n = valid.sum(dim=(-2, -1), keepdim=True)
            mean = torch.where(valid, m, 0.0).sum(dim=(-2, -1), keepdim=True) / n.clamp(min=1)
            m = torch.where(n > 0, m - mean, m)
        m = torch.where(valid, m, torch.nan)
        return (m.numpy(), weights.numpy()) if as_array else (m, weights)


class BaseProjectionMapper(BaseMapper):
    def __init__(self, tods, center=None, width=None, height=None, resolution=None,
                 frame: str = "ra/dec", units: str = "K_RJ", degrees: bool = True,
                 tod_preprocessing: dict = {}, map_postprocessing: dict = {}, t_bins: int = 1,
                 timestep: float = None, stokes: str = None, target=None, progress_bars: bool = False):
        if target is not None:
            # copy the geometry of a target map: BinMapper(tod, target=input_map)
            scale = 180 / np.pi if degrees else 1.0
            center = center if center is not None else tuple(scale * c for c in target.center)
            width = width if width is not None else target.width
            height = height if height is not None else target.height
            resolution = resolution if resolution is not None else target.resolution
            frame = target.frame
        # angle Quantities convert to the caller's angular convention
        def number(x):
            return (float(x.deg) if degrees else float(x.rad)) if isinstance(x, Quantity) else x

        width, height, resolution = number(width), number(height), number(resolution)
        if center is not None:
            center = tuple(number(c) for c in center)
        if Frame(frame).name == "galactic":
            raise ValueError("a projection mapper's frame is 'az/el' or 'ra/dec'")
        super().__init__(tods, frame=frame, units=units, tod_preprocessing=tod_preprocessing,
                         map_postprocessing=map_postprocessing, t_bins=t_bins, timestep=timestep, stokes=stokes,
                         progress_bars=progress_bars)

        to_rad = np.pi / 180 if degrees else 1.0
        if center is None or width is None:
            centers = [tod.boresight.center(frame=self.frame) for tod in self.tods]
            center_inferred = (float(np.mean([c[0] for c in centers])), float(np.mean([c[1] for c in centers])))
            center_rad = center_inferred if center is None else (center[0] * to_rad, center[1] * to_rad)
            max_half = 0.0
            for tod in self.tods:
                bs_off = tod.boresight.offsets(frame=self.frame, center=center_rad)
                det_r = np.abs(tod.pointing.offsets).max() if tod.pointing.offsets.size else 0.0
                max_half = max(max_half, np.abs(bs_off).max() + det_r)
            width_rad = height_rad = 2.05 * max_half
        else:
            center_rad = (center[0] * to_rad, center[1] * to_rad)
            width_rad = width * to_rad
            height_rad = (height if height is not None else width) * to_rad
        if resolution is None:
            res_rad = min(float(np.nanmin(tod.dets.angular_fwhm(np.inf))) for tod in self.tods) / 2
        else:
            res_rad = resolution * to_rad

        self.center = center_rad
        self.n_x = max(int(np.ceil(width_rad / res_rad)), 1)
        self.n_y = max(int(np.ceil(height_rad / res_rad)), 1)
        self.res = res_rad

    def make_map(self, data, weights) -> ProjectionMap:
        """The ProjectionMap of ``data`` (NaN and infinities made finite, as
        ``np.nan_to_num`` makes them) and ``weights``, float32; a finite
        float32 array is taken without a copy."""
        data = np.asarray(data)
        if not np.isfinite(data).all():
            data = np.nan_to_num(data)
        out = ProjectionMap(
            data=data.astype(np.float32, copy=False),
            weight=np.asarray(weights, dtype=np.float32),
            center=np.degrees(self.center),
            resolution=np.degrees(self.res),
            frame=self.frame.name,
            stokes=self.stokes,
            nu=self.nu,
            t=self.t_centers,
            units=self.tod_units,
        )
        out = out if self.units == self.tod_units else out.to(self.units)
        # what the map's transfer function reads: the sky the TODs were
        # simulated from and each band's mean beam FWHM (radians)
        out._input_map = self.input_map
        out._beam_fwhm = [
            float(np.nanmean([np.nanmean(tod.dets.angular_fwhm(np.inf)[mask]) for tod in self.tods
                              if (mask := tod.dets.mask(band_name=band.name)).any()]))
            for band in self.bands
        ]
        return out
