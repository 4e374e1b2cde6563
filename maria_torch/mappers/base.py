"""Mapper base (maria_tpu/mappers/base.py): map geometry from the TODs'
pointing, Stokes and band inference, time bins, and the shared
postprocessing (optional smoothing, the zero-mean convention)."""

from __future__ import annotations

import numpy as np

from ..coords import check_frame
from ..map import ProjectionMap


class BaseProjectionMapper:
    def __init__(self, tods, center=None, width=None, height=None, resolution=None,
                 frame: str = "ra/dec", units: str = "K_RJ", degrees: bool = True,
                 tod_preprocessing: dict = {}, map_postprocessing: dict = {}, t_bins: int = 1,
                 stokes: str = None):
        self.frame = check_frame(frame)
        if tod_preprocessing:
            raise NotImplementedError("TOD preprocessing (ROADMAP queue 1, item 12: processing)")
        if units not in ("K_RJ", "pW"):
            raise NotImplementedError(f"map units '{units}' (ROADMAP queue 1, item 13: the calibration graph)")
        self.units = units
        self.t_bins = t_bins
        self.map_postprocessing = dict(map_postprocessing)
        tods = tods if isinstance(tods, (list, tuple)) else [tods]
        self.tods = [tod.to(units) for tod in tods]

        sw = np.concatenate([tod.dets.stokes_weight() for tod in self.tods], axis=0)
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
        self.t_edges = np.linspace(t_min, t_max, t_bins + 1)
        self.t_centers = 0.5 * (self.t_edges[1:] + self.t_edges[:-1])

        to_rad = np.pi / 180 if degrees else 1.0
        if center is None or width is None:
            centers = [tod.boresight.center() for tod in self.tods]
            center_inferred = (float(np.mean([c[0] for c in centers])), float(np.mean([c[1] for c in centers])))
            center_rad = center_inferred if center is None else (center[0] * to_rad, center[1] * to_rad)
            max_half = 0.0
            for tod in self.tods:
                bs_off = tod.boresight.offsets(center=center_rad)
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

    def postprocess(self, sums, weights):
        from scipy.ndimage import gaussian_filter, median_filter

        sums = np.asarray(sums, dtype=np.float64)
        weights = np.asarray(weights, dtype=np.float64)
        sigma = self.map_postprocessing.get("gaussian_filter", {}).get("sigma", 0)
        if sigma:
            sums = gaussian_filter(sums, sigma=(0, 0, 0, sigma, sigma))
            weights = gaussian_filter(weights, sigma=(0, 0, 0, sigma, sigma))
        size = self.map_postprocessing.get("median_filter", {}).get("size", 0)
        if size and size > 1:
            sums = median_filter(sums, size=(1, 1, 1, size, size))
            weights = median_filter(weights, size=(1, 1, 1, size, size))
        with np.errstate(invalid="ignore", divide="ignore"):
            m = sums / weights
        if not self.map_postprocessing.get("keep_mean", False):
            for idx in np.ndindex(m.shape[:3]):
                valid = weights[idx] > 0
                if valid.any():
                    m[idx] -= m[idx][valid].mean()
        m = np.where(weights > 0, m, np.nan)
        return m, weights

    def make_map(self, data, weights) -> ProjectionMap:
        return ProjectionMap(
            data=np.nan_to_num(data).astype(np.float32),
            weight=np.asarray(weights, dtype=np.float32),
            center=np.degrees(self.center),
            resolution=np.degrees(self.res),
            frame=self.frame,
            stokes=self.stokes,
            nu=self.nu,
            t=self.t_centers,
            units=self.units,
        )
