"""Binned map-making (maria_tpu/mappers/bin_mapper.py).

Pixel ids come from the detectors' pointing on the TOD's device; the
sums of weight * stokes_weight * data and of weight * |stokes_weight|
per pixel are one call of kernel K2 (``ops.bin_map``) per (TOD, band,
time bin). The TPU's Hilbert-ordered one-hot plans are not needed: the
card scatters with atomics.
"""

from __future__ import annotations

import numpy as np
import torch

from ..coords import phi_theta_to_offsets
from ..ops.bin_map import bin_map
from .base import BaseProjectionMapper

__all__ = ["BinMapper", "pixel_ids"]


def pixel_ids(dx, dy, x0: float, y0: float, res: float, n_x: int, n_y: int):
    """Flat nearest-pixel ids iy * n_x + ix (int32) of tangent-plane
    offsets, -1 outside the map."""
    ix = torch.round((dx - x0) / res).to(torch.int32)
    iy = torch.round((dy - y0) / res).to(torch.int32)
    inside = (ix >= 0) & (ix < n_x) & (iy >= 0) & (iy < n_y)
    return torch.where(inside, iy * n_x + ix, torch.full_like(ix, -1))


class BinMapper(BaseProjectionMapper):
    def run(self):
        n_s, n_nu, n_t = len(self.stokes), len(self.nu), self.t_bins
        n_pix = self.n_x * self.n_y
        stokes_idx = ["IQUV".index(s) for s in self.stokes]
        x0 = -(self.n_x - 1) / 2 * self.res
        y0 = -(self.n_y - 1) / 2 * self.res
        sums = np.zeros((n_s, n_nu, n_t, n_pix))
        wgts = np.zeros_like(sums)

        for tod in self.tods:
            device = tod.device
            az, el = tod.pointing.det_azel(device=device)
            offsets = phi_theta_to_offsets(torch.stack([az, el], dim=-1), *self.center)
            ids_all = pixel_ids(offsets[..., 0], offsets[..., 1], x0, y0, self.res, self.n_x, self.n_y)
            t_index = np.digitize(np.asarray(tod.time), self.t_edges) - 1
            data, weight = tod.signal, tod.weight

            for i_nu, band in enumerate(self.bands):
                band_idx = np.where(tod.dets.band_name == band.name)[0]
                if len(band_idx) == 0:
                    continue
                rows = torch.as_tensor(band_idx, device=device)
                sw = torch.as_tensor(
                    tod.dets.stokes_weight()[band_idx][:, stokes_idx], dtype=torch.float32, device=device
                )
                for i_t in range(n_t):
                    cols = np.where(t_index == i_t)[0]
                    if len(cols) == 0:
                        continue
                    sl = slice(int(cols[0]), int(cols[-1]) + 1)
                    d = data[rows, sl]
                    w = weight[rows, sl]
                    channels = torch.stack(
                        [w * sw[:, s, None] * d for s in range(n_s)]
                        + [w * torch.abs(sw[:, s, None]) for s in range(n_s)]
                    ).contiguous()
                    binned = bin_map(channels, ids_all[rows, sl].contiguous(), n_pix).cpu().numpy()
                    sums[:, i_nu, i_t] += binned[:n_s]
                    wgts[:, i_nu, i_t] += binned[n_s:]

        shape = (n_s, n_nu, n_t, self.n_y, self.n_x)
        data, weights = self.postprocess(sums.reshape(shape), wgts.reshape(shape))
        self.map = self.make_map(data, weights)
        return self.map
