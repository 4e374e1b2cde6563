"""Binned map-making (maria_tpu/mappers/bin_mapper.py).

Pixel ids come from the detectors' factorized pointing in the map's
frame (az/el or ra/dec) on the TOD's device, on the card in one launch
of the pixel-id kernel (``ops.pixel_ids``); the sums of weight *
stokes_weight * data and of weight * |stokes_weight| per pixel are one
call of kernel K2 (``ops.bin_map``) per (TOD, band, time bin). The TPU's
Hilbert-ordered one-hot plans are not needed: the card scatters with
atomics.

``run(mesh=)`` shards the binning over a ("det", "time") mesh
(``maria_torch.parallel``): every rank holds the TODs, takes its block of
each band's detector rows and of each time bin's samples, computes the
pixel ids of its rows alone and bins its block with K2; the band's
float64 sums are reduced once (one ``all_reduce`` over the mesh), so the
postprocess runs on the same sums, and every rank returns the same Map.
Every band's float64 sums are accumulated on the device and postprocessed
there; the map and its weights, float32, go to the host once, as
maria_tpu's BinMapper sends its sums once.

Traced (``io.logging``), ``run`` is the span ``mapper.bin``, holding
``mapper.ids`` (each TOD's pixel ids) and ``mapper.postprocess`` (the
postprocess, the copies of the map and its weights to the host, counted
by ``mapper.host_copies``, and ``make_map``).

``field_pixel_ids`` and ``bin_total`` bin a program's total power into a
square map over the whole field, the benchmark's recipe (bench.py's
``_pixel_ids``): the pointing -> offsets -> ids chain runs on the
tensors' device, since at 50k detectors the host path takes minutes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..array.rows import device_rows
from ..coords import phi_theta_to_offsets
from ..device import resolve_device
from ..io.logging import count, span
from ..ops.bin_map import bin_map
from ..ops.pixel_ids import centred_pixel_ids
from ..ops.pixel_ids import flat_pixel_ids as pixel_ids
from ..ops.pixel_ids import pixel_ids as ops_pixel_ids
from ..tod import Pointing
from .base import BaseProjectionMapper

__all__ = ["BinMapper", "azel_pixel_ids", "bin_total", "field_pixel_ids", "pixel_ids", "radec_pixel_ids"]


def _frame_pixel_ids(pointing, frame: str, center, res: float, n_x: int, n_y: int, device):
    """On the card one launch of the pixel-id kernel from the factorized
    pointing; on the CPU the plain chain from the detectors' angles, as
    ``Pointing.det_azel`` and ``det_radec`` give them (the CPU tests hand
    the port another package's angles there)."""
    device = resolve_device(device)
    if device.type == "cpu":
        angles = pointing.det_radec if frame == "ra/dec" else pointing.det_azel
        return centred_pixel_ids(*angles(device=device), center, res, n_x, n_y)
    offsets, phi, theta, cos_q, sin_q = pointing.factors(frame, device=device)
    return ops_pixel_ids(offsets, phi, theta, center, res, n_x, n_y, cos_q, sin_q)


def azel_pixel_ids(pointing, center, res: float, n_x: int, n_y: int, device=None):
    """Flat int32 ids (n_det, n_t) at which BinMapper(frame="az/el") bins
    a TOD of this ``pointing``: an n_x x n_y map of pixels ``res``
    (radians) wide centred on ``center`` (az, el in radians), -1 outside."""
    return _frame_pixel_ids(pointing, "az/el", center, res, n_x, n_y, device)


def radec_pixel_ids(pointing, center, res: float, n_x: int, n_y: int, device=None):
    """As ``azel_pixel_ids`` for BinMapper(frame="ra/dec"): ``center`` is
    (ra, dec) in radians, the pointing the detectors' ra/dec."""
    return _frame_pixel_ids(pointing, "ra/dec", center, res, n_x, n_y, device)


def field_pixel_ids(boresight, offsets, n_x: int = 128, n_y: int = 128, device=None):
    """(ids, n_pix): flat int32 ids (n_det, n_t) of an n_x x n_y map
    centred on the mean boresight az/el whose half-width is 1.02 x the
    largest tangent-plane offset of any sample, so every sample lands
    on the map (indices clipped to its edge)."""
    from ..tod import Pointing

    az, el = Pointing(boresight, offsets).det_azel(device=device)
    c_az = float(np.mean(np.asarray(boresight.az)))
    c_el = float(np.mean(np.asarray(boresight.el)))
    offs = phi_theta_to_offsets(torch.stack([az, el], dim=-1), c_az, c_el)
    del az, el
    half = float(offs.abs().max()) * 1.02 + 1e-8
    res = 2 * half / n_x
    ix = torch.clamp(((offs[..., 0] + half) / res).to(torch.int32), 0, n_x - 1)
    iy = torch.clamp(((offs[..., 1] + half) / res).to(torch.int32), 0, n_y - 1)
    return (iy * n_x + ix).contiguous(), n_x * n_y


def bin_total(total, ids, n_pix: int):
    """(sums, hits), each (n_pix,) float32: kernel K2 over the total at
    the flat pixel ids, with its in-kernel hit count."""
    with span("mapper.bin"):
        sums, hits = bin_map(total.contiguous()[None], ids, n_pix, count=True)
    return sums, hits


class BinMapper(BaseProjectionMapper):
    def run(self, mesh=None):
        """Bin every TOD into the map; with a ``mesh`` each rank bins its
        (det, time) block of every (TOD, band, time bin) and the sums are
        reduced across the mesh (module docstring)."""
        with span("mapper.bin"):
            return self._run(mesh)

    def _run(self, mesh):
        n_s, n_nu, n_t = len(self.stokes), len(self.nu), self.t_bins
        n_pix = self.n_x * self.n_y
        stokes_idx = ["IQUV".index(s) for s in self.stokes]
        sums = torch.zeros((n_s, n_nu, n_t, n_pix), dtype=torch.float64,
                           device=self.tods[0].device if mesh is None else mesh.device)
        wgts = torch.zeros_like(sums)
        frame_ids = radec_pixel_ids if self.frame.name == "ra/dec" else azel_pixel_ids
        block = (lambda n, axis: (0, n)) if mesh is None else mesh.block  # this rank's block of n along axis

        for tod in self.tods:
            device = tod.device if mesh is None else mesh.device
            t_index = np.digitize(np.asarray(tod.time), self.t_edges) - 1
            data, weight = tod.signal, tod.weight
            # (index in the map, index in the TOD) of each band of the map that this TOD has
            names = tod.dets.bands.names
            bands = [(i_nu, names.index(band.name)) for i_nu, band in enumerate(self.bands) if band.name in names]
            local_rows = [tod.dets.band_rows()[j] for _, j in bands]
            local_rows = [r[slice(*block(len(r), "det"))] for r in local_rows]  # this rank's block of each
            with span("mapper.ids"):
                if mesh is None:
                    ids_all = frame_ids(tod.pointing, self.center, self.res, self.n_x, self.n_y, device=device)
                else:  # the ids of this rank's rows alone
                    p = tod.pointing
                    ids_all = frame_ids(Pointing(p.boresight, p.offsets[np.concatenate(local_rows)], p.q),
                                        self.center, self.res, self.n_x, self.n_y, device=device)
                    ids_row = np.cumsum([0] + [len(r) for r in local_rows])

            for k, (i_nu, j) in enumerate(bands):
                band_idx = local_rows[k]
                rows = tod.dets.band_rows_on(tod.device)[j] if mesh is None else device_rows(band_idx, tod.device)
                sw = torch.as_tensor(
                    tod.dets.stokes_weight()[band_idx][:, stokes_idx], dtype=torch.float32, device=device
                )
                id_rows = rows if mesh is None else slice(int(ids_row[k]), int(ids_row[k + 1]))
                band_sums = torch.zeros((2 * n_s, n_t, n_pix), dtype=torch.float64, device=device)
                for i_t in range(n_t):
                    cols = np.where(t_index == i_t)[0]
                    if len(cols) == 0:
                        continue
                    c0, c1 = (int(cols[0]) + x for x in block(int(cols[-1]) + 1 - int(cols[0]), "time"))
                    if len(band_idx) == 0 or c1 == c0:
                        continue
                    sl = slice(c0, c1)
                    d = data[rows, sl].to(device)
                    w = weight[rows, sl].to(device)
                    channels = torch.stack(
                        [w * sw[:, s, None] * d for s in range(n_s)]
                        + [w * torch.abs(sw[:, s, None]) for s in range(n_s)]
                    ).contiguous()
                    band_sums[:, i_t] += bin_map(channels, ids_all[id_rows, sl].contiguous(), n_pix)
                if mesh is not None:
                    band_sums = mesh.all_reduce(band_sums, ("det", "time"))
                band_sums = band_sums.to(sums.device)
                sums[:, i_nu] += band_sums[:n_s]
                wgts[:, i_nu] += band_sums[n_s:]

        with span("mapper.postprocess"):
            shape = (n_s, n_nu, n_t, self.n_y, self.n_x)
            data, weights = self.postprocess(sums.reshape(shape), wgts.reshape(shape))
            # one copy each of the float32 map and weights: a single tensor of both would exceed the host
            # allocator's largest reusable block (32 MiB) at 3 x 6 x 577 x 577 and take fresh pages every run
            data = torch.nan_to_num(data).to(torch.float32).cpu().numpy()
            weights = weights.to(torch.float32).cpu().numpy()
            count("mapper.host_copies", 2)
            self.map = self.make_map(data, weights)
        return self.map
