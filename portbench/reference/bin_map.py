"""The binned map of a TOD, as a BinMapper in ra/dec defines it, in
float64 plain torch, with none of the program's code.

- ``geometry``: a square map centred on the boresight's spherical mean,
  2.05 x (the largest tangent-plane offset of the boresight about that
  centre + the largest detector offset) wide, in pixels ``res`` wide;
- ``pixel_ids``: each sample's nearest pixel iy n_x + ix in the
  azimuthal-equidistant projection about the centre, -1 off the map;
- ``bin``: for each band (the bands sorted by centre, ties in the
  instrument's order) and each Stokes parameter s, the sums over the
  band's samples of w_s d and of |w_s| at each pixel, w the detector's
  Stokes weights (all samples weigh 1);
- ``postprocess``: the map sum / weight where the weight is positive,
  less its mean over those pixels, a band and a Stokes parameter at a
  time; NaN elsewhere.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .common import F64, phi_theta_to_offsets


def geometry(ra, dec, offsets, res: float) -> dict:
    """The map's centre (ra, dec), side in pixels and pixel size, from the
    boresight's (ra, dec) at every sample (float64 tensors) and the
    detectors' offsets."""
    xyz = torch.stack([torch.cos(ra) * torch.cos(dec), torch.sin(ra) * torch.cos(dec), torch.sin(dec)]).mean(dim=1)
    c_ra = float(torch.atan2(xyz[1], xyz[0])) % (2 * math.pi)
    c_dec = float(torch.asin(xyz[2] / xyz.norm()))
    bx, by = phi_theta_to_offsets(ra, dec, c_ra, c_dec)
    half = float(torch.maximum(bx.abs().max(), by.abs().max())) + float(np.abs(offsets).max())
    return {"center": (c_ra, c_dec), "n_x": max(math.ceil(2.05 * half / res), 1), "res": res}


def pixel_ids(ra, dec, geom: dict):
    """int64 pixel ids of the points (ra, dec), -1 off the map."""
    n_x, res = geom["n_x"], geom["res"]
    dx, dy = phi_theta_to_offsets(ra, dec, *geom["center"])
    x0 = -(n_x - 1) / 2 * res
    ix, iy = torch.round((dx - x0) / res).long(), torch.round((dy - x0) / res).long()
    inside = (ix >= 0) & (ix < n_x) & (iy >= 0) & (iy < n_x)
    return torch.where(inside, iy * n_x + ix, -1)


def band_order(bands: list) -> list:
    """The positions of ``bands`` (dicts with a "center") sorted by centre,
    ties kept in their order."""
    return sorted(range(len(bands)), key=lambda i: bands[i]["center"])


def bin(data, ids, sw, n_pix: int, q=lambda x: x) -> tuple:
    """(sums, weights), each (n_s, n_pix) float64: a band's samples
    ``data`` (n, n_t) at ``ids`` (n, n_t) with its detectors' Stokes
    weights ``sw`` (n, n_s); samples off the map (id -1) left out; both
    rounded by ``q`` (the control's precision)."""
    flat = ids.reshape(-1)
    on = flat >= 0
    flat = flat[on]
    n_s = sw.shape[1]
    sums = torch.zeros((n_s, n_pix), dtype=F64, device=data.device)
    wgts = torch.zeros_like(sums)
    for s in range(n_s):
        w = sw[:, s, None].expand_as(data)
        sums[s].index_add_(0, flat, q(w * data).reshape(-1)[on])
        wgts[s].index_add_(0, flat, w.abs().reshape(-1)[on])
    return q(sums), q(wgts)


def postprocess(sums, wgts):
    """The map: sums / weights less their mean where the weight is
    positive, NaN elsewhere, over the last axis."""
    valid = wgts > 0
    m = torch.where(valid, sums / torch.where(valid, wgts, 1.0), 0.0)
    mean = (m * valid).sum(dim=-1, keepdim=True) / valid.sum(dim=-1, keepdim=True).clamp(min=1)
    return torch.where(valid, m - mean, torch.nan)
