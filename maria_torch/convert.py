"""Carry a maria_tpu program's static tables into the port.

``program_from_tables`` takes the tables of a maria_tpu ``TODProgram``
as plain numpy arrays and scalars and returns the port's ``TODProgram``;
``pixel_ids_from_tables`` turns (iy, ix) map indices into the flat int32
ids kernel K2 takes. Nothing here imports maria_tpu: the caller extracts
the arrays (the tests do).

``tables`` keys: offsets (n_det, 2), bs_az_coarse, bs_el_coarse,
t_coarse, t_fine, mueller_I, gain_error (or None), mean_pwv,
sample_rate, with_noise, screens (list of dicts with h, z, res, pwv_rms,
angle, vx, vy, tx_min, ty_min, nx, ny, W and optionally ty_res, win_x,
win_y, band) and bands (list of dicts with name, det_index, pwv_side,
el_side, power_table, NEP, knee, noise_basis, corr_prop).
"""

from __future__ import annotations

import numpy as np
import torch

from .atmosphere.atmosphere import LayerScreen
from .ops.program import BandBlock, TODProgram

__all__ = ["program_from_tables", "pixel_ids_from_tables"]

_SCREEN_FIELDS = ("h", "z", "res", "pwv_rms", "angle", "vx", "vy", "tx_min", "ty_min",
                  "nx", "ny", "W", "ty_res", "win_x", "win_y", "band")
_BAND_FIELDS = ("name", "det_index", "pwv_side", "el_side", "power_table", "NEP", "knee",
                "noise_basis", "corr_prop")


def program_from_tables(tables: dict) -> TODProgram:
    screens = []
    for s in tables["screens"]:
        kw = {k: s[k] for k in _SCREEN_FIELDS if k in s and s[k] is not None}
        kw["W"] = np.asarray(kw["W"], dtype=np.float32)
        for k in ("nx", "ny"):
            kw[k] = int(kw[k])
        screens.append(LayerScreen(**kw))
    bands = []
    for b in tables["bands"]:
        kw = {k: b.get(k) for k in _BAND_FIELDS}
        kw["det_index"] = np.asarray(kw["det_index"], dtype=np.int64)
        if kw["noise_basis"] is not None:
            kw["noise_basis"] = np.asarray(kw["noise_basis"], dtype=np.float64)
        kw["corr_prop"] = float(kw["corr_prop"] or 0.0)
        bands.append(BandBlock(**kw))
    gain_error = tables.get("gain_error")
    return TODProgram(
        screens=screens,
        mean_pwv=float(tables["mean_pwv"]),
        t_coarse=np.asarray(tables["t_coarse"], dtype=np.float64),
        t_fine=np.asarray(tables["t_fine"], dtype=np.float64),
        offsets=np.asarray(tables["offsets"], dtype=np.float32),
        bs_az_coarse=np.asarray(tables["bs_az_coarse"], dtype=np.float32),
        bs_el_coarse=np.asarray(tables["bs_el_coarse"], dtype=np.float32),
        mueller_I=np.asarray(tables["mueller_I"]),
        bands=bands,
        sample_rate=float(tables["sample_rate"]),
        with_noise=bool(tables.get("with_noise", True)),
        gain_error=None if gain_error is None else np.asarray(gain_error, dtype=np.float32),
    )


def pixel_ids_from_tables(iy, ix, n_y: int, n_x: int, device=None):
    """Flat int32 pixel ids iy * n_x + ix, -1 where either index is
    negative; raises on an index beyond the map."""
    iy = np.asarray(iy, dtype=np.int64)
    ix = np.asarray(ix, dtype=np.int64)
    if (iy >= n_y).any() or (ix >= n_x).any():
        raise ValueError("pixel index beyond the map")
    flat = np.where((iy >= 0) & (ix >= 0), iy * n_x + ix, -1).astype(np.int32)
    return torch.as_tensor(flat, device=device)
