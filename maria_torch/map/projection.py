"""A minimal tangent-plane map (maria_tpu/map/projection.py):
data, weight, centre and resolution; no plotting or FITS yet."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["ProjectionMap"]


class ProjectionMap:
    """(stokes, nu, t, n_y, n_x) data and weight, centre and resolution
    in degrees."""

    def __init__(self, data, weight, center, resolution: float, frame: str = "az/el",
                 stokes: str = "I", nu=None, t=None, units: str = "K_RJ"):
        self.data = torch.as_tensor(data, dtype=torch.float32)
        self.weight = torch.as_tensor(weight, dtype=torch.float32)
        self.center = tuple(float(c) for c in center)
        self.resolution = float(resolution)
        self.frame = frame
        self.stokes = stokes
        self.nu = np.asarray(nu) if nu is not None else None
        self.t = np.asarray(t) if t is not None else None
        self.units = units

    def __repr__(self):
        return (f"ProjectionMap(shape={tuple(self.data.shape)}, center={self.center} deg, "
                f"resolution={self.resolution:.3g} deg, frame={self.frame}, units={self.units})")
