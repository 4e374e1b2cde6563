"""Time-tagged pointing with lazy frame transforms (maria_tpu/coords).

A ``Coordinates`` holds angles in one native frame (az/el, ra/dec or
galactic) and computes the others on demand, on the host in float64:
the closed-form ephemeris rotation (``ephemeris``) is evaluated at every
timestamp and applied as a batched product, with annual aberration.
"""

from __future__ import annotations

import numpy as np

from .coordinates import Coordinates
from .earth import EarthLocation
from .frame import FRAMES, Frame, parse_frame
from .transforms import offsets_to_phi_theta, phi_theta_to_offsets, phi_theta_to_xyz, xyz_to_phi_theta

__all__ = [
    "Coordinates", "EarthLocation", "FRAMES", "Frame", "parse_frame", "infer_center_width_height",
    "offsets_to_phi_theta", "phi_theta_to_offsets",
]


def infer_center_width_height(coords_list, frame: str = "ra/dec"):
    """((phi, theta), width, height) in radians of the map that holds
    every pointing of ``coords_list`` in ``frame``."""
    centers = np.array([coords.center(frame=frame) for coords in coords_list])
    center_xyz = phi_theta_to_xyz(centers[:, 0], centers[:, 1]).mean(axis=0)
    center_xyz /= np.sqrt((center_xyz**2).sum())
    cphi, ctheta = xyz_to_phi_theta(center_xyz[None])
    center = (float(cphi[0]), float(ctheta[0]))

    width, height = 0.0, 0.0
    for coords in coords_list:
        offsets = coords.offsets(frame=frame, center=center).reshape(-1, 2)
        width = max(width, 2 * float(np.abs(offsets[:, 0]).max()))
        height = max(height, 2 * float(np.abs(offsets[:, 1]).max()))
    return center, width, height
