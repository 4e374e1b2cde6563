"""Focal-plane patterns (maria_tpu/array/generation.py): [x, y] detector
positions at unit nearest-neighbour spacing, cut to a named shape, and
scaled to a diameter or a spacing; with a diameter and a spacing and no
count, the count is iterated until the diameter fits.

The shapes' metric and its angular tiebreaker (``scaled_distance``) decide
which points survive a cut at n, so they are maria_tpu's formulas to the
letter: a named instrument has the same focal plane in both packages.
"""

from __future__ import annotations

import numpy as np

from ..utils import compute_diameter, rotation_matrix_2d

__all__ = ["NGONS", "PACKINGS", "SHAPES", "generate_2d_pattern", "generate_square_packing",
           "generate_sunflower_packing", "generate_triangular_packing", "scaled_distance", "square_packing",
           "sunflower_packing", "triangular_packing"]

SHAPES = ["triangle", "square", "hexagon", "octagon", "circle", "rhombus"]
PACKINGS = ["triangular", "square", "sunflower"]
NGONS = {"triangle": 3, "square": 4, "hexagon": 6, "octagon": 8, "circle": 1024}


def sunflower_packing(n: int) -> np.ndarray:
    i = np.arange(n)
    golden_angle = np.pi * (3.0 - np.sqrt(5.0))
    return 0.5966 * np.sqrt(i)[:, None] * np.stack([np.cos(golden_angle * i), np.sin(golden_angle * i)], axis=-1)


def square_packing(n_col: int, n_row: int) -> np.ndarray:
    col, row = np.meshgrid(np.arange(n_col, dtype=float), np.arange(n_row, dtype=float))
    x = col - n_col // 2 + (n_col + 1) % 2
    y = row - n_row // 2 + (n_row + 1) % 2
    return np.stack([x.ravel(), y.ravel()], axis=-1)


def triangular_packing(n_col: int, n_row: int) -> np.ndarray:
    col, row = np.meshgrid(np.arange(n_col, dtype=float), np.arange(n_row, dtype=float))
    x = col - n_col // 2 + (n_col + 1) % 2
    y = row - n_row // 2 + (n_row + 1) % 2 - 0.5 * x
    x = x * np.sqrt(3) / 2
    return np.stack([x.ravel(), y.ravel()], axis=-1)


def _packing_columns(xy) -> dict:
    return {"x": xy[:, 0], "y": xy[:, 1]}


# maria_tpu's names for the packings, which return a DataFrame with
# columns x and y: here a dict of the two numpy columns
def generate_sunflower_packing(n: int) -> dict:
    return _packing_columns(sunflower_packing(n))


def generate_square_packing(n_row: int, n_col: int) -> dict:
    return _packing_columns(square_packing(n_col=n_col, n_row=n_row))


def generate_triangular_packing(n_col: int, n_row: int) -> dict:
    return _packing_columns(triangular_packing(n_col=n_col, n_row=n_row))


def scaled_distance(x, y, shape: str, height_scale: float = 1.0):
    """The shape's radius of each point, plus 1e-3 r.max() times its
    angle, a tiebreaker that makes the order of equal radii fixed."""
    r = np.sqrt(x**2 + (y / height_scale) ** 2)
    p = np.arctan2(y / height_scale, x)
    if shape in NGONS:
        n_sides = NGONS[shape]
        d = r * np.cos(np.arcsin(np.sin(n_sides / 2 * p)) * 2 / n_sides)
    elif shape == "rhombus":
        d = r * (np.abs(np.cos(p)) / np.sqrt(3) + np.abs(np.sin(p)))
    else:
        raise ValueError(f"Supported shapes are {SHAPES}.")
    return d + 1e-3 * (r.max() if r.size else 1.0) * p


def generate_2d_pattern(n: int = None, n_col: int = None, n_row: int = None, max_diameter: float = None,
                        spacing: float = None, shape: str = "hexagon", rotation: float = 0.0,
                        packing: str = "triangular", height_scale: float = 1.0, max_iterations: int = 16,
                        tol: float = 1e-2) -> np.ndarray:
    """(n, 2) detector offsets from two of {a count (``n``, or ``n_col``
    and ``n_row``), ``max_diameter``, ``spacing``}: a count and a diameter
    scale the pattern to fit; a diameter and a spacing find the count."""
    if packing not in PACKINGS:
        raise ValueError(f"Supported packings are {PACKINGS}.")
    if shape not in SHAPES:
        raise ValueError(f"Supported shapes are {SHAPES}.")

    if n is None and (n_col is None or n_row is None):
        if max_diameter is None or spacing is None:
            raise ValueError("With no explicit count, supply both 'max_diameter' and 'spacing'.")
        current_n = max(3, int((max_diameter / spacing) ** 2))
        for _ in range(max_iterations):
            offsets = generate_2d_pattern(n=current_n, spacing=spacing, shape=shape, rotation=rotation,
                                          packing=packing)
            current_diameter = compute_diameter(offsets)
            if abs(np.log(max(current_diameter, 1e-16) / max_diameter)) <= tol:
                return offsets
            adjust = np.clip((max_diameter / max(current_diameter, 1e-16)) ** 2, 1e-2, 1e2)
            current_n = int(max(3, current_n * adjust))
            if current_n > 1e6:
                raise RuntimeError("Array generation diverged (n > 1e6).")
        return offsets

    if n is None:
        n = n_col * n_row
        if packing == "square":
            offsets = square_packing(n_col, n_row)
        elif packing == "triangular":
            offsets = triangular_packing(n_col, n_row)
        else:
            offsets = sunflower_packing(n)
    elif packing == "sunflower":
        offsets = sunflower_packing(n)
    else:
        # a generous superset, cut to the n points nearest the centre
        side = int(np.ceil(2.5 * np.sqrt(n))) | 1
        offsets = square_packing(side, side) if packing == "square" else triangular_packing(side, side)
        d = scaled_distance(offsets[:, 0], offsets[:, 1], shape=shape, height_scale=height_scale)
        offsets = offsets[np.argsort(d)[:n]]

    if rotation:
        offsets = offsets @ rotation_matrix_2d(rotation).T
    if spacing is not None:
        offsets = offsets * spacing
    elif max_diameter is not None:
        diameter = compute_diameter(offsets)
        if diameter > 0:
            offsets = offsets * (max_diameter / diameter)
    return offsets
