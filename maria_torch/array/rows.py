"""Which detector rows are a band's, decided in one place: host indices, and
device indexers (``Array.band_rows`` and ``band_rows_on`` keep both)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["band_rows", "device_rows", "row_span"]


def band_rows(band_name, bands) -> tuple:
    """The rows of each of ``bands`` (Band objects or names) in the column
    ``band_name``: a tuple of increasing int64 arrays, in ``bands``' order
    (empty for a band the column does not name)."""
    band_name = np.asarray(band_name)
    return tuple(np.flatnonzero(band_name == getattr(band, "name", band)).astype(np.int64) for band in bands)


def row_span(index):
    """``(start, stop)`` when rows ``index`` are one contiguous increasing
    run of non-negative rows ((0, 0) when there are none), else None."""
    index = np.asarray(index, dtype=np.int64)
    if len(index) == 0:
        return 0, 0
    start = int(index[0])
    if start >= 0 and np.array_equal(index, np.arange(start, start + len(index))):
        return start, start + len(index)
    return None


def device_rows(index, device):
    """Rows ``index`` as an indexer on ``device``: ``slice(start, stop)``
    where ``row_span`` finds one run, else an int64 tensor. A slice reads a
    view of the rows where an index's gather would copy them."""
    bounds = row_span(index)
    if bounds is None:
        return torch.as_tensor(np.asarray(index, dtype=np.int64), device=device)
    return slice(*bounds)
