"""Offset-factored TOD field storage (maria_tpu/tod/field.py).

A detector's power sits at ~1e2 pW with fluctuations of ~1e-4 pW: raw in
float32 most of the mantissa goes to the level. ``Field`` keeps each
detector's time mean in float64 and only the residual at ``dtype``, on
the host. No TOD of the package uses it; it is a tool for real data.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Field"]


class Field:
    __slots__ = ("_offset", "_residual", "dtype")

    def __init__(self, data, dtype: type = np.float32):
        self.dtype = dtype
        self.data = data

    @property
    def data(self) -> np.ndarray:
        return self._offset[..., None] + self._residual

    @data.setter
    def data(self, value):
        value = np.asarray(value)
        self._offset = np.asarray(value.mean(axis=-1), dtype=np.float64)
        self._residual = np.asarray(value - self._offset[..., None], dtype=self.dtype)

    @property
    def offset(self) -> np.ndarray:
        """Each detector's level, float64."""
        return self._offset

    @property
    def residual(self) -> np.ndarray:
        """The timestream less its level, at the storage dtype."""
        return self._residual

    @property
    def shape(self):
        return self._residual.shape

    def __getitem__(self, key) -> "Field":
        return Field(data=self.data[key], dtype=self.dtype)

    def __repr__(self) -> str:
        return f"Field(shape={self._residual.shape}, dtype={np.dtype(self.dtype).name})"
