"""Correlated atmospheric emission: the 2-D Fourier model."""

from .atmosphere import Atmosphere, LayerScreen  # noqa: F401
