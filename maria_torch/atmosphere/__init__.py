"""Correlated atmospheric emission: the 2-D and 3-D Fourier models."""

from .atmosphere import Atmosphere, LayerScreen, ScreenGroup  # noqa: F401

SUPPORTED_MODELS_LIST = ["2d", "3d"]
