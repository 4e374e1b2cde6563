"""The radiometric spectra under their earlier path: the same objects as
``maria_torch.functions.radiometry``."""

from .functions.radiometry import (  # noqa: F401
    inverse_planck_spectrum,
    inverse_rayleigh_jeans_spectrum,
    planck_spectrum,
    rayleigh_jeans_kernel,
    rayleigh_jeans_spectrum,
)
