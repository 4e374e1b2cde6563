"""Device operations: interpolation, the TOD program, and the two
hand-written kernels (``pink_noise``, ``bin_map``) with their plain
torch versions."""

from .bin_map import bin_map, bin_map_plain  # noqa: F401
from .pink_noise import pink_noise, pink_noise_plain  # noqa: F401
