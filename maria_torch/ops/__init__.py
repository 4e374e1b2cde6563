"""Device operations: interpolation, the TOD program, and the
hand-written kernels (``pink_noise``, ``bin_map``, ``shared_v``,
``ar_extrude``, ``sht_synth``, ``sht_anal``) with their plain torch
versions."""

from .bin_map import bin_map, bin_map_plain  # noqa: F401
from .pink_noise import pink_noise, pink_noise_plain  # noqa: F401
from .shared_v import shared_v, shared_v_plain  # noqa: F401
from .sht import sht_anal, sht_anal_plain, sht_synth, sht_synth_plain  # noqa: F401
