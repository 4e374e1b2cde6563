"""Plots of TODs, projected maps and HEALPix maps (maria_tpu/plotting).

matplotlib is imported inside each function: the package runs without it
where nothing is plotted. Tensors are read onto the host to be drawn.
"""

from .healpix import plot_healpix_map  # noqa: F401
from .map import plot_map_slices, plot_projection_map  # noqa: F401
from .tod import plot_tod, twinkle_plot  # noqa: F401
