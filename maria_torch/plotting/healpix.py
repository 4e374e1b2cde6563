"""HEALPix map plots (maria_tpu/plotting/healpix.py): a Mollweide view
rasterized by nearest-pixel lookup, as healpy's mollview draws it."""

from __future__ import annotations

import numpy as np

__all__ = ["plot_healpix_map"]


def plot_healpix_map(m, nu_index: int = 0, t_index: int = 0, stokes: str = "I", ax=None, cmap: str = "cmb",
                     vmin=None, vmax=None, n_grid: int = 400, **kwargs):
    """One (stokes, nu, t) slice of a HEALPixMap on Mollweide axes: the
    sphere sampled on an n_grid x 2 n_grid lon/lat grid at the nearest
    RING pixel, drawn by pcolormesh. Returns the axes."""
    import matplotlib.pyplot as plt
    import torch

    from ..healpix.core import ang2pix_ring, npix2nside
    from .map import _register_cmb_cmap

    _register_cmb_cmap()
    if ax is None:
        fig = plt.figure(figsize=(8, 4.5))
        ax = fig.add_subplot(111, projection="mollweide")
    s = m.stokes.index(stokes) if getattr(m, "stokes", None) else 0
    values = m.data[s, nu_index, t_index].detach().cpu().numpy()
    nside = npix2nside(len(values))
    lon = np.linspace(-np.pi, np.pi, 2 * n_grid)
    lat = np.linspace(-np.pi / 2, np.pi / 2, n_grid)
    LON, LAT = np.meshgrid(lon, lat)
    pix = ang2pix_ring(nside, torch.as_tensor(np.pi / 2 - LAT), torch.as_tensor(np.mod(LON, 2 * np.pi)))
    img = values[pix.numpy().astype(np.int64)]
    im = ax.pcolormesh(LON, LAT, img, cmap=cmap, vmin=vmin, vmax=vmax, rasterized=True, **kwargs)
    ax.grid(True, alpha=0.3)
    plt.colorbar(im, ax=ax, shrink=0.7, label=getattr(m, "units", ""))
    return ax
