"""Map plots (maria_tpu/plotting/map.py): one panel, or a grid over the
slice dims, and the "cmb" colormap."""

from __future__ import annotations

import numpy as np

__all__ = ["plot_map_slices", "plot_projection_map"]

# a CMB-like diverging colormap, registered with matplotlib as "cmb"
_CMB_COLORS = ["#00007f", "#0000ff", "#00ffff", "#ffff00", "#ff0000", "#7f0000"]


def _register_cmb_cmap():
    import matplotlib as mpl
    from matplotlib.colors import LinearSegmentedColormap

    if "cmb" not in mpl.colormaps:
        mpl.colormaps.register(LinearSegmentedColormap.from_list("cmb", _CMB_COLORS))
    return mpl.colormaps["cmb"]


def __getattr__(name):
    # maria_tpu.plotting.map.cmb_cmap, made when asked so that importing
    # this module never imports matplotlib
    if name == "cmb_cmap":
        return _register_cmb_cmap()
    raise AttributeError(name)


def plot_projection_map(m, nu_index=0, t_index=0, stokes="I", ax=None, cmap="cmb", **kwargs):
    """One (stokes, nu, t) plane of a ProjectionMap on ``ax`` (a new
    figure without it), with a colorbar in the map's units."""
    import matplotlib.pyplot as plt

    _register_cmb_cmap()
    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=(6, 5))
    data = m.data[m.stokes.index(stokes), nu_index, t_index].detach().cpu().numpy()
    extent = np.degrees([m.x_side[0], m.x_side[-1], m.y_side[0], m.y_side[-1]])
    im = ax.imshow(data, origin="lower", extent=extent, cmap=cmap, **kwargs)
    ax.set_xlabel(r"$\Delta x$ [deg]")
    ax.set_ylabel(r"$\Delta y$ [deg]")
    plt.colorbar(im, ax=ax, label=m.units)
    return ax


def _slice_grid(m, slices) -> dict:
    """The panels' (stokes, nu, axis3) indices as 2-D arrays, broadcast
    from the per-dim requests of ``slices`` ("all" grids the dims of size
    above one; a Stokes letter or a negative index is taken)."""
    dims = ("stokes", "nu", m.axis3_label)
    sizes = {"stokes": m.n_stokes, "nu": m.n_nu, m.axis3_label: len(m.t)}
    if isinstance(slices, str):
        if slices != "all":
            raise ValueError(f"Invalid slices '{slices}' (did you mean 'all'?).")
        thick = [d for d in dims if sizes[d] > 1]
        if len(thick) > 2:
            raise ValueError("Cannot plot all slices: more than two thick slice dims.")
        slices = {d: np.expand_dims(np.arange(sizes[d]), i) for i, d in enumerate(thick)}
    for dim in slices:
        if dim not in dims:
            raise ValueError(f"Map has no slice dimension '{dim}' (dims: {dims}).")

    def as_index(dim, x):
        x = np.atleast_1d(np.asarray(x, dtype=object))
        out = np.empty(x.shape, dtype=int)
        for idx in np.ndindex(x.shape):
            v = x[idx]
            if dim == "stokes" and isinstance(v, str):
                if v not in m.stokes:
                    raise ValueError(f"Map does not have stokes parameter '{v}'.")
                v = m.stokes.index(v)
            out[idx] = int(v) % sizes[dim]
        return out

    grids = [np.atleast_2d(g) for g in np.broadcast_arrays(*[as_index(d, slices.get(d, [0])) for d in dims])]
    if grids[0].ndim > 2:
        raise ValueError("Broadcasted slices have more than two dimensions.")
    return dict(zip(dims, grids))


def plot_map_slices(m, slices="all", cmap: str = "cmb", units: str = None, filename: str = None,
                    contrast: float = 1e-3, center_zero: bool = False, vmin: float = None, vmax: float = None,
                    rel_vmin: float = None, rel_vmax: float = None, ax_size: float = 4.0, **imshow_kwargs):
    """A grid of panels over the slice dims: ``slices`` "all" or a dict
    such as {"stokes": [["I", "Q"], ["U", "V"]], "nu": [0]}. The colour
    limits are the covered pixels' quantiles at ``contrast`` unless vmin
    or vmax is given. Returns the axes."""
    import matplotlib.pyplot as plt

    _register_cmb_cmap()
    grid = _slice_grid(m, slices)
    dims = list(grid)
    nrows, ncols = grid[dims[0]].shape
    if units is not None and units != m.units:
        m = m.to(units)
    data = m.data.detach().cpu().numpy()
    weight = m.weight.detach().cpu().numpy() if m.weight is not None else np.ones_like(data)
    rel_lo = rel_vmin if rel_vmin is not None else contrast
    rel_hi = rel_vmax if rel_vmax is not None else 1.0 - contrast

    fig, axes = plt.subplots(nrows, ncols, figsize=(ax_size * ncols * 1.2, ax_size * nrows), constrained_layout=True,
                             squeeze=False)
    is_projection = hasattr(m, "x_side")
    extent = np.degrees([m.x_side[0], m.x_side[-1], m.y_side[0], m.y_side[-1]]) if is_projection else None
    for i in range(nrows):
        for j in range(ncols):
            idx = tuple(grid[d][i, j] for d in dims)
            panel, w = data[idx], weight[idx]
            lo, hi = vmin, vmax
            if lo is None or hi is None:
                valid = np.isfinite(panel) & (w > 0)
                vals = panel[valid] if valid.any() else panel[np.isfinite(panel)]
                if vals.size == 0:
                    vals = np.zeros(1)
                q_lo, q_hi = np.quantile(vals, [rel_lo, rel_hi])
                if center_zero:
                    a = max(abs(q_lo), abs(q_hi))
                    q_lo, q_hi = -a, a
                lo = lo if lo is not None else q_lo
                hi = hi if hi is not None else q_hi
            ax = axes[i, j]
            if is_projection:
                im = ax.imshow(panel, origin="lower", extent=extent, cmap=cmap, vmin=lo, vmax=hi, **imshow_kwargs)
                ax.set_xlabel(r"$\Delta x$ [deg]")
                ax.set_ylabel(r"$\Delta y$ [deg]")
            else:  # HEALPix: a Mollweide raster
                from .healpix import plot_healpix_map

                plot_healpix_map(m, ax=ax, nu_index=idx[1], t_index=idx[2], stokes=m.stokes[idx[0]], cmap=cmap)
                im = None
            title = []
            if m.n_stokes > 1:
                title.append(f"stokes {m.stokes[idx[0]]}")
            if m.n_nu > 1:
                title.append(f"{m.nu[idx[1]] / 1e9:.0f} GHz")
            if len(m.t) > 1:
                title.append(f"{m.axis3_label}[{idx[2]}]")
            if title:
                ax.set_title(", ".join(title))
            if im is not None:
                fig.colorbar(im, ax=ax, label=m.units, shrink=0.8)
    if filename:
        fig.savefig(filename, dpi=160)
    return axes
