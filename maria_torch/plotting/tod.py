"""TOD plots (maria_tpu/plotting/tod.py): each band's timelines and
binned power spectra, and the focal plane's movie."""

from __future__ import annotations

import numpy as np

__all__ = ["plot_tod", "twinkle_plot"]

# short display names of TOD fields
FIELD_LABELS = {"atmosphere": "atm."}


def plot_tod(tod, max_dets: int = 16, fields=None, fig=None, detrend: str = "mean", n_freq_bins: int = 1024,
             lw: float = 1.0, fontsize: float = 10, figsize=None, units: str = None):
    """A row a band: the timelines of up to ``max_dets`` detectors of each
    field (less their mean, or their line with detrend="slope"), and the
    fields' mean power spectra in ``n_freq_bins`` log bins, with the
    band's noise model (white level and 1/f knee) for a TOD in pW.
    Returns the figure."""
    import matplotlib.pyplot as plt

    fields = fields or tod.fields
    bands = tod.dets.bands if tod.dets is not None else []
    if units is not None and units != tod.units:
        tod = tod.to(units)
    fig, axes = plt.subplots(max(len(bands), 1), 2, figsize=figsize or (10, 3 * max(len(bands), 1)), squeeze=False,
                             constrained_layout=True)
    t = tod.time - tod.time[0]
    fs = tod.fs
    for i, (band, rows) in enumerate(zip(bands, tod.dets.band_rows_on(tod.device) if bands else ())):
        ts_ax, ps_ax = axes[i]
        for field in fields:
            d = tod.data[field][rows][:max_dets].double().cpu().numpy()
            if detrend == "mean":
                d_ts = d - d.mean(axis=-1, keepdims=True)
            elif detrend in ("slope", "linear"):
                x = np.linspace(-1, 1, d.shape[-1])
                d_ts = d - d.mean(axis=-1, keepdims=True) - ((d @ x) / (x @ x))[:, None] * x
            else:
                d_ts = d
            ts_ax.plot(t, d_ts.T, lw=0.5 * lw, alpha=0.7)
            n = d.shape[-1]
            ps = np.abs(np.fft.rfft(d - d.mean(axis=-1, keepdims=True), axis=-1)) ** 2 / (n * fs)
            f = np.fft.rfftfreq(n, d=1 / fs)
            if n_freq_bins and len(f) - 1 > n_freq_bins:
                edges = np.geomspace(f[1], f[-1], n_freq_bins + 1)
                which = np.digitize(f[1:], edges) - 1
                mean_ps = ps.mean(axis=0)[1:]
                with np.errstate(invalid="ignore"):
                    pm = np.asarray([mean_ps[which == j].mean() if (which == j).any() else np.nan
                                     for j in range(n_freq_bins)])
                fc = np.sqrt(edges[:-1] * edges[1:])
                good = np.isfinite(pm)
                ps_ax.loglog(fc[good], pm[good], lw=0.8 * lw, label=field)
            else:
                ps_ax.loglog(f[1:], ps.mean(axis=0)[1:], lw=0.8 * lw, label=field)
        if tod.units == "pW" and getattr(band, "NEP", 0):
            f = np.fft.rfftfreq(len(t), d=1 / fs)[1:]
            white = (1e12 * band.NEP) ** 2 * np.ones_like(f)
            ps_ax.loglog(f, white * (1 + band.knee / f), color="k", ls="--", lw=1, label=f"{band.name} noise model")
        ts_ax.set_title(f"{band.name}")
        ts_ax.set_xlabel("time [s]")
        ts_ax.set_ylabel(f"signal [{tod.units}]")
        ps_ax.set_xlabel("frequency [Hz]")
        ps_ax.set_ylabel("power")
        ps_ax.legend(fontsize=max(fontsize - 3, 5))
    return fig


def twinkle_plot(tod, n_frames: int = 32, filename: str = None):
    """An animation of the focal plane: each detector at its offset,
    coloured by its total signal, at ``n_frames`` instants."""
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    offsets = np.degrees(tod.pointing.offsets)
    sig = tod.signal.cpu().numpy()
    frames = np.linspace(0, sig.shape[-1] - 1, n_frames).astype(int)
    fig, ax = plt.subplots(1, 1, figsize=(5, 5))
    vmin, vmax = np.percentile(sig, [1, 99])
    scat = ax.scatter(offsets[:, 0], offsets[:, 1], c=sig[:, frames[0]], vmin=vmin, vmax=vmax, s=12)
    ax.set_xlabel("xi [deg]")
    ax.set_ylabel("eta [deg]")

    def update(j):
        scat.set_array(sig[:, frames[j]])
        return (scat,)

    anim = animation.FuncAnimation(fig, update, frames=n_frames, blit=True)
    if filename:
        anim.save(filename, fps=8)
    return anim
