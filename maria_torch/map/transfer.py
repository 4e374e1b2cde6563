"""Map transfer functions (maria_tpu/map/transfer.py).

T(k) = Re<F_in* F_out> / <|F_in|^2> in log-spaced radial bins of the
spatial frequency, after an apodizing window over the output's covered
pixels. The cross-spectrum runs in float64 torch on the output map's
device; the bins, windows and ``pad_factor`` are maria_tpu's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..units import Quantity

__all__ = ["TransferFunction", "compute_transfer_function", "plot_transfer_function"]


class TransferFunction:
    """``k`` the bin centres (rad^-1) and ``tf`` the curve, (n_bins,) for
    one channel or (n_nu, n_bins) for several, host float64."""

    def __init__(self, k, tf, k_err=None, tf_err=None, input_map=None, output_map=None, nu=None, beam_fwhm=None):
        self.k = k
        self.tf = tf
        self.tf_err = tf_err
        self.input_map = input_map
        self.output_map = output_map
        self.nu = nu
        self.beam_fwhm = beam_fwhm

    @property
    def T(self):
        return np.atleast_2d(self.tf)

    def __call__(self, k, nu_index: int = 0):
        return np.interp(k, self.k, self.T[nu_index])

    def plot(self, ax=None, x_unit: str = "arcmin", filename: str = None, add_beam: bool = True,
             slices: dict = None, **kwargs):
        """The curves against angular scale with each channel's Gaussian
        beam dashed beside it; ``slices=dict(nu=[0])`` picks channels
        (needs matplotlib)."""
        T = self.T
        nu = np.atleast_1d(self.nu) if self.nu is not None else None
        beam = np.atleast_1d(self.beam_fwhm) if self.beam_fwhm is not None else None
        if slices and "nu" in slices:
            sel = np.atleast_1d(np.asarray(slices["nu"])).ravel()
            T = T[sel]
            nu = nu[sel] if nu is not None else None
            beam = beam[sel] if beam is not None else None
        return plot_transfer_function(self.k, T, nu=nu, beam_fwhm=beam if add_beam else None, ax=ax, x_unit=x_unit,
                                      filename=filename)

    def __repr__(self):
        n_nu = self.T.shape[0]
        return (f"TransferFunction({n_nu} channel{'s' if n_nu != 1 else ''}, "
                f"k=[{np.min(self.k):.1f}, {np.max(self.k):.1f}] rad^-1)")


def _window_2d(window, taper: float, ny: int, nx: int) -> np.ndarray:
    import scipy.signal

    spec = (window, taper) if window == "tukey" else window
    return np.outer(scipy.signal.get_window(spec, ny), scipy.signal.get_window(spec, nx))


def compute_transfer_function(input_map, output_map, window="tukey", taper: float = 0.5, n_bins: int = 32,
                              pad_factor: float = 1.0, stokes_index: int = 0, nu_index: int = 0,
                              input_nu_index: int = None, t_index: int = 0) -> TransferFunction:
    """The transfer function of ``output_map`` against ``input_map`` on
    the same grid, for one (stokes, nu, t) plane. ``window`` is a scipy
    window name, True (hann) or False (none); ``taper`` is the tukey
    alpha. The input is demeaned over the output's covered pixels, both
    are windowed there, zero-padded by ``pad_factor``, and their float64
    spectra binned in ``n_bins`` log-spaced bins of |k| (empty bins
    dropped)."""
    if window is True:
        window = "hann"
    elif window is False or window is None:
        window = "boxcar"
    in_nu = input_nu_index if input_nu_index is not None else min(nu_index, input_map.n_nu - 1)
    device = output_map.data.device
    d_in = input_map.data[stokes_index, in_nu, t_index].to(device=device, dtype=torch.float64)
    d_out = torch.nan_to_num(output_map.data[stokes_index, nu_index, t_index].to(torch.float64))
    if d_in.shape != d_out.shape:
        raise ValueError(f"Map shapes differ: {tuple(d_in.shape)} vs {tuple(d_out.shape)}.")

    ny, nx = d_in.shape
    valid = output_map.weight[stokes_index, nu_index, t_index].to(device) > 0
    w2d = torch.as_tensor(_window_2d(window, taper, ny, nx), device=device) * valid
    if bool(valid.any()):
        d_in = d_in - d_in[valid].mean()
    d_in, d_out = d_in * w2d, d_out * w2d
    if pad_factor > 1:
        py, px = int(ny * (pad_factor - 1) / 2), int(nx * (pad_factor - 1) / 2)
        d_in = torch.nn.functional.pad(d_in, (px, px, py, py))
        d_out = torch.nn.functional.pad(d_out, (px, px, py, py))
        ny, nx = d_in.shape

    F_in, F_out = torch.fft.rfft2(d_in), torch.fft.rfft2(d_out)
    cross = (F_in.conj() * F_out).real.reshape(-1)
    auto = (F_in.abs() ** 2).reshape(-1)
    ky = np.fft.fftfreq(ny, d=output_map.y_res)
    kx = np.fft.rfftfreq(nx, d=output_map.x_res)
    k = np.sqrt(ky[:, None] ** 2 + kx[None, :] ** 2)
    bins = np.geomspace(k[k > 0].min(), k.max(), n_bins + 1)
    idx = np.digitize(k.ravel(), bins) - 1
    inside = np.flatnonzero((idx >= 0) & (idx < n_bins))
    rows = torch.as_tensor(idx[inside], device=device)
    at = torch.as_tensor(inside, device=device)
    sums = torch.zeros((2, n_bins), dtype=torch.float64, device=device)
    sums[0].index_add_(0, rows, cross[at])
    sums[1].index_add_(0, rows, auto[at])
    cross_sum, auto_sum = sums.cpu().numpy()
    with np.errstate(invalid="ignore", divide="ignore"):
        tf = np.where(auto_sum > 0, cross_sum / auto_sum, np.nan)
    kc = np.sqrt(bins[:-1] * bins[1:])
    good = np.isfinite(tf)
    return TransferFunction(k=kc[good], tf=tf[good], input_map=input_map, output_map=output_map)


def plot_transfer_function(u, T, nu=None, beam_fwhm=None, ax=None, x_unit: str = "arcmin", filename: str = None):
    """Transfer-function curves ``T`` ((n_nu, n_bins) or (n_bins,))
    against angular scale at the spatial frequencies ``u`` (rad^-1), each
    channel's Gaussian beam of ``beam_fwhm`` (radians) dashed beside it
    (needs matplotlib)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(6, 4), constrained_layout=True)
    per_rad = {"arcsec": 206264.8, "arcmin": 3437.75, "deg": 57.29578}[x_unit]
    u = np.asarray(u)
    T = np.atleast_2d(np.asarray(T))
    if nu is not None and len(np.atleast_1d(nu)) != len(T):
        raise ValueError(f"Got {len(T)} curves but {len(np.atleast_1d(nu))} frequencies.")
    if beam_fwhm is not None and len(np.atleast_1d(beam_fwhm)) != len(T):
        raise ValueError(f"Got {len(T)} curves but {len(np.atleast_1d(beam_fwhm))} beam widths.")
    labels = ([f"{Quantity(v, 'Hz')}" for v in np.atleast_1d(np.asarray(nu, dtype=float))] if nu is not None
              else [None] * len(T))
    for i, row in enumerate(T):
        (line,) = ax.semilogx(per_rad / u, row, label=labels[i])
        if beam_fwhm is not None:
            sigma = np.atleast_1d(beam_fwhm)[i] / np.sqrt(8 * np.log(2))
            ax.semilogx(per_rad / u, np.exp(-2 * (np.pi * sigma * u) ** 2), ls="--", lw=1, color=line.get_color(),
                        alpha=0.6)
    ax.axhline(1.0, color="gray", ls=":")
    ax.set_xlabel(f"angular scale [{x_unit}]")
    ax.set_ylabel(r"$T$")
    if nu is not None:
        ax.legend()
    if filename:
        ax.figure.savefig(filename)
    return ax
