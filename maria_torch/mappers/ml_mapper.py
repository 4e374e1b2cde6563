"""Maximum-likelihood map-making (maria_tpu/mappers/ml_mapper.py).

The map m has shape (n_stokes, n_nu * t_bins * (n_pix + 1)): a frame of
n_pix pixels and one overflow bucket for every (band, time bin), so each
time bin is its own solve. Each TOD is one block on its device: the
channel- and time-bin-offset nearest-pixel ids ``pix`` (n_det, n_t)
int32, samples off the map at their frame's bucket; the Stokes weights
``sw`` (n_det, n_s); and the float32 data.

- P m is a Stokes-weighted gather (``index_select``) of m's pixels: a
  sample off the map reads zero, since its bucket holds no sky. P^T v is
  one call of kernel K2 (``ops.bin_map``) with the n_s Stokes-weighted
  rows as its channels, into the n_nu * t_bins * (n_pix + 1) pixels, the
  buckets included. In P^T N^-1 P the buckets' rows are the identity.
  maria_tpu's P reads the buckets, so where samples fall off the map its
  P^T N^-1 P couples the pixels' rows to the buckets' columns and is not
  symmetric, and its CG diverges (ROADMAP queue 3, hazard 5); the two
  agree wherever every sample lies on the map.
- The noise model is diagonal in frequency a detector: the smoothed
  periodogram of the Tukey-windowed, map-subtracted residuals. With
  ``k > 0`` it adds the top-k detector modes, N_f = diag(A_f) + U
  diag(lam_f) U^T, inverted exactly a frequency by the Woodbury identity
  with a k x k core precomputed an epoch.
- The solvers: conjugate gradients with the Jacobi preconditioner, as
  ``jax.scipy.sparse.linalg.cg`` runs them with tol 1e-8 (its stop rule
  freezes the state on the device instead of leaving a loop, so an epoch
  reads nothing back but the noise model's median PSD), and steepest
  descent with an exact line search.

The TPU's MXU pointing plans and fused epoch are not ported: their
keywords, ``mxu_pointing=`` and ``fit(fused=)``, are taken and change
nothing.

``mesh=`` shards every block over the mesh's "det" axis
(``maria_torch.parallel``): a rank holds ceil(n_det / n_ranks) rows of
each TOD, the last rank's padded with zero-weight rows (ids at an
overflow bucket, Stokes weights and data 0, noise weight 0), as
maria_tpu pads them. P and the noise filters are row-local. What couples
detectors crosses the ranks of the "det" group:

- P^T: K2 on the rank's rows, then one ``all_reduce`` of the (n_m,)
  float32 vector an operator application (rhs, P^T N^-1 P, the
  diagonal, the hit and naive maps). The CG state is then the same on
  every rank, so its dots and its stop rule need no collective and read
  nothing back to the host.
- The Woodbury U^T x: an ``all_reduce`` of (k, n_f, 2) float32 a block
  and application of N^-1.
- The Gram G = sum_d A_inv U U^T: an ``all_reduce`` of (n_f, k, k) a
  block and epoch.
- The common-mode ``decompose``: its float64 Gram is n_det x n_det, so
  the windowed residuals are gathered (``all_gather`` of (n_det, n_t)
  float32 a block and epoch) and every rank decomposes the whole block
  (the same modes as one process) and keeps its rows of U.
- The median PSD of the noise model's history: the smoothed spectra are
  gathered ((n_det, n_f) float32 a block and epoch).
"""

from __future__ import annotations

import logging

import numpy as np
import scipy as sp
import torch

from ..ops.bin_map import bin_map
from ..utils.signal import decompose, median
from .base import BaseProjectionMapper
from ..tod import Pointing
from .bin_mapper import azel_pixel_ids, radec_pixel_ids

__all__ = ["MaximumLikelihoodMapper", "conjugate_gradient", "smooth_spectrum"]

logger = logging.getLogger("maria_torch")


def smooth_spectrum(spec, k: int):
    """The mean of k neighbouring bins along the last axis, as
    ``np.convolve(row, ones(k) / k, mode="same")``: zero-padded, the window
    of bin i running from i - k // 2 to i + (k - 1) // 2."""
    if k <= 1:
        return spec
    n = spec.shape[-1]
    padded = torch.nn.functional.pad(spec, (k // 2, (k - 1) // 2))
    total = padded[..., :n]
    for j in range(1, k):
        total = total + padded[..., j : j + n]
    return total / k


def conjugate_gradient(A, b, x0, maxiter: int, inv_diag, tol: float = 1e-8):
    """x with A x = b by conjugate gradients preconditioned by
    M = diag(inv_diag), the recurrence of ``jax.scipy.sparse.linalg.cg``:
    it stops once r.r <= tol^2 b.b, or after ``maxiter`` steps. Every step
    runs; once the rule holds the state is frozen with ``torch.where``, so
    no step reads the device, and the 0/0 of a converged step is never
    selected."""
    atol2 = tol**2 * torch.dot(b, b)
    r = b - A(x0)
    z = r * inv_diag
    state = (x0, r, torch.dot(r, z), z)
    for _ in range(maxiter):
        state = cg_step(A, state, inv_diag, atol2)
    return state[0]


def cg_step(A, state, inv_diag, atol2):
    """One step of ``conjugate_gradient``: state (x, r, gamma, p)."""
    x, r, gamma, p = state
    active = torch.dot(r, r) > atol2
    Ap = A(p)
    alpha = gamma / torch.dot(p, Ap)
    x_ = x + alpha * p
    r_ = r - alpha * Ap
    z_ = r_ * inv_diag
    gamma_ = torch.dot(r_, z_)
    p_ = z_ + (gamma_ / gamma) * p
    return tuple(torch.where(active, new, old) for new, old in zip((x_, r_, gamma_, p_), state))


def _tukey(n: int, device, alpha: float = 0.25):
    return torch.as_tensor(sp.signal.windows.tukey(n, alpha), dtype=torch.float32, device=device)


class MaximumLikelihoodMapper(BaseProjectionMapper):
    mesh = None  # the "det" shards' mesh (maria_torch.parallel), None in one process

    def __init__(self, *args, n_epochs: int = 2, n_cg_iters: int = 50, spectrum_smoothing: float = 8.0, k: int = 0,
                 init: str = "bin", bilinear: bool = False, prior: bool = False, mesh=None, mxu_pointing: bool = None,
                 **kwargs):
        if init not in ("bin", "random"):
            raise ValueError(f"init must be 'bin' or 'random', not '{init}'.")
        super().__init__(*args, **kwargs)
        self.n_epochs = n_epochs
        self.n_cg_iters = n_cg_iters
        self.spectrum_smoothing = spectrum_smoothing
        self.k = k
        self.init = init
        self.mesh = mesh
        if bilinear:
            logger.warning("bilinear=True: the ML mapper samples nearest-pixel; ignoring.")
        if prior:
            logger.warning("prior=True: no prior term is implemented; ignoring.")
        # one entry an epoch: a list of {f, median_psd, mode_psd} a TOD
        self.noise_model_history = []
        self._prepare()
        self._compute_naive_map()
        self.map = self._grid_to_map(self.naive_map, self.hits)

    @property
    def device(self):
        return self.blocks[0]["data"].device

    # -- the det shards -----------------------------------------------------------------------

    def _reduce(self, x):
        """Sum ``x`` over the mesh's "det" ranks (nothing without a mesh)."""
        return x if self.mesh is None else self.mesh.all_reduce(x, "det")

    def _gather_rows(self, x, block):
        """The block's whole (n_det, ...) rows of a per-row tensor, on
        every rank (``x`` itself without a mesh)."""
        if self.mesh is None:
            return x
        return torch.cat(self.mesh.all_gather(x.contiguous(), "det"))[: block["n_det"]]

    def _local_rows(self, x, block):
        """This rank's rows of a whole (n_det, ...) tensor, zero-padded to
        the block's rows."""
        if self.mesh is None:
            return x
        start = block["row0"]
        out = torch.zeros((block["data"].shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
        out[: block["n_real"]] = x[start:start + block["n_real"]]
        return out

    def _prepare(self):
        """A block a TOD: channel- and time-bin-offset pixel ids, Stokes
        weights and the data, on the TOD's device."""
        self.n_pix = self.n_x * self.n_y
        self.n_pix1 = self.n_pix + 1  # + the overflow bucket
        self.n_s = len(self.stokes)
        self.n_nu = len(self.nu)
        self.n_cpix = self.n_nu * self.t_bins * self.n_pix1
        self.n_m = self.n_s * self.n_cpix
        stokes_cols = ["IQUV".index(s) for s in self.stokes]
        band_channel = {b.name: i for i, b in enumerate(self.bands)}
        frame_ids = radec_pixel_ids if self.frame.name == "ra/dec" else azel_pixel_ids
        self.blocks = []
        for tod in self.tods:
            n_det = tod.signal.shape[0]
            if self.mesh is None:
                device, (start, stop), n_rows = tod.device, (0, n_det), n_det
                pointing = tod.pointing
            else:
                device, (start, stop) = self.mesh.device, self.mesh.block(n_det, "det")
                n_rows = -(-n_det // self.mesh.axis_size("det"))
                p = tod.pointing
                pointing = Pointing(p.boresight, p.offsets[start:stop], p.q)
            ids = frame_ids(pointing, self.center, self.res, self.n_x, self.n_y, device=device)
            pix = torch.where(ids < 0, self.n_pix, ids)
            chan = np.array([band_channel[b] for b in tod.dets.band_name[start:stop]], dtype=np.int32)
            tbin = np.clip(np.digitize(np.asarray(tod.time), self.t_edges) - 1, 0, self.t_bins - 1).astype(np.int32)
            frame = (torch.as_tensor(chan, device=device)[:, None] * self.t_bins
                     + torch.as_tensor(tbin, device=device)[None, :])
            sw = np.asarray(tod.dets.stokes_weight(), dtype=np.float32)[start:stop, stokes_cols]
            block = {
                "pix": (pix + frame * self.n_pix1).to(torch.int32).contiguous(),
                "sw": torch.as_tensor(sw, device=device),
                "data": tod.signal[start:stop].to(device=device, dtype=torch.float32).contiguous(),
                "fs": tod.fs, "n_det": n_det, "row0": start, "n_real": stop - start,
            }
            pad = n_rows - (stop - start)
            if pad:
                # zero-weight rows: ids at the first frame's bucket, weights and data 0
                block["pix"] = torch.cat([block["pix"], torch.full((pad, block["pix"].shape[1]), self.n_pix,
                                                                   dtype=torch.int32, device=device)])
                block["sw"] = torch.cat([block["sw"], block["sw"].new_zeros((pad, self.n_s))])
                block["data"] = torch.cat([block["data"], block["data"].new_zeros((pad, block["data"].shape[1]))])
            self.blocks.append(block)
        self._set_overflow_mask()

    def _set_overflow_mask(self):
        """(n_m,) float32: 1 at the pixels, 0 at the overflow buckets."""
        mask = torch.ones((self.n_s, self.n_nu * self.t_bins, self.n_pix1), dtype=torch.float32, device=self.device)
        mask[..., -1] = 0.0
        self._overflow_mask = mask.reshape(-1)

    # -- pointing -----------------------------------------------------------------------------

    def _project(self, m_flat, block):
        """P m: (n_det, n_t), the Stokes-weighted gather of m at the
        block's ids, the overflow buckets read as zero."""
        m = (m_flat * self._overflow_mask).view(self.n_s, self.n_cpix)
        flat = block["pix"].view(-1)
        out = None
        for s in range(self.n_s):
            g = block["sw"][:, s, None] * torch.index_select(m[s], 0, flat).view_as(block["pix"])
            out = g if out is None else out + g
        return out

    def _project_T(self, v, block, sw=None):
        """P^T v: (n_m,), kernel K2 over the n_s rows sw_s * v at the
        block's ids (``sw`` in place of the block's Stokes weights)."""
        sw = block["sw"] if sw is None else sw
        channels = (sw.T[:, :, None] * v[None]).contiguous()
        return bin_map(channels, block["pix"], self.n_cpix).view(-1)

    # -- noise model --------------------------------------------------------------------------

    def _update_noise_model(self, m_flat):
        """A_inv (n_det, n_f) a block from the map-subtracted residuals,
        and with k > 0 the modes U (n_det, k) and the Woodbury core
        (diag(1/lam_f) + U^T A_f^-1 U)^-1 (n_f, k, k)."""
        epoch_diag = []
        for block in self.blocks:
            resid = block["data"] - self._project(m_flat, block)
            resid = resid - resid.mean(dim=-1, keepdim=True)
            n = resid.shape[-1]
            win = _tukey(n, resid.device)
            wd = resid * win
            w2 = (win**2).sum()
            smoothing = int(self.spectrum_smoothing)
            if self.k > 0 and block["n_det"] > self.k:
                U, modes = decompose(self._gather_rows(wd, block), k=self.k)
                U = self._local_rows(U, block)
                noise = wd - U @ modes
                lam = torch.fft.rfft(modes, dim=-1).abs() ** 2 / w2
                lam = torch.clamp(smooth_spectrum(lam, smoothing), min=1e-30)
            else:
                U, lam, noise = None, None, wd
            spec = smooth_spectrum(torch.fft.rfft(noise, dim=-1).abs() ** 2 / w2, smoothing)
            block["A_inv"] = 1.0 / torch.clamp(spec, min=1e-30)
            if block["n_real"] < wd.shape[0]:
                block["A_inv"][block["n_real"]:] = 0.0  # padded rows carry no weight
            block["U"] = U
            if U is not None:
                G = self._reduce(torch.einsum("df,dk,dl->fkl", block["A_inv"], U, U))
                block["core"] = torch.linalg.inv_ex(torch.diag_embed((1.0 / lam).T) + G)[0]
            epoch_diag.append({
                "f": np.fft.rfftfreq(n, d=1 / block["fs"]),
                "median_psd": median(self._gather_rows(spec, block), dim=0).cpu().numpy(),
                "mode_psd": lam.cpu().numpy() if lam is not None else None,
            })
        self.noise_model_history.append(epoch_diag)

    def _woodbury(self, block, x):
        """x - A^-1 U core U^T x a frequency: with x = A^-1 F v, this is
        N_f^-1 F v for N_f = diag(A_f) + U diag(lam_f) U^T."""
        if block.get("U") is None:
            return x
        U = block["U"]
        xr = torch.view_as_real(x)  # (n_det, n_f, 2)
        y = self._reduce(torch.einsum("dk,dfc->kfc", U, xr))
        z = torch.einsum("fkl,lfc->kfc", block["core"], y)
        return torch.view_as_complex((xr - block["A_inv"][..., None] * torch.einsum("dk,kfc->dfc", U, z)).contiguous())

    def _apply_inverse_N(self, block, v):
        """N^-1 v: rfft, the weight A^-1, the Woodbury term, irfft."""
        n = v.shape[-1]
        return torch.fft.irfft(self._woodbury(block, torch.fft.rfft(v, dim=-1) * block["A_inv"]), n=n, dim=-1)

    # -- normal equations ---------------------------------------------------------------------

    def _rhs(self):
        rhs = torch.zeros(self.n_m, dtype=torch.float32, device=self.device)
        for block in self.blocks:
            rhs = rhs + self._project_T(self._apply_inverse_N(block, block["data"]), block)
        return self._reduce(rhs)

    def _apply_PNP(self, m_flat):
        """P^T N^-1 P m, with the overflow buckets' rows the identity (P
        reads them as zero, so their columns are too: the operator is
        symmetric)."""
        out = torch.zeros(self.n_m, dtype=torch.float32, device=self.device)
        for block in self.blocks:
            out = out + self._project_T(self._apply_inverse_N(block, self._project(m_flat, block)), block)
        out = self._reduce(out)
        mask = self._overflow_mask
        return out * mask + m_flat * (1 - mask)

    def _white_diag(self):
        """diag(P^T N^-1 P) with the white (frequency-mean) noise level
        and squared Stokes weights (signed Q/U weights would cancel)."""
        diag = torch.zeros(self.n_m, dtype=torch.float32, device=self.device)
        for block in self.blocks:
            white = block["A_inv"].mean(dim=-1, keepdim=True).expand_as(block["data"])
            diag = diag + self._project_T(white, block, sw=block["sw"] ** 2)
        return self._reduce(diag)

    def _compute_naive_map(self):
        """The binned starting map and the hit map (weighted by |sw|, so
        Q/U weights do not cancel)."""
        hits = torch.zeros(self.n_m, dtype=torch.float32, device=self.device)
        raw = torch.zeros(self.n_m, dtype=torch.float32, device=self.device)
        for block in self.blocks:
            hits = hits + self._project_T(torch.ones_like(block["data"]), block, sw=block["sw"].abs())
            raw = raw + self._project_T(block["data"], block)
        hits, raw = self._reduce(hits), self._reduce(raw)
        self.hits = hits
        self.naive_map = torch.where(hits > 0, raw / torch.clamp(hits, min=1e-8), 0.0)

    # -- solvers ------------------------------------------------------------------------------

    def _solve_gd(self, rhs, m0, n_iters: int):
        """Steepest descent with exact line search on 1/2 m^T H m - rhs^T m,
        H = P^T N^-1 P."""
        m = m0
        for _ in range(n_iters):
            r = rhs - self._apply_PNP(m)
            denom = torch.dot(r, self._apply_PNP(r))
            alpha = torch.where(denom > 0, torch.dot(r, r) / torch.clamp(denom, min=1e-30), 0.0)
            m = m + alpha * r
        return m

    def _grid_to_map(self, m, weights):
        """The ProjectionMap of flat solution and weight vectors, each
        covered (stokes, nu, t) frame less its mean over its covered
        pixels, zero off them; on the host."""
        shape = (self.n_s, self.n_nu, self.t_bins, self.n_y, self.n_x)

        def grid(x):
            return x.view(self.n_s, self.n_nu, self.t_bins, self.n_pix1)[..., :-1].reshape(shape)

        m_grid, w_grid = grid(m), grid(weights)
        valid = grid(self.hits) > 0
        count = valid.sum(dim=(-2, -1), keepdim=True)
        mean = torch.where(valid, m_grid, 0.0).double().sum(dim=(-2, -1), keepdim=True) / count.clamp(min=1)
        data = torch.where(valid, m_grid - mean.float(), 0.0)
        weight = torch.where(valid, w_grid, 0.0)
        return self.make_map(data.cpu().numpy(), weight.cpu().numpy())

    def plot_noise_model(self, epoch: int = -1, ax=None):
        """The noise model of ``epoch``: each TOD's median detector PSD and,
        with k > 0, its modes' spectra (needs matplotlib). Returns the
        axes."""
        import matplotlib.pyplot as plt

        if not self.noise_model_history:
            raise RuntimeError("No noise model yet: call fit() first.")
        if ax is None:
            _, ax = plt.subplots(figsize=(6, 4), constrained_layout=True)
        for i, diag in enumerate(self.noise_model_history[epoch]):
            f = diag["f"][1:]
            ax.loglog(f, diag["median_psd"][1:], label=f"TOD {i} median PSD")
            if diag["mode_psd"] is not None:
                for j, mode in enumerate(diag["mode_psd"]):
                    ax.loglog(f, mode[1:], ls="--", lw=0.8, alpha=0.6, label=f"TOD {i} mode {j}" if j < 3 else None)
        n_epochs = len(self.noise_model_history)
        ax.set_title(f"noise model, epoch {epoch % n_epochs + 1}/{n_epochs}")
        ax.set_xlabel("frequency [Hz]")
        ax.set_ylabel(f"PSD [{self.tod_units}^2 / Hz]")
        ax.legend(fontsize=7)
        return ax

    def fit(self, method: str = "conjugate_gradient", epochs: int = None, steps_per_epoch: int = None,
            max_steps_per_epoch: int = None, plot: bool = False, plot_kwargs: dict = {}, fused: bool = True):
        """Alternate the noise-model update and the solve of the normal
        equations for ``epochs`` epochs (the constructor's n_epochs) of
        ``steps_per_epoch`` steps (alias ``max_steps_per_epoch``; the
        constructor's n_cg_iters), by ``method`` "conjugate_gradient" or
        "gradient_descent". The pixel weights are the last epoch's
        white-noise diagonal. With ``plot`` each epoch's map is plotted
        (``ProjectionMap.plot(**plot_kwargs)``; needs matplotlib).
        ``fused`` is the TPU's single-dispatch epoch and changes nothing
        here."""
        if method not in ("conjugate_gradient", "gradient_descent"):
            raise ValueError(f"Unknown solver '{method}'.")
        n_epochs = epochs if epochs is not None else self.n_epochs
        n_steps = steps_per_epoch or max_steps_per_epoch or self.n_cg_iters
        if self.init == "random":
            gen = torch.Generator(device=self.device).manual_seed(0)
            scale = float(self.naive_map.std(correction=0)) or 1.0
            m = scale * torch.randn(self.n_m, generator=gen, device=self.device, dtype=torch.float32)
        else:
            m = self.naive_map
        diag = None
        for epoch in range(n_epochs):
            self._update_noise_model(m)
            rhs = self._rhs()
            if method == "conjugate_gradient":
                diag = self._white_diag()
                inv_diag = torch.where(diag > 0, 1.0 / torch.clamp(diag, min=1e-30), 1.0)
                m = conjugate_gradient(self._apply_PNP, rhs, m, n_steps, inv_diag)
            else:
                m = self._solve_gd(rhs, m, n_steps)
            logger.info(f"ML mapper epoch {epoch + 1}/{n_epochs} done.")
            if plot:
                self._grid_to_map(m, self._white_diag()).plot(**plot_kwargs)
        self.m = m
        self.map = self._grid_to_map(m, diag if diag is not None else self._white_diag())
        return self.map

    run = fit
