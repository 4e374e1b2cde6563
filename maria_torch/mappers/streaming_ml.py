"""Maximum-likelihood map-making for observations whose TOD does not fit
the card (maria_tpu/mappers/streaming_ml.py).

The batch ``MaximumLikelihoodMapper`` builds its pointing blocks from a
TOD held whole. An observation synthesized by ``StreamingExecutor`` can
instead be ML-mapped a block at a time: the mapper accumulates the
normal equations' ingredients P^T N^-1 d and applies P^T N^-1 P per
streaming block, so the whole TOD never exists.

The model is maria_tpu's: one intensity map on the executor's (n_y, n_x)
grid; a noise covariance block-diagonal over streaming blocks and
circulant within each, its per-detector spectra the Welch power of the
map-subtracted residuals (8-bin boxcar smoothed) applied as rfft ->
1/PSD -> irfft a block; off-map samples have zero rows of P; the solved
map is zero-meaned over covered pixels. An epoch re-synthesizes the
TOD twice from the same seed (the noise model's pass, then the right-hand
side's) and runs the CG, which synthesizes nothing.

Where the port differs:
- P is the gather of the map at each block's pixel ids and P^T one launch
  of kernel K2 a block (``ops/bin_map.py``; the right-hand side's two
  channels, P^T N^-1 d and the white diagonal, in one launch).
- The residual of the noise model's pass is masked to the map: maria_tpu
  builds it from ``tod - P m`` with P m zero off the map, so an off-map
  sample feeds its whole signal into its detector's spectrum (ROADMAP
  queue 3, hazard 2). Where every sample lies on the map the two agree.
- The pixel ids of every block stay on the card when they fit
  ``id_budget`` bytes, counted with the transient peak of building one
  block's, and are recomputed a block at a time past it; both give the
  same map.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..ops.bin_map import bin_map
from ..ops.streaming_exec import PIXEL_ROWS
from .ml_mapper import smooth_spectrum

logger = logging.getLogger("maria_torch")

__all__ = ["StreamingMLMapper"]

ID_BUDGET = 4e9  # bytes of resident pixel ids
PIXEL_TEMPS = 16  # (slab, B) float32 temporaries of building one slab of ids (pixel_ids' transient)


def _hann(n: int, device):
    return 0.5 - 0.5 * torch.cos(2 * np.pi * torch.arange(n, device=device, dtype=torch.float32) / n)


class StreamingMLMapper:
    """ML map-making over a ``StreamingExecutor``'s blocks (see the module).

    ``n_epochs``, ``n_cg_iters`` and ``spectrum_smoothing`` are the
    reference fit's knobs; ``group_size`` is the executor's; ``use_runs``
    is maria_tpu's (its MXU pointing) and changes nothing here."""

    def __init__(self, executor, n_epochs: int = 2, n_cg_iters: int = 30, spectrum_smoothing: float = 8.0,
                 group_size: int = 8, use_runs: bool = None, id_budget: float = ID_BUDGET):
        self.ex = executor
        self.n_epochs = n_epochs
        self.n_cg_iters = n_cg_iters
        self.spectrum_smoothing = max(int(spectrum_smoothing), 1)
        self.group_size = group_size
        self.id_budget = float(id_budget)
        self.n_pix = executor.n_y * executor.n_x
        self._nf = executor.B // 2 + 1
        self._ids = None
        self._draws = None
        self.noise_model_history = []

    # -- pointing ------------------------------------------------------------------
    def id_bytes(self) -> dict:
        """{"resident": bytes of every block's ids, "transient": the peak
        of building one slab of them}."""
        ex = self.ex
        return {"resident": 4 * ex.n_blocks * ex.n_det * ex.B,
                "transient": 4 * ex.B * (ex.n_det + PIXEL_TEMPS * min(ex.n_det, PIXEL_ROWS))}

    @property
    def resident(self) -> bool:
        """Whether every block's pixel ids stay on the card."""
        b = self.id_bytes()
        return b["resident"] + b["transient"] <= self.id_budget

    def _block_ids(self, b: int):
        if not self.resident:
            return self.ex.pixel_ids(b)
        if self._ids is None:
            self._ids = [self.ex.pixel_ids(i) for i in range(self.ex.n_blocks)]
        return self._ids[b]

    def _project(self, m_flat, ids):
        """P m (n_det, B): the map at each sample's pixel, 0 off the map."""
        m1 = torch.cat([m_flat, m_flat.new_zeros(1)])
        return m1[torch.where(ids >= 0, ids, self.n_pix).long()]

    def _project_T(self, channels, ids):
        """P^T of (C, n_det, B) channels: (C, n_pix) sums, one K2 launch."""
        return bin_map(channels.contiguous(), ids, self.n_pix)

    # -- streamed passes -----------------------------------------------------------
    def _synthesis_pass(self, state0, kind: str, m_flat, A_inv=None):
        """Stream the synthesis once from ``state0``:
        "spec" -> (per-detector Welch power of the residuals masked to the
        map, full blocks only (n_det, n_f), the count of full blocks);
        "rhs" -> (P^T N^-1 d (n_pix,), the white-noise diagonal (n_pix,))."""
        ex = self.ex
        dev, B = ex.device, ex.B
        if kind == "spec":
            win = _hann(B, dev)
            spec_sum = torch.zeros((ex.n_det, self._nf), dtype=torch.float32, device=dev)
            n_full = 0
        else:
            rhs = torch.zeros(self.n_pix, dtype=torch.float32, device=dev)
            diag = torch.zeros(self.n_pix, dtype=torch.float32, device=dev)
            white = A_inv.mean(dim=-1, keepdim=True).expand(ex.n_det, B)
        for b, _, tod in ex._blocks(state0, with_map=False, draws=self._draws):
            ids = self._block_ids(b)
            if kind == "spec":
                if (b + 1) * B > ex.n_t:
                    continue
                resid = torch.where(ids >= 0, tod - self._project(m_flat, ids), 0.0)
                resid = resid - resid.mean(dim=-1, keepdim=True)
                spec_sum += torch.fft.rfft(resid * win, dim=-1).abs() ** 2 / (win**2).sum()
                n_full += 1
            else:
                w = torch.fft.irfft(A_inv * torch.fft.rfft(tod, dim=-1), n=B, dim=-1)
                s = self._project_T(torch.stack([w, white]), ids)
                rhs += s[0]
                diag += s[1]
        return (spec_sum, n_full) if kind == "spec" else (rhs, diag)

    def _apply_A(self, x_flat, A_inv):
        """P^T N^-1 P x, a block at a time."""
        ex = self.ex
        out = torch.zeros(self.n_pix, dtype=torch.float32, device=ex.device)
        for b in range(ex.n_blocks):
            ids = self._block_ids(b)
            Px = self._project(x_flat, ids)
            w = torch.fft.irfft(A_inv * torch.fft.rfft(Px, dim=-1), n=ex.B, dim=-1)
            out += self._project_T(w[None], ids)[0]
        return out

    def _cg_solve(self, m0, rhs, diag, A_inv, n_iters: int):
        """Jacobi-preconditioned CG on P^T N^-1 P m = rhs from m0, the
        scalars kept on the device (maria_tpu's recurrence)."""
        inv_diag = torch.where(diag > 0, 1.0 / torch.clamp(diag, min=1e-30), 1.0)
        r = rhs - self._apply_A(m0, A_inv)
        z = r * inv_diag
        m, p_vec, rz = m0, z, torch.dot(r, z)
        for _ in range(n_iters):
            Ap = self._apply_A(p_vec, A_inv)
            alpha = rz / torch.clamp(torch.dot(p_vec, Ap), min=1e-30)
            m = m + alpha * p_vec
            r = r - alpha * Ap
            z = r * inv_diag
            rz_new = torch.dot(r, z)
            beta = rz_new / torch.clamp(rz, min=1e-30)
            p_vec, rz = z + beta * p_vec, rz_new
        return m

    # -- public --------------------------------------------------------------------
    def fit(self, key: int = None, draws: dict = None, state: dict = None):
        """Stream the epochs; returns the solved (n_y, n_x) intensity map
        (numpy, zero-meaned over covered pixels). Also sets ``naive_map``,
        ``hits``, ``m`` and ``diag``. ``draws`` and ``state`` replace the
        generators as in ``StreamingExecutor.run``."""
        ex = self.ex
        key = 0 if key is None else int(key)
        state0 = ex.init_state(key, draws) if state is None else state  # every pass streams from it
        self._draws = draws
        naive = ex.run(key, group_size=self.group_size, state=state0, draws=draws)
        hits = naive.map_wgt
        covered = hits > 0
        m = torch.as_tensor(np.where(covered, naive.map_sum / np.clip(hits, 1e-8, None), 0.0).reshape(-1),
                            dtype=torch.float32, device=ex.device)
        self.naive_map = m.reshape(ex.n_y, ex.n_x).cpu().numpy()
        self.hits = hits
        diag = None
        for epoch in range(self.n_epochs):
            spec_sum, n_full = self._synthesis_pass(state0, "spec", m)
            spec = smooth_spectrum(spec_sum / max(float(n_full), 1.0), self.spectrum_smoothing)
            A_inv = 1.0 / torch.clamp(spec, min=1e-30)
            self.noise_model_history.append({
                "f": np.fft.rfftfreq(ex.B, d=1.0 / ex.program.sample_rate),
                "median_psd": np.median(spec[: ex.n_real_det].cpu().numpy(), axis=0),
            })
            rhs, diag = self._synthesis_pass(state0, "rhs", m, A_inv=A_inv)
            m = self._cg_solve(m, rhs, diag, A_inv, self.n_cg_iters)
            logger.info("streamed ML epoch %d/%d done", epoch + 1, self.n_epochs)
        m_np = m.reshape(ex.n_y, ex.n_x).cpu().numpy()
        m_np = np.where(covered, m_np - m_np[covered].mean(), 0.0)
        self.m = m_np
        self.diag = diag.reshape(ex.n_y, ex.n_x).cpu().numpy()
        return m_np

    run = fit
