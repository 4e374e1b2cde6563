"""Streaming 1/f noise for bounded-memory long observations
(maria_tpu/noise/streaming.py).

The batch generator (``noise/__init__.py``) draws pink noise with one
FFT over the whole observation: O(n_t) memory. This module streams the
same spectrum at O(1) state a detector: K AR(1) processes with
log-spaced poles p_k, all driven by ONE shared innovation stream w and
summed with signed amplitudes a_k (a K-pole rational filter whose
magnitude is fit to 1/f^beta on the host in float64):

    x_k,t = p_k x_k,t-1 + w_t,    pink_t = sum_k a_k x_k,t.

A block's output depends only on (carried state, the block's draws), so
any grouping of blocks gives the same stream. The spectrum matches the
batch generator's above ~1/T_ref and flattens below it; the structural
misfit of any rational filter at Nyquist is maria_tpu's too.

On the card a block of every band's rows runs as one launch of kernel KC
(``ops/pink_cascade.py``), which walks t with the K states in registers;
on the CPU it runs KC's plain version, maria_tpu's Toeplitz form. Every
draw comes from a ``torch.Generator`` or is handed in.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops.pink_cascade import pink_cascade

__all__ = ["PinkCascade", "StreamingBandNoise"]

# Cholesky jitters of the stationary start tried in turn
CHOL_JITTERS = (0.0, 1e-12, 1e-9, 1e-6)


@lru_cache(maxsize=64)
def _fit_cascade(sample_rate: float, knee: float, beta: float, T_ref: float, poles_per_decade: float):
    """Poles p_k and SIGNED amplitudes a_k (float32) so that the rational
    filter R(w) = sum_k a_k / (1 - p_k e^{-iw}) has |R|^2 matching the
    batch pink filter's 2 fs (knee/2) / f^beta on a log grid one decade
    below 1/T_ref up to Nyquist: alternating phase-fixing least squares
    from the incoherent NNLS start, as maria_tpu fits it (float64,
    scipy), so the float32 tables are maria_tpu's. The fit takes seconds,
    so it is kept for each set of arguments (the arrays are read-only)."""
    import scipy.optimize

    f_min = 1.0 / T_ref
    f_lo = f_min / 10
    f_max = sample_rate / 2
    n_decades = np.log10(f_max / f_lo)
    K = max(3, int(np.ceil(n_decades * poles_per_decade)) + 1)
    f_poles = np.geomspace(f_lo / 2, f_max, K)
    p = np.exp(-2 * np.pi * f_poles / sample_rate)

    f_grid = np.geomspace(f_lo, f_max * 0.999, 32 * K)
    w = 2 * np.pi * f_grid / sample_rate
    H = 1.0 / (1 - p[None, :] * np.exp(-1j * w[:, None]))  # (n_grid, K)
    target = 2 * sample_rate * (knee / 2) / f_grid**beta
    s = np.sqrt(target)
    Wt = 1.0 / s  # relative error metric, equal weight per octave

    def pink_err(a):
        return np.abs(np.log(np.abs(H @ a) ** 2 / target)).max()

    G = np.abs(H) ** 2
    A = G / target[:, None]
    col = np.linalg.norm(A, axis=0)
    res = scipy.optimize.lsq_linear(A / col, np.ones_like(target), bounds=(0.0, np.inf))
    a = np.sqrt(np.maximum(res.x, 0.0) / col)
    best_a, best_err = a.copy(), pink_err(a)

    Hw = H * Wt[:, None]
    M = np.concatenate([Hw.real, Hw.imag])
    for _ in range(120):
        R = H @ a
        phase = R / np.maximum(np.abs(R), 1e-30)
        rhs = s * phase * Wt
        a_new, *_ = np.linalg.lstsq(M, np.concatenate([rhs.real, rhs.imag]), rcond=None)
        if np.max(np.abs(a_new - a)) < 1e-10 * max(np.abs(a).max(), 1e-30):
            a = a_new
            break
        a = a_new
    err = pink_err(a)
    if err < best_err:
        best_a, best_err = a, err
    p32, a32 = p.astype(np.float32), best_a.astype(np.float32)
    p32.flags.writeable = a32.flags.writeable = False
    return p32, a32


class PinkCascade:
    """K AR(1) streams sharing ONE innovation stream; their signed sum
    has the pink spectrum. ``p`` and ``a`` are (K,) float32 numpy."""

    def __init__(self, sample_rate: float, knee: float, beta: float = 1.0, T_ref: float = 4096.0,
                 poles_per_decade: float = 2.0):
        self.sample_rate = float(sample_rate)
        self.knee = float(knee)
        self.p, self.a = _fit_cascade(float(sample_rate), float(knee), float(beta), float(T_ref),
                                      float(poles_per_decade))
        self.K = len(self.p)
        # stationary covariance of the shared-innovation states,
        # Cov(x_j, x_k) = 1 / (1 - p_j p_k); x0 = L z with C = L L^T
        p64 = self.p.astype(np.float64)
        C = 1.0 / (1.0 - np.outer(p64, p64))
        for jitter in CHOL_JITTERS:
            try:
                L = np.linalg.cholesky(C + jitter * np.diag(np.diag(C)))
                break
            except np.linalg.LinAlgError:
                continue
        else:
            raise np.linalg.LinAlgError("cascade stationary covariance is not PD")
        self.chol0 = L.astype(np.float32)
        self._tensors = {}

    def tensors(self, device) -> dict:
        """p, a (K,) and the start's Cholesky factor as float32 on ``device``."""
        key = str(device)
        if key not in self._tensors:
            f32 = dict(dtype=torch.float32, device=device)
            self._tensors[key] = {"p": torch.tensor(self.p, **f32), "a": torch.tensor(self.a, **f32),
                                  "chol0": torch.tensor(self.chol0, **f32)}
        return self._tensors[key]

    def init_state(self, rows: int, generator=None, z=None, device=None):
        """(rows, K) stationary start with the right cross-pole
        covariance, z @ L^T; ``z`` optionally supplies the (rows, K) normals."""
        if z is None:
            z = torch.randn((rows, self.K), generator=generator, device=device, dtype=torch.float32)
        else:
            z = torch.as_tensor(z if torch.is_tensor(z) else np.array(z, dtype=np.float32), dtype=torch.float32,
                                device=device)
        return z @ self.tensors(z.device)["chol0"].T

    def block(self, state, n: int, generator=None, w=None):
        """(new_state, pink (rows, n)): ``n`` samples on from ``state``
        (rows, K), driven by ``w`` ((rows, n) unit normals, drawn from
        ``generator`` when not given)."""
        if w is None:
            w = torch.randn((state.shape[0], n), generator=generator, device=state.device, dtype=torch.float32)
        t = self.tensors(state.device)
        pink, new_state = pink_cascade(w.to(torch.float32), state, t["p"][None], t["a"][None])
        return new_state, pink


class StreamingBandNoise:
    """Streaming counterpart of ``generate_noise_with_knee`` for one band:
    white + pink cascade + optional spatially correlated modes projected
    through the focal-plane basis. Unit NEP; scale outside."""

    def __init__(self, sample_rate, knee, beta=1.0, basis=None, corr_prop=0.0, T_ref=4096.0):
        self.sample_rate = float(sample_rate)
        self.knee = float(knee)
        self.basis = None if basis is None else np.asarray(basis, dtype=np.float32)
        self.corr_prop = float(corr_prop) if self.basis is not None else 0.0
        self.cascade = PinkCascade(sample_rate, knee, beta, T_ref=T_ref) if knee > 0 else None
        self._basis_t = {}

    @property
    def n_modes(self) -> int:
        """Rows of the correlated modes' cascade (0 without one)."""
        return self.basis.shape[-1] if self.cascade is not None and self.corr_prop > 0 else 0

    def basis_tensor(self, device):
        key = str(device)
        if key not in self._basis_t:
            self._basis_t[key] = torch.as_tensor(self.basis, dtype=torch.float32, device=device)
        return self._basis_t[key]

    def init_state(self, n_det: int, generator=None, z=None, device=None) -> tuple:
        """() without a cascade, else (det_state,) or, with correlated
        modes, (det_state, mode_state); ``z`` optionally supplies the
        normals as a tuple of the same shape ((n_det, K) and (k, K))."""
        if self.cascade is None:
            return ()
        det = self.cascade.init_state(n_det, generator, None if z is None else z[0], device)
        if self.n_modes:
            return (det, self.cascade.init_state(self.n_modes, generator, None if z is None else z[1], device))
        return (det,)

    def draw(self, n_det: int, n: int, generator=None, device=None) -> tuple:
        """(white (n_det, n), innovations (n_det, n), mode innovations
        (k, n) or None): one block's unit normals, in that order."""
        f32 = dict(dtype=torch.float32, device=device, generator=generator)
        white = torch.randn((n_det, n), **f32)
        if self.cascade is None:
            return white, None, None
        w = torch.randn((n_det, n), **f32)
        return white, w, (torch.randn((self.n_modes, n), **f32) if self.n_modes else None)

    def combine(self, white, pink, mode_pink, rows=None):
        """Unit-NEP noise of one block from its white draw and its
        cascades' outputs: sqrt(fs) white + sqrt(cp) basis @ mode_pink +
        sqrt(1 - cp) pink (the pink alone without modes); ``rows`` (a
        slice of the band) when the draws hold only those detectors."""
        noise = float(np.sqrt(np.float32(self.sample_rate))) * white
        if pink is None:
            return noise
        if mode_pink is not None:
            basis = self.basis_tensor(mode_pink.device)[slice(None) if rows is None else rows]
            pink = (float(np.sqrt(np.float32(self.corr_prop))) * basis) @ mode_pink + float(
                np.sqrt(np.float32(1 - self.corr_prop))) * pink
        return noise + pink

    def block(self, state, n_det: int, n: int, generator=None, draws=None):
        """(new_state, unit-NEP noise (n_det, n)); ``draws`` optionally
        gives (white, innovations, mode innovations) as ``draw`` makes them."""
        device = state[0].device if state else None
        white, w, w_modes = draws if draws is not None else self.draw(n_det, n, generator, device)
        if self.cascade is None:
            return state, self.combine(white, None, None)
        det_state, pink = self.cascade.block(state[0], n, w=w)
        if self.n_modes:
            mode_state, mode_pink = self.cascade.block(state[1], n, w=w_modes)
            return (det_state, mode_state), self.combine(white, pink, mode_pink)
        return (det_state,), self.combine(white, pink, None)
