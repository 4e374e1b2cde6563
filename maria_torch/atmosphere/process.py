"""Conditional-Gaussian autoregressive extrusion
(maria_tpu/atmosphere/process.py, ``AutoregressiveProcess``).

Each new edge row of a screen is drawn conditioned on an exponentially
decimated set of rows already extruded: row = A @ (those samples) +
B @ (white innovations). The covariance setup (Matérn matrices, the
propagator A = C_ES C_SS^-1 and the Cholesky factor B of the
conditional covariance) runs on the host in float64; the extrusion loop
runs in ``ops/ar_extrude.py``, on the card as one kernel for all of a
realization's processes.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..device import resolve_device
from ..utils import approximate_normalized_matern, fast_psd_inverse

logger = logging.getLogger("maria_torch")

__all__ = ["AutoregressiveProcess", "COV_MAT_JITTER", "JITTER_LADDER", "MIN_SAMPLES_PER_LAYER"]

COV_MAT_JITTER = 1e-6
# the diagonal jitters tried after the process's own while the covariance
# is numerically singular
JITTER_LADDER = (1e-6, 1e-4)
# least cross-section samples of one lookback ring, by default
MIN_SAMPLES_PER_LAYER = 4


class AutoregressiveProcess:
    def __init__(self, cross_section: np.ndarray, extrusion: np.ndarray,
                 callback=approximate_normalized_matern, callback_kwargs: dict = {}, jitter: float = 1e-8,
                 MIN_SAMPLES_PER_LAYER: int = MIN_SAMPLES_PER_LAYER):
        """``cross_section`` is (n_cross, 2) points in the (transverse,
        height) plane; ``extrusion`` is the 1-D grid along the extrusion
        axis. ``jitter`` is the covariance setup's first diagonal jitter,
        ``MIN_SAMPLES_PER_LAYER`` the least cross-section samples of a
        lookback ring."""
        self.cross_section = np.asarray(cross_section, dtype=float)
        self.extrusion = np.asarray(extrusion, dtype=float)
        self.callback = callback
        self.callback_kwargs = dict(callback_kwargs)
        self.jitter = jitter  # then the rung run_setup settled on
        self.n_cross_section = len(self.cross_section)
        self.n_extrusion = len(self.extrusion)

        # exponentially decimated lookback: extrusion indices 0, 1, 2, 4,
        # ..., n_extrusion - 1, the cross-section sampled at half the
        # density in each ring
        extrusion_indices = [
            0,
            *(2 ** np.arange(0, np.log2(max(self.n_extrusion, 2)))).astype(int),
            self.n_extrusion - 1,
        ]
        cross_idx, ext_idx = [], []
        for i, e_idx in enumerate(extrusion_indices):
            n_ring = int(np.clip(self.n_cross_section * 2**-i, MIN_SAMPLES_PER_LAYER, self.n_cross_section))
            c_idx = np.unique(np.linspace(0, self.n_cross_section - 1, n_ring).astype(int))
            cross_idx.append(c_idx)
            ext_idx.append(np.full(len(c_idx), e_idx))
        self.cross_section_sample_index = np.concatenate(cross_idx)
        self.extrusion_sample_index = np.concatenate(ext_idx)

        self.extrusion_res = float(np.gradient(self.extrusion).mean())
        self.sample_points = np.c_[
            self.extrusion[self.extrusion_sample_index],
            self.cross_section[self.cross_section_sample_index],
        ]
        self.n_sample = len(self.sample_points)
        # the live edge sits one extrusion step ahead of row 0
        self.live_edge_points = np.c_[
            np.full(self.n_cross_section, self.extrusion[0] - self.extrusion_res),
            self.cross_section,
        ]
        self.n_live_edge = self.n_cross_section
        if self.n_sample > 4000:
            logger.warning(f"Large covariance matrix (n_side={self.n_sample}); setup is O(n^3) on the host.")
        self.A = self.B = None  # float64 operators, set by run_setup
        self._computed = False
        self._device_cache = {}

    @property
    def n_steps(self) -> int:
        """Dependent steps of one extrusion: twice the screen's length,
        the first half a burn-in from the white initial buffer."""
        return 2 * self.n_extrusion

    @property
    def n_buffer(self) -> int:
        """Rows of the extrusion buffer: the steps plus the lookback."""
        return self.n_extrusion + self.n_steps

    def compute_covariance_matrices(self):
        """Host float64 setup of A and B."""
        def cov(p, q):
            d = np.sqrt(np.square(p[:, None] - q[None]).sum(axis=-1))
            return self.callback(d, **self.callback_kwargs)

        cov_ee = cov(self.live_edge_points, self.live_edge_points)
        np.fill_diagonal(cov_ee, 1.0 + self.jitter)
        cov_ee += np.diag(COV_MAT_JITTER * np.diag(cov_ee))
        cov_es = cov(self.live_edge_points, self.sample_points)
        cov_ss = cov(self.sample_points, self.sample_points)
        np.fill_diagonal(cov_ss, 1.0 + self.jitter)
        cov_ss += np.diag(COV_MAT_JITTER * np.diag(cov_ss))

        A = cov_es @ fast_psd_inverse(cov_ss)
        if (A.sum(axis=-1) > 1.0).any():
            raise ValueError(f"Propagation operator is unstable (max row sum = {A.sum(axis=-1).max():.4f}).")
        self.B = np.linalg.cholesky(cov_ee - A @ cov_es.T)
        self.A = A
        self._device_cache = {}
        self._computed = True

    def run_setup(self):
        """Factorize the covariance operators with the process's jitter,
        then up JITTER_LADDER while the matrices are numerically singular."""
        if self._computed:
            return
        for jitter in (self.jitter, *JITTER_LADDER):
            self.jitter = jitter
            try:
                self.compute_covariance_matrices()
                return
            except np.linalg.LinAlgError:
                logger.debug(f"Singular covariance with jitter={jitter}")
        raise np.linalg.LinAlgError("Covariance matrix singular at max jitter.")

    def tensors(self, device) -> dict:
        """A and B as float32, and the lookback indices as int64, on
        ``device`` (built once per device)."""
        self.run_setup()
        key = str(device)
        if key not in self._device_cache:
            self._device_cache[key] = {
                "A": torch.tensor(self.A, dtype=torch.float32, device=device),
                "B": torch.tensor(self.B, dtype=torch.float32, device=device),
                "ext_idx": torch.tensor(self.extrusion_sample_index, dtype=torch.int64, device=device),
                "cross_idx": torch.tensor(self.cross_section_sample_index, dtype=torch.int64, device=device),
            }
        return self._device_cache[key]

    def draw(self, generator=None, device=None):
        """(buffer_init, noise): the (n_buffer, n_cross) initial buffer and
        the (n_steps, n_cross) innovations, unit normals from
        ``generator`` in that order."""
        f32 = dict(dtype=torch.float32, device=device, generator=generator)
        buffer_init = torch.randn((self.n_buffer, self.n_cross_section), **f32)
        noise = torch.randn((self.n_steps, self.n_cross_section), **f32)
        return buffer_init, noise

    def run(self, generator=None, device=None) -> torch.Tensor:
        """A (n_extrusion, n_cross_section) float32 unit-variance screen,
        its draws from ``generator`` on ``device``: by default the
        generator's device, or the card when no generator is given."""
        from ..ops.ar_extrude import ar_extrude

        if device is None and generator is not None:
            device = generator.device
        buffer_init, noise = self.draw(generator, resolve_device(device))
        return ar_extrude([self], [buffer_init], [noise])[0]
