"""Detector pink noise: kernel K1 and its plain torch version.

``pink_noise(c, spectrum, n)`` computes x = irfft(c * S, n_fft)[..., :n]
per detector row, for a real half-spectrum amplitude ``c`` ((m+1,),
m = n_fft/2) and a draw ``S`` of unit complex normals, float32
(n_det, m+1, 2) [re, im], whose DC and Nyquist imaginary parts are
ignored. On a CUDA tensor it launches ``csrc/pink_noise.cu`` (which
replaces maria_tpu's ``pink_noise_pallas``); on a CPU tensor it runs the
plain version, ``torch.fft.irfft``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import kernels

__all__ = ["pink_noise", "pink_noise_plain", "pink_consts"]

_SINGLE_MAX = 512  # m at or below this takes one dense m-point DFT
_STAGE_BYTES = 16384  # shared memory for the staged stage-1 columns


def _best_split(m: int):
    best = None
    for f1 in range(2, int(np.sqrt(m)) + 1):
        if m % f1 == 0:
            best = (m // f1, f1)
    return best


@lru_cache(maxsize=16)
def _consts(n_fft: int, c_bytes: bytes):
    c = np.frombuffer(c_bytes, dtype=np.float32).astype(np.float64)
    m = n_fft // 2
    W = np.exp(2j * np.pi * np.arange(m) / n_fft)
    alpha = 0.5 * (1 + 1j * W) * c[:m]
    beta = 0.5 * (1 - 1j * W) * c[m - np.arange(m)]
    a0, b0 = alpha[0], beta[0]
    gamma = np.zeros(m, dtype=np.complex128)
    j = np.arange(1, m)
    gamma[j] = np.conj(beta[m - j])
    # the draw's k=0 slot carries the two real edge normals (z0, zm); their
    # constant-in-time contribution folds into both branches' k=0 weights
    alpha[0] = 0.5 * (a0 - 1j * b0)
    gamma[0] = np.conj(0.5 * (a0 + 1j * b0))
    split = _best_split(m) if m > _SINGLE_MAX else None
    n1, n2 = split if split is not None else (m, 1)
    return {"m": m, "n1": n1, "n2": n2, "alpha": alpha, "gamma": gamma}


def pink_consts(n_fft: int, c) -> dict:
    """Host constants of the folded transform (numpy port of
    maria_tpu's ``pink_consts``): m, the split m = n1 * n2 (n2 = 1 for
    m <= 512) and the complex weights alpha, gamma (m,)."""
    if n_fft % 2:
        raise ValueError("pink noise requires an even n_fft")
    c = np.ascontiguousarray(np.asarray(c, dtype=np.float32))
    if len(c) != n_fft // 2 + 1:
        raise ValueError(f"c must have n_fft//2 + 1 = {n_fft // 2 + 1} entries, got {len(c)}")
    return _consts(int(n_fft), c.tobytes())


@lru_cache(maxsize=16)
def _device_tables(n_fft: int, c_bytes: bytes, device: str):
    k = _consts(n_fft, c_bytes)

    def f2(z):
        return torch.as_tensor(np.stack([z.real, z.imag], axis=-1).astype(np.float32), device=device)

    return f2(k["alpha"]), f2(k["gamma"])


def pink_noise_plain(c, spectrum, n: int, n_fft: int = None):
    """Plain torch version: irfft(c * S, n_fft)[..., :n]."""
    m1 = spectrum.shape[-2]
    n_fft = 2 * (m1 - 1) if n_fft is None else int(n_fft)
    c = torch.as_tensor(np.asarray(c, dtype=np.float32), device=spectrum.device)
    edge = torch.ones(m1, dtype=spectrum.dtype, device=spectrum.device)
    edge[0] = 0.0
    edge[-1] = 0.0
    S = torch.complex(spectrum[..., 0], spectrum[..., 1] * edge)
    return torch.fft.irfft(c * S, n=n_fft, dim=-1)[..., :n]


def pink_noise(c, spectrum, n: int, n_fft: int = None):
    """(n_det, n) float32 noise rows x = irfft(c * S, n_fft)[..., :n]."""
    if spectrum.device.type == "cpu":
        return pink_noise_plain(c, spectrum, n, n_fft)
    if spectrum.device.type != "cuda":
        raise ValueError(f"pink_noise runs on cpu or cuda tensors, not {spectrum.device.type}")
    if spectrum.dtype != torch.float32 or spectrum.ndim != 3 or spectrum.shape[-1] != 2:
        raise ValueError(f"spectrum must be float32 (n_det, m+1, 2), got {spectrum.dtype} {tuple(spectrum.shape)}")
    if not spectrum.is_contiguous():
        raise ValueError("spectrum must be contiguous")
    n_det, m1 = spectrum.shape[0], spectrum.shape[1]
    n_fft = 2 * (m1 - 1) if n_fft is None else int(n_fft)
    if n_fft != 2 * (m1 - 1):
        raise ValueError(f"spectrum has {m1} bins; n_fft={n_fft} needs {n_fft // 2 + 1}")
    if not 0 < n <= n_fft:
        raise ValueError(f"n={n} must lie in (0, n_fft={n_fft}]")
    c_host = np.ascontiguousarray(np.asarray(c, dtype=np.float32))
    k = pink_consts(n_fft, c_host)
    m, n1, n2 = k["m"], k["n1"], k["n2"]
    tc = max(1, min(n2, _STAGE_BYTES // (8 * n1)))

    lib = kernels.load()
    device_index = spectrum.device.index if spectrum.device.index is not None else torch.cuda.current_device()
    smem = lib.maria_pink_noise_smem_bytes(m, n1, n2, tc)
    limit = lib.maria_max_dynamic_smem(device_index)
    if smem > limit:
        raise ValueError(
            f"pink_noise: n_fft={n_fft} needs {smem} bytes of shared memory per row "
            f"(split {n1} x {n2}), more than the card's {limit}"
        )
    alpha, gamma = _device_tables(n_fft, c_host.tobytes(), str(spectrum.device))
    out = torch.empty((n_det, n), dtype=torch.float32, device=spectrum.device)
    if n_det == 0:
        return out
    stream = torch.cuda.current_stream(spectrum.device).cuda_stream
    code = lib.maria_pink_noise(
        spectrum.data_ptr(), alpha.data_ptr(), gamma.data_ptr(), out.data_ptr(),
        n_det, m, n1, n2, tc, n, stream,
    )
    kernels.check(lib, code, "pink_noise kernel launch")
    pink_noise.launches += 1
    return out


pink_noise.launches = 0
