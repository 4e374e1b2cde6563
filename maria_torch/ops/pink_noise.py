"""Detector pink noise: kernel K1 and its plain torch version.

``pink_noise(c, spectrum, n)`` computes x = irfft(c * S, n_fft)[..., :n]
per detector row, for a real half-spectrum amplitude ``c`` ((m+1,),
m = n_fft/2) and a draw ``S`` of unit complex normals, float32
(n_det, m+1, 2) [re, im], whose DC and Nyquist imaginary parts are
ignored. On a CUDA tensor it launches ``csrc/pink_noise.cu`` (which
replaces maria_tpu's ``pink_noise_pallas``) as ``pink_plan`` lays it
out; on a CPU tensor it runs the plain version, ``torch.fft.irfft``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import kernels

__all__ = ["pink_noise", "pink_noise_plain", "pink_consts", "pink_plan", "one_pass_plan", "two_pass_plan", "launch"]

# m at or below this runs as one pass, a whole row's FFT in one block:
# the largest m whose one-pass block (24 m bytes) fits the H100's
# 232,448 bytes of shared memory; one pass measured faster than two at
# every such length (PERF.md; python -m maria_torch.profile_pink)
ONE_PASS_MAX = 9216
TWO_PASS_SMEM = 48 * 1024  # a two-pass block's shared memory, so several blocks share an SM
MAX_BATCH = 16  # short FFTs a two-pass block does, one per column of its tile
THREADS = 256
ODD_PARTS = (1, 3, 5, 9)  # the odd parts good_fft_size yields; the kernel has these radices


def odd_part(length: int) -> int:
    while length % 2 == 0:
        length //= 2
    return length


def fft_smem_bytes(length: int, batch: int) -> int:
    """Shared memory of a block that does ``batch`` ``length``-point FFTs:
    two ping-pong buffers of ``length`` rows of ``batch`` complex values
    (rows padded by one value when batch > 1, which keeps the transposed
    reads free of bank conflicts) and the ``length``-entry twiddle table.
    The kernel lays its shared memory out the same way
    (``fft_smem_bytes`` in csrc/pink_noise.cu)."""
    ld = batch + (batch > 1)
    return 8 * (2 * length * ld + length)


def _batch(length: int, other: int) -> int:
    """Columns of a two-pass tile: the largest power of two <= MAX_BATCH
    that divides the other factor and keeps the block within
    TWO_PASS_SMEM (at least 1)."""
    b = MAX_BATCH
    while b > 1 and (other % b or fft_smem_bytes(length, b) > TWO_PASS_SMEM):
        b //= 2
    return b


@lru_cache(maxsize=64)
def pink_plan(n_fft: int) -> dict:
    """How K1 computes one row's m-point FFT, m = n_fft/2 = r 2^q with
    r in {1, 3, 5, 9}: ``one_pass_plan`` for m <= ONE_PASS_MAX, else
    ``two_pass_plan``. Returns passes, m, n1, n2, batch (short FFTs a
    block does, per pass), threads and smem (bytes a block, per pass)."""
    if n_fft % 2:
        raise ValueError("pink noise requires an even n_fft")
    m = n_fft // 2
    if odd_part(m) not in ODD_PARTS:
        raise ValueError(f"n_fft={n_fft}: m's odd part {odd_part(m)} is not one of {ODD_PARTS} (see good_fft_size)")
    return one_pass_plan(m) if m <= ONE_PASS_MAX else two_pass_plan(m)


def one_pass_plan(m: int) -> dict:
    """The row in one block: one m-point FFT, n1 = m, n2 = 1."""
    return {"passes": 1, "m": m, "n1": m, "n2": 1, "batch": (1,), "threads": THREADS, "smem": (fft_smem_bytes(m, 1),)}


def two_pass_plan(m: int) -> dict:
    """Two passes through device memory, with the split m = n1 * n2
    nearest sqrt(m) (n1 >= n2) whose factors' odd parts are in
    {1, 3, 5, 9}."""
    splits = []
    for r1 in ODD_PARTS:
        n1 = r1
        while n1 < m:
            if m % n1 == 0 and n1 > 1 and odd_part(m // n1) in ODD_PARTS:
                splits.append((max(n1, m // n1), -n1, n1))
            n1 *= 2
    n1 = min(splits)[2]
    n2 = m // n1
    batch = (_batch(n1, n2), _batch(n2, n1))
    smem = (fft_smem_bytes(n1, batch[0]), fft_smem_bytes(n2, batch[1]))
    if max(smem) > TWO_PASS_SMEM:
        raise ValueError(f"m={m}: split {n1} x {n2} needs {max(smem)} bytes a block, beyond two passes' reach")
    return {"passes": 2, "m": m, "n1": n1, "n2": n2, "batch": batch, "threads": THREADS, "smem": smem}


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
    return {"m": m, "alpha": alpha, "gamma": gamma}


def pink_consts(n_fft: int, c) -> dict:
    """Host constants of the folded transform (numpy port of
    maria_tpu's ``pink_consts``): m and the complex weights alpha,
    gamma (m,)."""
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
    m1 = spectrum.shape[1]
    n_fft = 2 * (m1 - 1) if n_fft is None else int(n_fft)
    if n_fft != 2 * (m1 - 1):
        raise ValueError(f"spectrum has {m1} bins; n_fft={n_fft} needs {n_fft // 2 + 1}")
    if not 0 < n <= n_fft:
        raise ValueError(f"n={n} must lie in (0, n_fft={n_fft}]")
    return launch(pink_plan(n_fft), c, spectrum, n)


def launch(plan: dict, c, spectrum, n: int):
    """Launch K1 as ``plan`` (from ``pink_plan``) lays it out, on a checked
    CUDA spectrum; the two-pass form's scratch B (n_det, n2, n1) complex
    comes from torch's allocator."""
    c_host = np.ascontiguousarray(np.asarray(c, dtype=np.float32))
    if len(c_host) != plan["m"] + 1:
        raise ValueError(f"c must have m + 1 = {plan['m'] + 1} entries, got {len(c_host)}")
    lib = kernels.load()
    device_index = spectrum.device.index if spectrum.device.index is not None else torch.cuda.current_device()
    limit = lib.maria_max_dynamic_smem(device_index)
    if max(plan["smem"]) > limit:
        raise ValueError(f"pink_noise: plan {plan} needs more shared memory a block than the card's {limit} bytes")
    alpha, gamma = _device_tables(2 * plan["m"], c_host.tobytes(), str(spectrum.device))
    n_det = spectrum.shape[0]
    out = torch.empty((n_det, n), dtype=torch.float32, device=spectrum.device)
    if n_det == 0:
        return out
    scratch = None
    if plan["passes"] == 2:
        scratch = torch.empty((n_det, plan["m"], 2), dtype=torch.float32, device=spectrum.device)
    batch = (*plan["batch"], 1)[:2]
    stream = torch.cuda.current_stream(spectrum.device).cuda_stream
    code = lib.maria_pink_noise(
        spectrum.data_ptr(), alpha.data_ptr(), gamma.data_ptr(),
        None if scratch is None else scratch.data_ptr(), out.data_ptr(),
        n_det, plan["m"], plan["n1"], plan["n2"], batch[0], batch[1], plan["threads"], n, stream,
    )
    kernels.check(lib, code, "pink_noise kernel launch")
    pink_noise.launches += 1
    return out


pink_noise.launches = 0
