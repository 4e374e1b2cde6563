"""Shared-shape noise draw: kernel K3 and its plain torch version.

``shared_v(key, c, n_det)`` returns V, (n_det, 2(m+1)) bfloat16 rows
[re_0..re_m | im_0..im_m] of c * z with z standard complex normal per
(row, bin), the left operand of the noise matmul (``noise/dft.py``). The
bits come from a counter-based Philox4x32-10 keyed by ``key``, two
32-bit words in an int64 tensor (``draw_key``); the counter layout is
written out in ``csrc/shared_v.cu``. ``row0`` is the global index of the
first row: a rank holding detectors [row0, row0 + n_det) of a sharded
array draws exactly those rows of the unsharded V. On a CUDA tensor it launches that
kernel (which replaces maria_tpu's ``shared_v_pallas``); on a CPU tensor
it runs the plain version, the same Philox and Box-Muller in torch
integer and float ops.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import kernels

__all__ = ["draw_key", "shared_v", "shared_v_plain", "philox4x32_10"]

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_TWO_PI = float(np.float32(2 * np.pi))
ROWS_A_BLOCK = 8  # warps of the kernel's 256-thread block, one row each
BLOCKS_PER_SM = 8
N_SM = 132  # an H100 SXM's streaming multiprocessors


def draw_key(generator=None, device=None):
    """A Philox key drawn from ``generator``: two 32-bit words in an
    int64 tensor on ``device``. The same generator state gives the same
    key, and consecutive draws differ."""
    return torch.randint(0, 1 << 32, (2,), dtype=torch.int64, generator=generator, device=device)


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit words of a * m, for an int64 tensor a < 2^32 and a
    constant m < 2^32, without leaving int64: m is split in 16-bit halves,
    so every partial product stays below 2^48."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _M32
    return hi, lo


def philox4x32_10(ctr, key):
    """Philox4x32-10 on int64 tensors holding 32-bit words: ``ctr`` a
    4-tuple of broadcastable tensors, ``key`` a pair of ints or 0-d
    tensors. Returns the four output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _M32
        k1 = (k1 + _PHILOX_W[1]) & _M32
    return c0, c1, c2, c3


def _uniform24(bits):
    return ((bits >> 8).to(torch.float32) + 0.5) * float(2.0**-24)


def _box_muller(a, b):
    r = torch.sqrt(-2.0 * torch.log(_uniform24(a)))
    theta = _TWO_PI * _uniform24(b)
    return r * torch.cos(theta), r * torch.sin(theta)


@lru_cache(maxsize=16)
def _c_cached(c_bytes: bytes, device: str):
    return torch.as_tensor(np.frombuffer(c_bytes, dtype=np.float32).copy(), device=device)


def _c_tensor(c, device):
    return _c_cached(np.ascontiguousarray(np.asarray(c, dtype=np.float32)).tobytes(), str(device))


def _out_buffer(out, batch: int, n_det: int, m1: int, device):
    if out is None:
        return torch.empty((batch, n_det, 2 * m1), dtype=torch.bfloat16, device=device)
    if (out.dtype != torch.bfloat16 or out.ndim != 3 or tuple(out.shape[:2]) != (batch, n_det)
            or out.shape[2] < 2 * m1 or not out.is_contiguous()):
        raise ValueError(
            f"out must be contiguous bfloat16 ({batch}, {n_det}, ld >= {2 * m1}), "
            f"got {out.dtype} {tuple(out.shape)}"
        )
    if out.device != device:
        raise ValueError(f"out lies on {out.device}, the key on {device}")
    return out


def shared_v_plain(key=None, c=None, n_det: int = None, batch: int = 1, out=None, z=None, row0: int = 0):
    """Plain torch version of ``shared_v``. ``z`` optionally injects the
    draw, (n_det, 2, m+1) float32 normals [re, im] (batch 1): V is then
    bf16(c * z) in the same column order, with no Philox. Returns
    (batch, n_det, 2(m+1)), a view of ``out`` when given."""
    m1 = len(np.asarray(c))
    if z is not None:
        n_det = z.shape[0]
        if tuple(z.shape) != (n_det, 2, m1) or batch != 1:
            raise ValueError(f"z must be (n_det, 2, {m1}) with batch 1, got {tuple(z.shape)}")
        device = z.device
        V = (z.to(torch.float32) * _c_tensor(c, device)).reshape(1, n_det, 2 * m1)
    else:
        device = key.device
        n_pairs = (m1 + 1) // 2
        i64 = dict(dtype=torch.int64, device=device)
        p = torch.arange(n_pairs, **i64)[None, None, :]
        row = torch.arange(row0, row0 + n_det, **i64)[None, :, None]
        b = torch.arange(batch, **i64)[:, None, None]
        k0, k1 = (int(v) for v in key.tolist())
        x0, x1, x2, x3 = philox4x32_10((p, row, b, torch.zeros((), **i64)), (k0, k1))
        shape = (batch, n_det, n_pairs)
        re_even, im_even = _box_muller(x0.expand(shape), x1.expand(shape))
        re_odd, im_odd = _box_muller(x2.expand(shape), x3.expand(shape))
        # bin 2p from words (x0, x1), bin 2p + 1 from (x2, x3)
        re = torch.stack([re_even, re_odd], dim=-1).reshape(batch, n_det, 2 * n_pairs)[..., :m1]
        im = torch.stack([im_even, im_odd], dim=-1).reshape(batch, n_det, 2 * n_pairs)[..., :m1]
        cc = _c_tensor(c, device)
        V = torch.cat([cc * re, cc * im], dim=-1)
    V = V.to(torch.bfloat16)
    if out is None:
        return V
    buf = _out_buffer(out, batch, n_det, m1, device)
    buf[..., : 2 * m1] = V
    return buf[..., : 2 * m1]


def shared_v(key, c, n_det: int, batch: int = 1, out=None, row0: int = 0):
    """(batch, n_det, 2(m+1)) bfloat16 V for realizations 0..batch-1 of
    ``key`` (an int64 tensor of two 32-bit words, ``draw_key``): rows
    row0 .. row0 + n_det - 1 of the unsharded draw. ``out``
    optionally gives the buffer, (batch, n_det, ld >= 2(m+1)) contiguous
    bfloat16, whose first 2(m+1) columns are written; the returned
    tensor is a view of it."""
    if row0 < 0 or row0 + n_det > 1 << 32:
        raise ValueError(f"rows [{row0}, {row0 + n_det}) lie outside the counter's 32-bit row word")
    if key.device.type == "cpu":
        return shared_v_plain(key, c, n_det, batch=batch, out=out, row0=row0)
    if key.device.type != "cuda":
        raise ValueError(f"shared_v runs on cpu or cuda tensors, not {key.device.type}")
    if key.dtype != torch.int64 or tuple(key.shape) != (2,) or not key.is_contiguous():
        raise ValueError(f"key must be a contiguous int64 (2,) tensor, got {key.dtype} {tuple(key.shape)}")
    m1 = len(np.asarray(c))
    buf = _out_buffer(out, batch, n_det, m1, key.device)
    n_rows = batch * n_det
    if n_rows == 0 or m1 == 0:
        return buf[..., : 2 * m1]
    c_dev = _c_tensor(c, key.device)
    lib = kernels.load()
    # one warp a row, ROWS_A_BLOCK rows a block, at most BLOCKS_PER_SM blocks an SM
    n_blocks = int(min(-(-n_rows // ROWS_A_BLOCK), BLOCKS_PER_SM * N_SM))
    stream = torch.cuda.current_stream(key.device).cuda_stream
    code = lib.maria_shared_v(
        key.data_ptr(), c_dev.data_ptr(), buf.data_ptr(), batch, n_det, m1, buf.shape[2], row0, n_blocks, stream,
    )
    kernels.check(lib, code, "shared_v kernel launch")
    shared_v.launches += 1
    return buf[..., : 2 * m1]


shared_v.launches = 0
