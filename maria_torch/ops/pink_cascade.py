"""The streaming pink cascade: kernel KC and its plain torch version.

``pink_cascade(w, state, p, a, row_table)`` runs, for every row of the
(rows, n) float32 innovations ``w`` with its table's poles p_k and signed
amplitudes a_k ((n_tables, K) float32) from the carried (rows, K) state,

    x_k <- p_k x_k + w_t,    pink_t = sum_k a_k x_k,

and returns (pink (rows, n), new state (rows, K)). ``row_table`` ((rows,)
int32) names each row's table; None means table 0 everywhere. On a CUDA
tensor it launches ``csrc/pink_cascade.cu`` (which replaces maria_tpu's
``PinkCascade.block``, noise/streaming.py:168), all rows and tables in
one launch; on a CPU tensor it runs the plain version,
``pink_cascade_plain``: maria_tpu's Toeplitz form of the same recurrence,
two matrix products and a state update over 1,024-sample sub-chunks with
float32 tables built in float64.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import kernels

__all__ = ["pink_cascade", "pink_cascade_plain", "toeplitz_tables", "CHUNK", "MAX_POLES"]

CHUNK = 1024  # sub-chunk of the Toeplitz form: the (c, c) table stays at 4 MB
MAX_POLES = 32  # the kernel's largest register count of states


@lru_cache(maxsize=32)
def _toeplitz_np(p_bytes: bytes, a_bytes: bytes, c: int) -> tuple:
    import scipy.linalg

    p64 = np.frombuffer(p_bytes, dtype=np.float32).astype(np.float64)
    a64 = np.frombuffer(a_bytes, dtype=np.float32).astype(np.float64)
    d = np.arange(c)
    pw = p64[:, None] ** d[None, :]  # (K, c)
    G = (a64[:, None] * pw).sum(0)  # (c,): the summed cascade's causal kernel
    LGT = scipy.linalg.toeplitz(G, np.zeros(c)).T  # (j, t) upper triangular: G(t - j)
    decay = a64[:, None] * p64[:, None] * pw  # (K, c): a_k p_k^(t+1)
    QT = (p64[:, None] ** (c - 1 - d)[None, :]).T  # (j, k): p_k^(c-1-j)
    return (LGT.astype(np.float32), decay.astype(np.float32), QT.astype(np.float32),
            (p64**c).astype(np.float32))


_DEVICE_TABLES = {}


def toeplitz_tables(p, a, c: int, device) -> tuple:
    """(LGT (c, c), decay (K, c), QT (c, K), p^c (K,)) float32 on
    ``device`` for one sub-chunk of length c of the cascade (p, a), built
    in float64 from the float32 poles and amplitudes as maria_tpu builds
    them (kept once a device)."""
    p_np = np.ascontiguousarray(torch.as_tensor(p).detach().cpu().numpy(), dtype=np.float32)
    a_np = np.ascontiguousarray(torch.as_tensor(a).detach().cpu().numpy(), dtype=np.float32)
    key = (p_np.tobytes(), a_np.tobytes(), int(c), str(device))
    if key not in _DEVICE_TABLES:
        if len(_DEVICE_TABLES) >= 32:
            _DEVICE_TABLES.clear()
        _DEVICE_TABLES[key] = tuple(torch.as_tensor(t, device=device) for t in _toeplitz_np(*key[:3]))
    return _DEVICE_TABLES[key]


def _toeplitz_rows(w, state, p, a):
    """The Toeplitz form for rows sharing one table (maria_tpu's order:
    y = w LGT, y += state decay, state = state p^c + w QT a sub-chunk)."""
    n = w.shape[-1]
    parts = []
    for i in range(0, n, CHUNK):
        wc = w[:, i:i + CHUNK]
        LGT, decay, QT, pc = toeplitz_tables(p, a, wc.shape[-1], w.device)
        y = torch.matmul(wc, LGT)
        y = y + torch.matmul(state, decay)
        state = state * pc + torch.matmul(wc, QT)
        parts.append(y)
    return (parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)), state


def _check(w, state, p, a, row_table):
    if w.ndim != 2 or w.dtype != torch.float32 or state.dtype != torch.float32:
        raise ValueError(f"w must be float32 (rows, n) and state float32, got {w.dtype} {tuple(w.shape)}, {state.dtype}")
    if p.ndim != 2 or p.shape != a.shape:
        raise ValueError(f"p and a must be (n_tables, K) tables of one shape, got {tuple(p.shape)}, {tuple(a.shape)}")
    if tuple(state.shape) != (w.shape[0], p.shape[1]):
        raise ValueError(f"state must be ({w.shape[0]}, {p.shape[1]}), got {tuple(state.shape)}")
    if row_table is not None and (row_table.dtype != torch.int32 or tuple(row_table.shape) != (w.shape[0],)):
        raise ValueError(f"row_table must be int32 ({w.shape[0]},)")
    if row_table is None and p.shape[0] != 1:
        raise ValueError("several tables need a row_table")
    for t in (state, p, a) + (() if row_table is None else (row_table,)):
        if t.device != w.device:
            raise ValueError("w, state, p, a and row_table must lie on one device")


def pink_cascade_plain(w, state, p, a, row_table=None):
    """The plain torch version: the Toeplitz form, table by table."""
    _check(w, state, p, a, row_table)
    if row_table is None:
        return _toeplitz_rows(w, state, p[0], a[0])
    pink = torch.empty_like(w)
    new_state = torch.empty_like(state)
    for t in torch.unique(row_table).tolist():
        rows = torch.nonzero(row_table == t).reshape(-1)
        pink[rows], new_state[rows] = _toeplitz_rows(w[rows], state[rows], p[t], a[t])
    return pink, new_state


def pink_cascade(w, state, p, a, row_table=None):
    """(pink (rows, n), new state (rows, K)) of the cascade; see the module."""
    _check(w, state, p, a, row_table)
    if w.device.type == "cpu":
        return pink_cascade_plain(w, state, p, a, row_table)
    if w.device.type != "cuda":
        raise ValueError(f"pink_cascade runs on cpu or cuda tensors, not {w.device.type}")
    K = p.shape[1]
    if K > MAX_POLES:
        raise ValueError(f"the kernel carries at most {MAX_POLES} poles, got {K}")
    w, state, p, a = (t.contiguous() for t in (w, state, p, a))
    pink = torch.empty_like(w)
    new_state = torch.empty_like(state)
    if w.numel() == 0:
        return pink, state.clone()
    table = None if row_table is None else row_table.contiguous()
    lib = kernels.load()
    stream = torch.cuda.current_stream(w.device).cuda_stream
    code = lib.maria_pink_cascade(
        w.data_ptr(), pink.data_ptr(), state.data_ptr(), new_state.data_ptr(), p.data_ptr(), a.data_ptr(),
        None if table is None else table.data_ptr(), w.shape[0], w.shape[1], K, stream,
    )
    kernels.check(lib, code, "pink_cascade kernel launch")
    pink_cascade.launches += 1
    return pink, new_state


pink_cascade.launches = 0
