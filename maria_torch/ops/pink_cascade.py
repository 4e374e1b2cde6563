"""The streaming pink cascade: kernel KC and its plain torch version.

``pink_cascade(w, state, p, a, row_table)`` runs, for every row of the
(rows, n) float32 innovations ``w`` with its table's poles p_k and signed
amplitudes a_k ((n_tables, K) float32) from the carried (rows, K) state,

    x_k <- p_k x_k + w_t,    pink_t = sum_k a_k x_k,

and returns (pink (rows, n), new state (rows, K)). ``row_table`` ((rows,)
int32) names each row's table; None means table 0 everywhere. On a CUDA
tensor it launches ``csrc/pink_cascade.cu`` (which replaces maria_tpu's
``PinkCascade.block``, noise/streaming.py:168), all rows and tables in
one launch, in the form ``cascade_plan`` picks from the shape: a thread a
row where rows are many, or each row's time split across G lanes with
the carried state composed through float64-built powers
(``split_tables``) where they are few. On a CPU tensor it runs the plain
version, ``pink_cascade_plain``: maria_tpu's Toeplitz form of the same
recurrence, two matrix products and a state update over 1,024-sample
sub-chunks with float32 tables built in float64.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import kernels

__all__ = ["pink_cascade", "pink_cascade_plain", "toeplitz_tables", "cascade_plan", "lane_fmas", "split_tables",
           "split_tables_np", "CHUNK", "MAX_POLES"]

CHUNK = 1024  # sub-chunk of the Toeplitz form: the (c, c) table stays at 4 MB
MAX_POLES = 32  # the kernel's largest register count of states
# The time split (csrc/pink_cascade.cu). A fixed count, not the card's,
# so that the order of the sums depends on the shape alone: the lanes
# that give each of an H100's 132 x 4 warp schedulers one warp.
FILL_LANES = 132 * 128
# G = 1 from these rows: a thread a row's time is flat up to FILL_LANES (at
# most a block an SM) while a warp a row's grows with the rows; on an H100
# they crossed between 10,560 and 12,672 rows (profile_cascade --sweep)
SPLIT_BELOW = 3 * FILL_LANES // 4
MIN_SEGMENT = 4  # least samples a lane walks
MIN_LANES = 32  # lanes a row where time is split: one warp
MAX_LANES = 256  # lanes a row: eight warps
ROW_TILE = 32  # samples a row and ring stage where G = 1
MAX_SEGMENT = 71  # most samples a lane walks a chunk: the row's table (2 S + 32 words a pole) stays under 23 KB
STAGE_FLOATS = 9216  # a split ring stage's floats: 36 KB, so three stages and two blocks fit an SM
POWERS = 32  # E's powers p^(S (j + 1)), j < 32 (kPowers)


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


def cascade_plan(rows: int, n: int) -> tuple:
    """(G, S): the lanes that share a row and the samples each walks. G = 1
    (a thread a row, S the ring's tile) from SPLIT_BELOW rows, or where a
    warp a row would leave a lane under MIN_SEGMENT samples; else the least power of two from MIN_LANES whose rows x G
    fill them, at most MAX_LANES and while every lane keeps MIN_SEGMENT
    samples, a row a block, with S = ceil(n / G) made odd (distinct
    shared-memory banks) and at most MAX_SEGMENT and what a ring stage
    holds (then a row runs in chunks of G x S)."""
    if rows >= SPLIT_BELOW or n < MIN_LANES * MIN_SEGMENT:
        return 1, ROW_TILE
    G = MIN_LANES
    while G < MAX_LANES and rows * G < FILL_LANES and n >= 2 * G * MIN_SEGMENT:
        G *= 2
    return G, segment_length(n, G)


def segment_length(n: int, G: int) -> int:
    """S for G >= MIN_LANES lanes a row: ceil(n / G) made odd, at most
    MAX_SEGMENT and what a ring stage holds (made odd too)."""
    cap = min(MAX_SEGMENT, STAGE_FLOATS // G)
    cap -= 1 - cap % 2
    S = -(-n // G)
    S += 1 - S % 2
    return min(S, cap)


def lane_fmas(n: int, K: int, G: int, S: int) -> int:
    """The FMAs of the split's longest lane, in order (every lane of a warp
    issues the same stream): n x 2K for G = 1, else, a chunk, pass A's and
    pass B's 3K S, K for each of the warp's five scan steps, K for each of
    the G / 32 - 1 warps composed before the last, K for its start and K
    for the carry."""
    if G == 1:
        return 2 * K * n
    return -(-n // (G * S)) * K * (3 * S + 5 + (G // 32 - 1) + 2)


def split_tables_np(p, a, S: int) -> np.ndarray:
    """(n_tables, K, 2 Sp + POWERS) float32: D = a p^(m+1) and Z = p^(m+1)
    for m < S (zero to Sp = S rounded up to 4), then E = p^(S (j+1)) for
    j < POWERS, each built in float64 from the float32 (p, a) and rounded
    once."""
    p64 = np.asarray(p, dtype=np.float32).astype(np.float64).reshape(-1, np.shape(p)[-1])
    a64 = np.asarray(a, dtype=np.float32).astype(np.float64).reshape(p64.shape)
    Sp = -(-S // 4) * 4
    Z = np.zeros(p64.shape + (Sp,))
    Z[..., :S] = p64[..., None] ** np.arange(1, S + 1)
    E = p64[..., None] ** (S * np.arange(1, POWERS + 1))
    return np.concatenate([a64[..., None] * Z, Z, E], axis=-1).astype(np.float32)


_SPLIT_TABLES = {}


def split_tables(p, a, S: int, device):
    """``split_tables_np`` of the (n_tables, K) tensors p, a on ``device``,
    kept once per (p, a, S, device). The key is the tensors' storage and
    version, so a block loop calling with the same p and a reads no device
    value; the entry holds p and a, so their storage is not reused while
    it is kept. Inference tensors track no version, so where p or a is
    one the key is their host bytes, as ``toeplitz_tables`` keys."""
    if p.is_inference() or a.is_inference():
        p_np = np.ascontiguousarray(p.detach().cpu().numpy(), dtype=np.float32)
        a_np = np.ascontiguousarray(a.detach().cpu().numpy(), dtype=np.float32)
        key = (p_np.tobytes(), a_np.tobytes(), tuple(p.shape), int(S), str(device))
    else:
        key = (p.data_ptr(), p._version, a.data_ptr(), a._version, tuple(p.shape), int(S), str(device))
    if key not in _SPLIT_TABLES:
        if len(_SPLIT_TABLES) >= 32:
            _SPLIT_TABLES.clear()
        table = split_tables_np(p.detach().cpu().numpy(), a.detach().cpu().numpy(), S)
        _SPLIT_TABLES[key] = (torch.as_tensor(table, device=device), p, a)
    return _SPLIT_TABLES[key][0]


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
    return launch(w, state, p, a, row_table, *cascade_plan(*w.shape))


def launch(w, state, p, a, row_table, G: int, S: int):
    """One launch of KC on CUDA tensors in the split (G, S) given (the
    wrapper's is ``cascade_plan``'s; a profile may force another). A width
    off a multiple of four, or a misaligned w, goes through a padded copy
    (the kernel's bulk copies move 16-byte rows)."""
    K = p.shape[1]
    if K > MAX_POLES:
        raise ValueError(f"the kernel carries at most {MAX_POLES} poles, got {K}")
    w, state, p, a = (t.contiguous() for t in (w, state, p, a))
    rows, n = w.shape
    new_state = torch.empty_like(state)
    if w.numel() == 0:
        return torch.empty_like(w), state.clone()
    table = None if row_table is None else row_table.contiguous()
    tables = split_tables(p, a, S, w.device) if G > 1 else None
    ld = -(-n // 4) * 4
    w_in = w
    if ld != n or w.data_ptr() % 16:
        w_in = torch.zeros((rows, ld), dtype=torch.float32, device=w.device)
        w_in[:, :n] = w
    out = torch.empty_like(w_in)
    lib = kernels.load()
    stream = torch.cuda.current_stream(w.device).cuda_stream
    code = lib.maria_pink_cascade(
        w_in.data_ptr(), out.data_ptr(), state.data_ptr(), new_state.data_ptr(), p.data_ptr(), a.data_ptr(),
        None if table is None else table.data_ptr(), None if tables is None else tables.data_ptr(), rows, n, ld, K,
        G, S, -(-S // 4) * 4, stream,
    )
    kernels.check(lib, code, "pink_cascade kernel launch")
    pink_cascade.launches += 1
    return (out if ld == n else out[:, :n].contiguous()), new_state


pink_cascade.launches = 0
