"""The spherical-harmonic transforms' Wigner-d recursion: kernels KS1
(``sht_synth``) and KS2 (``sht_anal``) and their plain torch versions.

Both walk the three-term recursion in l of every (m, ring) lane with a
shared power-of-2^60 exponent (maria_tpu/healpix/sht.py ``_lane_step``;
the layouts and the rescale are written out in ``csrc/sht.cu``):

- ``sht_synth(t, rows)``: rows (S, L, L) [s, l, m] -> acc (S, L, nh),
  acc[s, m, r] = sum_{l >= seed_step[m]} rows[s, l, m] d_l(m, r);
- ``sht_anal(t, h)``: h (S, L, nh) -> ys (S, L, L) [s, l, m],
  ys[s, l, m] = sum_r d_l(m, r) h[s, m, r].

``t`` holds one spin's tables as tensors on one device (``lane_tables``
in ``healpix/sht.py``): alpha, beta, gamma (L, L) [m, l]; the kernels'
packed coef (L, L, 4) [m, l] = (alpha, beta, gamma, 0), (0, 1, 0, 0) at
the seed step; seed_val (L, nh); seed_exp (L, nh) int32; seed_step (L,)
int32; z (nh,). S <= 8. On a CUDA tensor each launches its kernel; on a
CPU tensor it runs the plain version, which takes the same steps in torch
ops, every product and sum rounded on its own.
"""

from __future__ import annotations

import torch

from . import kernels

__all__ = ["MAX_PLANES", "sht_anal", "sht_anal_plain", "sht_synth", "sht_synth_plain"]

MAX_PLANES = 8
_BIG = 2.0**30
_DOWN = 2.0**-60
_UP = 2.0**60


def _active(seed_step, L: int) -> list:
    """The number of lanes m seeded by each step l: seed_step rises with
    m, so the lanes of step l are m < n[l]."""
    return torch.searchsorted(seed_step.to(torch.int64), torch.arange(L, device=seed_step.device),
                              right=True).tolist()


def _steps(t, L: int):
    """The plain recursion: yields (l, n, contrib) for every step l with
    n seeded lanes, contrib (n, nh) their values where the exponent is 0."""
    z = t["z"]
    nh = z.shape[0]
    lam = torch.zeros((L, nh), dtype=torch.float32, device=z.device)
    lam_prev = torch.zeros_like(lam)
    k = torch.zeros((L, nh), dtype=torch.int32, device=z.device)
    seed_step = t["seed_step"]
    for l, n in enumerate(_active(seed_step, L)):
        if n == 0:
            continue
        a, b, g = (t[name][:n, l, None] for name in ("alpha", "beta", "gamma"))
        rec = (a * z + b) * lam[:n] - g * lam_prev[:n]
        seed = (seed_step[:n] == l)[:, None]
        lam_prev[:n] = torch.where(seed, 0.0, lam[:n])
        lam[:n] = torch.where(seed, t["seed_val"][:n], rec)
        k[:n] = torch.where(seed, t["seed_exp"][:n], k[:n])
        mag = lam[:n].abs()
        big = mag > _BIG
        small = (mag < 1.0 / _BIG) & (k[:n] > 0)
        scale = torch.where(big, _DOWN, torch.where(small, _UP, 1.0))
        lam[:n] *= scale
        lam_prev[:n] *= scale
        k[:n] += big.to(torch.int32) * -1 + small.to(torch.int32)
        yield l, n, torch.where(k[:n] == 0, lam[:n], 0.0)


def _check(t, planes, name: str, shape_of):
    if planes.dtype != torch.float32 or planes.ndim != 3 or not 1 <= planes.shape[0] <= MAX_PLANES:
        raise ValueError(f"{name}: expected (S <= {MAX_PLANES}, ...) float32 planes, got {planes.dtype} "
                         f"{tuple(planes.shape)}")
    L, nh = t["seed_val"].shape
    if tuple(planes.shape[1:]) != shape_of(L, nh):
        raise ValueError(f"{name}: planes of shape {shape_of(L, nh)} expected, got {tuple(planes.shape[1:])}")
    for key in ("alpha", "beta", "gamma", "coef", "seed_val", "seed_exp", "seed_step", "z"):
        if t[key].device != planes.device:
            raise ValueError(f"{name}: table {key} lies on {t[key].device}, the planes on {planes.device}")
    return L, nh


def sht_synth_plain(t, rows):
    """Plain torch version of ``sht_synth``."""
    S, L = rows.shape[0], rows.shape[1]
    acc = torch.zeros((S, L, t["z"].shape[0]), dtype=torch.float32, device=rows.device)
    for l, n, contrib in _steps(t, L):
        acc[:, :n] += rows[:, l, :n, None] * contrib
    return acc


def sht_anal_plain(t, h):
    """Plain torch version of ``sht_anal``."""
    S, L = h.shape[0], h.shape[1]
    ys = torch.zeros((S, L, L), dtype=torch.float32, device=h.device)
    for l, n, contrib in _steps(t, L):
        ys[:, l, :n] = (h[:, :n] * contrib).sum(dim=-1)
    return ys


def _launch(fn, t, planes, out, L, nh, S):
    lib = kernels.load()
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    code = getattr(lib, fn)(
        *(t[k].data_ptr() for k in ("coef", "seed_val", "seed_exp", "seed_step", "z")),
        planes.data_ptr(), out.data_ptr(), L, nh, S, stream,
    )
    kernels.check(lib, code, f"{fn} kernel launch")


def _check_tables(t, L):
    for key, dtype in (("coef", torch.float32), ("seed_val", torch.float32), ("seed_exp", torch.int32),
                       ("seed_step", torch.int32), ("z", torch.float32)):
        if t[key].dtype != dtype or not t[key].is_contiguous():
            raise ValueError(f"table {key} must be contiguous {dtype}, got {t[key].dtype}")
    if tuple(t["coef"].shape) != (L, L, 4):
        raise ValueError(f"table coef must be ({L}, {L}, 4), got {tuple(t['coef'].shape)}")


def sht_synth(t, rows):
    """acc (S, L, nh) of the row planes ``rows`` (S, L, L) [s, l, m]."""
    L, nh = _check(t, rows, "sht_synth", lambda L, nh: (L, L))
    if rows.device.type == "cpu":
        return sht_synth_plain(t, rows)
    if rows.device.type != "cuda":
        raise ValueError(f"sht_synth runs on cpu or cuda tensors, not {rows.device.type}")
    _check_tables(t, L)
    S = rows.shape[0]
    # [m][l][s], the planes of a step in ceil(S / 4) float4s (the rest zero): one 16-byte copy a step
    packed = torch.zeros((L, L, 4 * -(-S // 4)), dtype=torch.float32, device=rows.device)
    packed[..., :S] = rows.permute(2, 1, 0)
    acc = torch.empty((S, L, nh), dtype=torch.float32, device=rows.device)
    _launch("maria_sht_synth", t, packed, acc, L, nh, S)
    sht_synth.launches += 1
    return acc


def sht_anal(t, h):
    """ys (S, L, L) [s, l, m] of the ring projections ``h`` (S, L, nh)."""
    L, nh = _check(t, h, "sht_anal", lambda L, nh: (L, nh))
    if h.device.type == "cpu":
        return sht_anal_plain(t, h)
    if h.device.type != "cuda":
        raise ValueError(f"sht_anal runs on cpu or cuda tensors, not {h.device.type}")
    _check_tables(t, L)
    lib = kernels.load()
    if nh > lib.maria_sht_max_rings():
        raise ValueError(f"sht_anal takes at most {lib.maria_sht_max_rings()} rings, got {nh}")
    ys = torch.zeros((h.shape[0], L, L), dtype=torch.float32, device=h.device)  # [s][m][l]; l < seed_step stays 0
    _launch("maria_sht_anal", t, h.contiguous(), ys, L, nh, h.shape[0])
    sht_anal.launches += 1
    return ys.transpose(1, 2)


sht_synth.launches = 0
sht_anal.launches = 0
