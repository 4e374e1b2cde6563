"""KS1 and KS2 on a CUDA card, beside an earlier form of the same kernels
from another checkout, at the CMB's full width.

    python -m maria_torch.profile_sht [--parent DIR] [--reps 5]

At nside 1024 and lmax 2500 it draws one CMB's aT, aE and aB on the card
(``synalm_cmb_device``, seed 0), makes their maps, and builds the launches
of the four transforms (``synth_inputs``, ``anal_inputs``): the scalar and
spin-2 synthesis (KS1, one and two launches of four planes) and analysis
(KS2). It times this tree's kernels with CUDA events over ``--reps``
launches a turn and, with ``--parent``, the kernels of the checkout in
DIR (for example ``git archive <commit>`` unpacked into ``build/parent``):
that tree's ``maria_torch/csrc/sht.cu`` is compiled alone with nvcc into
a library of its own and called through the C interface of the earlier
form (alpha, beta and gamma as three (L, L) [m][l] tables, rows (S, L, L)
[s][m][l]), in turns parent, this, this, parent. It prints the share of
elements equal between the two (KS1 must be 1: both are bit-equal to the
plain version), KS2's largest difference over each plane's maximum, and
each time's share of the bound and of the rounding contract's instruction bound
(``chip_smoke.sht_bound``'s counts). As a yardstick only, never called by
the port: a float32 ``torch.bmm`` of the row planes against a Wigner-d
table of the lanes m < ``--band`` (random values: the table's
construction is left out), scaled by lane-steps to the whole m <= l
triangle. Needs a card: it fails without one.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess

import torch

NSIDE, LMAX = 1024, 2500
# 132 SMs x 4 sub-partitions x 32 lanes at 1.98 GHz; HBM bytes/s; float32
# operations/s outside the tensor cores (the H100 SXM's published peaks)
LANE_INSTRUCTIONS_S = 67e12 / 2
HBM_BYTES_S = 3.35e12
F32_OPS = 67e12


def _ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _parent_library(parent: str):
    """The earlier sht.cu of the checkout ``parent``, compiled alone."""
    from .ops import kernels

    source = os.path.join(parent, "maria_torch", "csrc", "sht.cu")
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(os.path.dirname(kernels.library_path()), f"libparent_sht_{digest}.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS[:-1], "-shared", "-o", out, source], check=True,
                       capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.maria_sht_synth, lib.maria_sht_anal):
        fn.argtypes = [p] * 9 + [i, i, i, p]
        fn.restype = i
    return lib


def _parent_call(lib, synth: bool, t, x):
    """One launch of the earlier kernel on the same tables and planes."""
    L, nh = t["seed_val"].shape
    S = x.shape[0]
    if synth:
        planes = x.transpose(1, 2).contiguous()
        out = torch.empty((S, L, nh), dtype=torch.float32, device=x.device)
        fn = lib.maria_sht_synth
    else:
        planes = x.contiguous()
        out = torch.zeros((S, L, L), dtype=torch.float32, device=x.device)
        fn = lib.maria_sht_anal
    code = fn(*(t[k].data_ptr() for k in ("alpha", "beta", "gamma", "seed_val", "seed_exp", "seed_step", "z")),
              planes.data_ptr(), out.data_ptr(), L, nh, S, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"the earlier {'KS1' if synth else 'KS2'} failed to launch: CUDA error {code}")
    return out if synth else out.transpose(1, 2)


def _counts(launches, synth: bool):
    """(lane-steps, contract instructions, flops, bytes) of a launch set,
    as chip_smoke.sht_bound counts them."""
    steps = instr = flops = n_bytes = 0
    for t, x in launches:
        L, nh = t["seed_val"].shape
        S = x.shape[0]
        n = nh * int((L - t["seed_step"].clamp(max=L)).sum())
        steps += n
        instr += n * (5 + (2 * S if synth else S))
        flops += n * (5 + 2 * S)
        n_bytes += 4 * (4 * L * L + 2 * L * nh + L + nh) + 4 * S * L * L + 4 * S * L * nh
    return steps, instr, flops, n_bytes


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", default=None, help="a checkout holding the earlier maria_torch/csrc/sht.cu")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--band", type=int, default=128, help="lanes m < band of the bmm yardstick")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_sht needs a CUDA card")

    from .cmb import get_cmb_spectrum
    from .healpix.sht import alm2map, alm2map_spin, anal_inputs, synalm_cmb_device, synth_inputs
    from .ops.sht import sht_anal, sht_synth

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    aT, aE, aB = synalm_cmb_device(get_cmb_spectrum(lmax=LMAX), LMAX, generator=gen)
    T, (Q, U) = alm2map(aT, NSIDE), alm2map_spin(aE, aB, NSIDE)
    cases = {"KS1 scalar": (True, synth_inputs(aT, NSIDE)), "KS1 spin-2": (True, synth_inputs(aB, NSIDE, e=aE)),
             "KS2 scalar": (False, anal_inputs(T, LMAX)), "KS2 spin-2": (False, anal_inputs(Q, LMAX, U=U))}
    parent = _parent_library(args.parent) if args.parent else None
    print(f"card: {card}; nside {NSIDE}, lmax {LMAX}; CUDA events over {args.reps} launches a turn"
          f"{'; parent ' + args.parent if parent else ''}", flush=True)
    print("| launches | this tree ms | earlier ms | equal share | max diff / plane max | bound ms | contract "
          "bound ms | share of the contract bound (this, earlier) |", flush=True)
    print("|---|---|---|---|---|---|---|---|", flush=True)
    for name, (synth, launches) in cases.items():
        kernel = sht_synth if synth else sht_anal

        def ours():
            return [kernel(t, x) for t, x in launches]

        def earlier():
            return [_parent_call(parent, synth, t, x) for t, x in launches]

        _, instr, flops, n_bytes = _counts(launches, synth)
        bound_ms = max(flops / F32_OPS, n_bytes / HBM_BYTES_S) * 1e3
        contract_ms = instr / LANE_INSTRUCTIONS_S * 1e3
        if parent is None:
            ms, old_ms, equal, diff = _ms(ours, args.reps), float("nan"), float("nan"), float("nan")
        else:
            a, b = ours(), earlier()
            torch.cuda.synchronize()
            equal = sum(int((x == y).sum()) for x, y in zip(a, b)) / sum(x.numel() for x in a)
            diff = max(float((x[s] - y[s]).abs().max() / y[s].abs().max()) for x, y in zip(a, b)
                       for s in range(x.shape[0]))
            del a, b
            o1, n1 = _ms(earlier, args.reps), _ms(ours, args.reps)
            n2, o2 = _ms(ours, args.reps), _ms(earlier, args.reps)
            ms, old_ms = (n1 + n2) / 2, (o1 + o2) / 2
        print(f"| {name}, {len(launches)} x {tuple(launches[0][1].shape)} | {ms:.4f} | {old_ms:.4f} | {equal:.6f} | "
              f"{diff:.2e} | {bound_ms:.4f} | {contract_ms:.4f} | {contract_ms / ms:.1%}, "
              f"{contract_ms / old_ms:.1%} |", flush=True)

    t, rows = cases["KS1 scalar"][1][0]
    steps, *_ = _counts([(t, rows)], True)
    M, (L, nh) = args.band, t["seed_val"].shape
    table = torch.randn((M, nh, L), generator=gen, device=device)
    planes = rows[:, :, :M].permute(2, 1, 0).contiguous()  # (M, L, S)
    bmm_ms = _ms(lambda: torch.bmm(table, planes), args.reps)
    print(f"yardstick (not a port of anything, never called by the port): torch.bmm of the 4 row planes against a "
          f"({M}, {nh}, {L}) float32 Wigner-d table (its construction left out) {bmm_ms:.4f} ms, "
          f"{bmm_ms * steps / (M * nh * L):.4f} ms scaled to the triangle's {steps:.3e} lane-steps", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
