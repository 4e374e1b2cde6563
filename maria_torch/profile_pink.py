"""K1's one-pass and two-pass forms on a CUDA card, to choose the
one-pass threshold of ``ops.pink_noise.pink_plan``.

    python -m maria_torch.profile_pink [--rows 217] [--reps 20]

For every n_fft that ``good_fft_size`` yields with m = n_fft/2 from 1024
to 9216 (the longest row whose one-pass block fits the card's shared
memory), it checks both forms against the plain version (|diff| <= 2e-4
x std) and times them and the plain version (``torch.fft.irfft``) with
CUDA events over ``--reps`` launches, in turns plain, one, two, two,
one, plain. Then, at the main path's shapes (217 rows; n_fft 3072,
32768, 65536 and 196608), ``torch.profiler`` over ``--reps`` calls of
``pink_noise`` gives each pass's device time a call beside the wall
time a call, and the device-memory bytes the plan moves over the
device time. Needs a card: it fails without one.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rows", type=int, default=217)
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_pink needs a CUDA card")

    from .atmosphere.fourier import good_fft_size
    from .noise import band_half_spectrum
    from .ops.pink_noise import launch, one_pass_plan, pink_noise_plain, two_pass_plan

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"card: {card}; {args.rows} rows, CUDA events over {args.reps} launches")
    print("| n_fft | m | one pass ms | two passes ms (n1 x n2, batch) | plain ms |")
    print("|---|---|---|---|---|")
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    sizes = sorted({r << k for r in (1, 3, 5, 9) for k in range(16) if 2048 <= r << k <= 18432})
    ok = True
    for n_fft in (v for v in sizes if good_fft_size(v) == v):
        c = band_half_spectrum(50.0, 5.0, 1.0, n_fft, corr_prop=0.5)
        S = torch.randn((args.rows, n_fft // 2 + 1, 2), generator=gen, device=device)
        one, two = one_pass_plan(n_fft // 2), two_pass_plan(n_fft // 2)
        ref = pink_noise_plain(c, S, n_fft, n_fft)
        for plan in (one, two):
            err = float((launch(plan, c, S, n_fft) - ref).abs().max())
            if not err <= 2e-4 * float(ref.std()):
                print(f"FAIL: n_fft {n_fft}, {plan['passes']} pass(es): max|diff| {err:.3e}")
                ok = False
        times = [_ms(fn, args.reps) for fn in (
            lambda: pink_noise_plain(c, S, n_fft, n_fft), lambda: launch(one, c, S, n_fft),
            lambda: launch(two, c, S, n_fft), lambda: launch(two, c, S, n_fft),
            lambda: launch(one, c, S, n_fft), lambda: pink_noise_plain(c, S, n_fft, n_fft),
        )]
        print(f"| {n_fft} | {n_fft // 2} | {(times[1] + times[4]) / 2:.4f} | {(times[2] + times[3]) / 2:.4f} "
              f"({two['n1']} x {two['n2']}, {two['batch']}) | {(times[0] + times[5]) / 2:.4f} |", flush=True)
    print("| rows x n, n_fft | passes | pass 1 us | pass 2 us | wall us a call | MB moved | GB/s on device |")
    print("|---|---|---|---|---|---|---|")
    for n, n_fft in ((3000, 3072), (30000, 32768), (60000, 65536), (180000, 196608)):
        ok &= _device_split(args.rows, n, n_fft, args.reps, gen)
    return 0 if ok else 1


def _device_split(rows: int, n: int, n_fft: int, reps: int, gen) -> bool:
    from torch.profiler import ProfilerActivity, profile

    from .noise import band_half_spectrum
    from .ops.pink_noise import pink_noise, pink_plan

    plan = pink_plan(n_fft)
    c = band_half_spectrum(50.0, 5.0, 1.0, n_fft, corr_prop=0.5)
    S = torch.randn((rows, n_fft // 2 + 1, 2), generator=gen, device="cuda")
    pink_noise(c, S, n, n_fft)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(reps):
            pink_noise(c, S, n, n_fft)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6 / reps
    passes = {e.key: e.self_device_time_total / reps for e in prof.key_averages() if "pink_pass" in e.key}
    p1 = sum(v for k, v in passes.items() if "pass1" in k)
    p2 = sum(v for k, v in passes.items() if "pass2" in k)
    m = plan["m"]
    moved = rows * (8 * (m + 1) + 4 * n + (16 * m if plan["passes"] == 2 else 0))
    print(f"| {rows} x {n}, {n_fft} | {plan['passes']} | {p1:.2f} | {p2:.2f} | {wall_us:.2f} | {moved / 1e6:.1f} | "
          f"{moved / ((p1 + p2) * 1e3):.1f} |", flush=True)
    return p1 > 0 and (p2 > 0) == (plan["passes"] == 2)


if __name__ == "__main__":
    raise SystemExit(main())
