"""K2 bin_map on a CUDA card: the sweep that fixes ``SAMPLES_PER_PIXEL``
in ``ops.bin_map.bin_plan``, and where a call's device time goes.

    python -m maria_torch.profile_bin [--reps 20] [--k 0.25,0.5,1,2,4,8]

At the pixel ids of the scenes chip_smoke.py drives (MUSTANG-2's daisy
at 60 s, 600 s and 1,200 s on BinMapper's 128 x 128 map of 0.25 deg,
slices (a), (b), (d); AtLAST-50k's 60 s daisy on the 128 x 128 field
map, slice (c)), in the two forms the port bins (two channels, as
BinMapper does; one channel and the in-kernel count, as bin_total
does), it runs K2 with at least k samples a pixel of a block's map for
each k, checks the hit counts against the plain version, and times it
with CUDA events over ``--reps`` launches, every k of a case in turns,
there and back. Then ``torch.profiler`` over ``--reps`` calls of
``bin_map`` at (a) and ``bin_total`` at (c) gives each kernel's device
time a call beside the wall time a call. Needs a card: it fails without
one.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
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


def _scene_ids(device) -> dict:
    """{label: (ids (n_det, n_t) int32, n_pix)} of slices (a), (b), (d) on
    BinMapper's 128 x 128 map of 0.25 deg and of slice (c) on the field
    map."""
    from .mappers.bin_mapper import azel_pixel_ids, field_pixel_ids
    from .scenes import simulation
    from .tod import Pointing

    n_map = 128
    out = {}
    for label, duration in (("a", 60.0), ("b", 600.0), ("d", 1200.0)):
        obs = simulation("mustang2", duration, device).obs_list[0]
        ids = azel_pixel_ids(Pointing(obs.boresight, obs.offsets), obs.boresight.center(), np.radians(0.25) / n_map,
                             n_map, n_map, device=device)
        out[label] = (ids.contiguous(), n_map * n_map)
    obs = simulation("atlast", 60.0, device).obs_list[0]
    out["c"] = field_pixel_ids(obs.boresight, obs.offsets, n_map, n_map, device=device)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--k", default="0.25,0.5,1,2,4,8")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_bin needs a CUDA card")

    from .ops.bin_map import SAMPLES_PER_PIXEL, _n_sm, bin_map_plain, bin_plan, launch

    ks = [float(k) for k in args.k.split(",")]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    device = torch.device("cuda")
    n_sm = _n_sm(torch.cuda.current_device())
    print(f"card: {card}; {n_sm} SMs; CUDA events over {args.reps} launches; bin_plan's k = {SAMPLES_PER_PIXEL}")
    print("| ids | samples | form | " + " | ".join(f"k={k:g} ms (blocks)" for k in ks) + " |")
    print("|---|---|---|" + "---|" * len(ks))
    gen = torch.Generator(device=device).manual_seed(0)
    ok = True
    scenes = _scene_ids(device)
    for label, (ids, n_pix) in scenes.items():
        data = torch.randn(ids.shape, generator=gen, device=device)
        for form, channels, count in (("2 channels", torch.stack([data, torch.ones_like(data)]), False),
                                      ("1 + count", data[None], True)):
            plans = [bin_plan(n_pix, channels.shape[0], ids.numel(), count, n_sm=n_sm, samples_per_pixel=k)
                     for k in ks]
            hits = bin_map_plain(channels, ids, n_pix, count=count)[-1]
            for plan in plans:
                ok &= bool(torch.equal(launch(plan, channels, ids, n_pix)[-1], hits))
            there = [_ms(lambda p=p: launch(p, channels, ids, n_pix), args.reps) for p in plans]
            back = [_ms(lambda p=p: launch(p, channels, ids, n_pix), args.reps) for p in reversed(plans)][::-1]
            cells = [f"{(a + b) / 2:.4f} ({p['blocks']})" for a, b, p in zip(there, back, plans)]
            print(f"| {label} | {ids.numel()} | {form} | " + " | ".join(cells) + " |", flush=True)
    if not ok:
        print("FAIL: a sweep's hit counts differ from the plain version's")
    from .mappers.bin_mapper import bin_total
    from .ops.bin_map import bin_map

    print("| call | kernel | device us a call | wall us a call | GB/s of the least bytes on the device |")
    print("|---|---|---|---|---|")
    ids, n_pix = scenes["a"]
    data = torch.randn(ids.shape, generator=gen, device=device)
    stacked = torch.stack([data, torch.ones_like(data)])
    ok &= _device_split("bin_map, 2 channels at (a)", lambda: bin_map(stacked, ids, n_pix), 12 * ids.numel(),
                        args.reps)
    ids, n_pix = scenes["c"]
    total = torch.randn(ids.shape, generator=gen, device=device) + 10
    ok &= _device_split("bin_total at (c)", lambda: bin_total(total, ids, n_pix), 8 * ids.numel(), args.reps)
    return 0 if ok else 1


def _device_split(name: str, fn, moved: int, reps: int) -> bool:
    """torch.profiler over ``reps`` calls of ``fn``: each kernel's device
    time a call, beside the wall time a call."""
    import time

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6 / reps
    rows = [(e.key, e.self_device_time_total / reps) for e in prof.key_averages()
            if e.self_device_time_total > 0 and not e.key.startswith(("aten::", "cuda", "Activity"))]
    for key, us in sorted(rows, key=lambda r: -r[1]):
        print(f"| {name} | {key[:60]} | {us:.2f} | {wall_us:.2f} | {moved / (us * 1e3):.1f} |", flush=True)
    return any("bin_map" in key for key, _ in rows)


if __name__ == "__main__":
    raise SystemExit(main())
