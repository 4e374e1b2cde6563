"""Where the time of the MUSTANG-2 slice goes, on a CUDA card.

    python -m maria_torch.profile_slice [--duration 60] [--reps 10] [--trace PATH]

Prints, for the daisy scene of the given length: warm wall times of
``Simulation.run()`` and ``BinMapper.run()``; cumulative stage times of
the program (``fields(upto="pwv")``, ``upto="atmosphere"``, all fields)
and of the K_RJ conversion, each host-timed around a synchronize; and a
``torch.profiler`` table of device time by kernel over one run + map,
with the device's busy share of that window. ``--trace`` also writes the
Chrome trace. Needs a card: it fails without one.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch


def _wall_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / reps * 1e3


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--duration", type=float, default=60.0)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--trace", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA card")

    import maria_torch
    from maria_torch.mappers import BinMapper

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    device = torch.device("cuda")
    plan = maria_torch.get_plan(
        "daisy_5arcmin_60s", start_time=1.75e9, scan_center=(150.0, 41.0), frame="az/el",
        duration=args.duration, sample_rate=50.0, scan_options={"radius": 0.083, "speed": 0.017},
    )
    sim = maria_torch.Simulation(instrument="MUSTANG-2", plans=plan, site="GBT", atmosphere="2d",
                                 noise=True, seed=0, device=device)
    program = sim.program()
    gen = sim.generator
    tod = sim.run()[0]
    center = tuple(np.degrees(tod.boresight.center()))

    def run_map():
        return BinMapper(tod, center=center, width=0.25, resolution=0.25 / 128, frame="az/el").run()

    n = program.n_det * program.n_t
    print(f"card: {card}; scene {program.n_det} x {program.n_t} = {n} samples, {len(program.screens)} screens")
    stages = {
        "fields upto pwv": lambda: program.fields(generator=gen, device=device, upto="pwv"),
        "fields upto atmosphere": lambda: program.fields(generator=gen, device=device, upto="atmosphere"),
        "fields (all)": lambda: program.fields(generator=gen, device=device),
        "run_obs (fields + gains, pW)": lambda: sim.run_obs(0),
        "run() (+ K_RJ)": lambda: sim.run(),
        "BinMapper(...).run()": run_map,
    }
    for name, fn in stages.items():
        print(f"{name:32s} {_wall_ms(fn, args.reps):9.3f} ms (cumulative, warm, {args.reps} reps)")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        run_map()
        sim.run()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - start) * 1e3
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events if e.device_type is not None
                    and str(e.device_type).endswith("CUDA"))
    print(f"profiled window (run + map): {window_ms:.3f} ms wall, {device_us / 1e3:.3f} ms device "
          f"kernel time, device busy {device_us / 1e3 / window_ms:.1%} of the window")
    print(events.table(sort_by="self_cuda_time_total", row_limit=25))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
