"""Where the time of a slice goes, on a CUDA card.

    python -m maria_torch.profile_slice [--scene mustang2|atlast] [--duration 60] [--reps 10] [--trace PATH]

Scene "mustang2" (the default): the MUSTANG-2 daisy through
``Simulation.run()`` and ``BinMapper.run()``; cumulative stage times of
the program (``fields(upto="pwv")``, ``upto="atmosphere"``, all fields)
and of the K_RJ conversion. Scene "atlast": AtLAST-50k with the 3-D
atmosphere through ``TODProgram.total_power_fn()`` and the field map
(``field_pixel_ids``, ``bin_total``); cumulative stage times
``fields(upto="pwv")``, ``upto="signal"``, the total, total + binning.
Each is host-timed around a synchronize; then a ``torch.profiler``
table of device time by kernel over one realization and its map, with
the device's busy share of that window. ``--trace`` also writes the
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
    parser.add_argument("--scene", choices=("mustang2", "atlast"), default="mustang2")
    parser.add_argument("--duration", type=float, default=60.0)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--trace", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA card")

    from maria_torch.mappers import BinMapper
    from maria_torch.mappers.bin_mapper import bin_total, field_pixel_ids
    from maria_torch.scenes import SCENES, simulation

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    device = torch.device("cuda")
    atlast = args.scene == "atlast"
    scene = SCENES[args.scene]
    sim = simulation(args.scene, args.duration, device)
    program = sim.program()
    gen = sim.generator
    n = program.n_det * program.n_t
    print(f"card: {card}; scene {scene['instrument']} {program.n_det} x {program.n_t} = {n} samples, "
          f"{len(program.screens)} screens, {sum(len(g.heights) for g in program.groups)} group layers")

    if atlast:
        fn = program.total_power_fn()
        obs = sim.obs_list[0]
        ids, n_pix = field_pixel_ids(obs.boresight, obs.offsets, 128, 128, device=device)

        def run_map():
            return bin_total(fn(generator=gen, device=device), ids, n_pix)

        def realization():
            run_map()

        stages = {
            "fields upto pwv": lambda: program.fields(generator=gen, device=device, upto="pwv"),
            "fields upto signal": lambda: program.fields(generator=gen, device=device, upto="signal"),
            "total_power_fn()": lambda: fn(generator=gen, device=device),
            "total + bin_total": run_map,
        }
    else:
        tod = sim.run()[0]
        center = tuple(np.degrees(tod.boresight.center()))

        def run_map():
            return BinMapper(tod, center=center, width=0.25, resolution=0.25 / 128, frame="az/el").run()

        def realization():
            run_map()
            sim.run()

        stages = {
            "fields upto pwv": lambda: program.fields(generator=gen, device=device, upto="pwv"),
            "fields upto atmosphere": lambda: program.fields(generator=gen, device=device, upto="atmosphere"),
            "fields (all)": lambda: program.fields(generator=gen, device=device),
            "run_obs (fields + gains, pW)": lambda: sim.run_obs(0),
            "run() (+ K_RJ)": lambda: sim.run(),
            "BinMapper(...).run()": run_map,
        }
    for name, stage in stages.items():
        print(f"{name:32s} {_wall_ms(stage, args.reps):9.3f} ms (cumulative, warm, {args.reps} reps)")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        realization()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - start) * 1e3
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events if e.device_type is not None
                    and str(e.device_type).endswith("CUDA"))
    print(f"profiled window (one realization and its map): {window_ms:.3f} ms wall, {device_us / 1e3:.3f} ms device "
          f"kernel time, device busy {device_us / 1e3 / window_ms:.1%} of the window")
    print(events.table(sort_by="self_cuda_time_total", row_limit=25))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
