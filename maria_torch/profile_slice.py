"""Where the time of a slice goes, on a CUDA card.

    python -m maria_torch.profile_slice [--scene mustang2|atlast|sky] [--map FAMILY] [--duration 60] [--reps 10]
                                        [--trace PATH]

Scene "mustang2" (the default): the MUSTANG-2 daisy through
``Simulation.run()`` and ``BinMapper.run()``; cumulative stage times of
the program (``fields(upto="pwv")``, ``upto="atmosphere"``, all fields)
and of the K_RJ conversion. Scene "atlast": AtLAST-50k with the 3-D
atmosphere through ``TODProgram.total_power_fn()`` and the field map
(``field_pixel_ids``, ``bin_total``); cumulative stage times
``fields(upto="pwv")``, ``upto="atmosphere"``, ``upto="signal"``, the
total, total + binning. ``--map dust`` lets either scene observe that
family of sky over its field, so that "upto signal" less "upto
atmosphere" is the map stage. Scene "sky": MUSTANG-2 on the Planner's
ra/dec daisy over ``big_cluster`` (``scenes.sky_simulation``), mapped in
ra/dec on the input map's 512 x 512 grid.
Each is host-timed around a synchronize, with the peak device memory
so far (the program's tables and, after the binning, the pixel ids
included); then a ``torch.profiler``
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


def profiled(fn) -> tuple:
    """(wall ms, device kernel ms, the profiler) of one call of ``fn``
    under torch.profiler, from a synchronize before it to one after."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - start) * 1e3
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type is not None and str(e.device_type).endswith("CUDA"))
    return window_ms, device_us / 1e3, prof


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scene", choices=("mustang2", "atlast", "sky"), default="mustang2")
    parser.add_argument("--map", default=None, help="a family of maria_torch.map for mustang2 or atlast to observe")
    parser.add_argument("--duration", type=float, default=60.0)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--trace", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA card")

    from maria_torch.mappers import BinMapper
    from maria_torch.mappers.bin_mapper import bin_total, field_pixel_ids
    from maria_torch.scenes import SCENES, simulation, sky_mapper, sky_simulation

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    device = torch.device("cuda")
    atlast = args.scene == "atlast"
    scene = SCENES["mustang2" if args.scene == "sky" else args.scene]
    if args.scene == "sky":
        sim = sky_simulation(args.duration, device)
    else:
        sim = simulation(args.scene, args.duration, device, input_map=args.map)
    program = sim.program()
    gen = sim.generator
    n = program.n_det * program.n_t
    print(f"card: {card}; scene {scene['instrument']} {program.n_det} x {program.n_t} = {n} samples, "
          f"{len(program.screens)} screens, {sum(len(g.heights) for g in program.groups)} group layers; input map "
          f"{sim.map}")

    if atlast:
        fn = program.total_power_fn()
        obs = sim.obs_list[0]
        field = {}

        def run_map():
            if not field:  # made at the first binning, after the program's stages have run
                field["ids"], field["n_pix"] = field_pixel_ids(obs.boresight, obs.offsets, 128, 128, device=device)
            return bin_total(fn(generator=gen, device=device), field["ids"], field["n_pix"])

        def realization():
            run_map()

        stages = {
            "fields upto pwv": lambda: program.fields(generator=gen, device=device, upto="pwv"),
            "fields upto atmosphere": lambda: program.fields(generator=gen, device=device, upto="atmosphere"),
            "fields upto signal": lambda: program.fields(generator=gen, device=device, upto="signal"),
            "total_power_fn()": lambda: fn(generator=gen, device=device),
            "total + bin_total": run_map,
        }
    else:
        tod = sim.run()[0]
        center = tuple(np.degrees(tod.boresight.center()))

        def run_map():
            if args.scene == "sky":
                return sky_mapper([tod], sim.map).run()
            return BinMapper(tod, center=center, width=0.25, resolution=0.25 / 128, frame="az/el").run()

        def realization():
            run_map()
            sim.run()

        stages = {
            "fields upto pwv": lambda: program.fields(generator=gen, device=device, upto="pwv"),
            "fields upto atmosphere": lambda: program.fields(generator=gen, device=device, upto="atmosphere"),
            "fields upto signal": lambda: program.fields(generator=gen, device=device, upto="signal"),
            "fields (all)": lambda: program.fields(generator=gen, device=device),
            "run_obs (fields + gains, pW)": lambda: sim.run_obs(0),
            "run() (+ K_RJ)": lambda: sim.run(),
            "BinMapper(...).run()": run_map,
        }
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name, stage in stages.items():
        print(f"{name:32s} {_wall_ms(stage, args.reps):9.3f} ms (cumulative, warm, {args.reps} reps); peak device "
              f"memory so far {torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)

    window_ms, device_ms, prof = profiled(realization)
    print(f"profiled window (one realization and its map): {window_ms:.3f} ms wall, {device_ms:.3f} ms device "
          f"kernel time, device busy {device_ms / window_ms:.1%} of the window")
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
