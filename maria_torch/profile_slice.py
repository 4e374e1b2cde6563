"""Where the time of a slice goes, on a CUDA card.

    python -m maria_torch.profile_slice [--scene mustang2|atlast|sky] [--map FAMILY] [--duration 60] [--reps 10]
                                        [--trace PATH]

Scene "mustang2" (the default): the MUSTANG-2 daisy through
``Simulation.run()`` and ``BinMapper.run()``. Scene "atlast": AtLAST-50k
with the 3-D atmosphere through ``TODProgram.total_power_fn()`` and the
field map (``field_pixel_ids``, ``bin_total``). ``--map dust`` lets
either scene observe that family of sky over its field. Scene "sky":
MUSTANG-2 on the Planner's ra/dec daisy over ``big_cluster``
(``scenes.sky_simulation``), mapped in ra/dec on the input map's 512 x
512 grid.

A realization and its map is host-timed around a synchronize over
``--reps`` warm calls, with the peak device memory; then one more runs
under ``torch.profiler`` with the program's spans on
(``maria_torch.io.logging``): the stage table holds each span's calls,
host time and self time (the span less its child spans) in that one
run, the device's busy time is the union of its kernels', copies' and
fills' intervals (overlaps once), and a table of device time by kernel
follows. ``--trace`` also writes the Chrome trace, the stages in it.
Needs a card: it fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from .io.logging import reset_trace, trace_summary, tracing

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _wall_ms(fn, reps: int) -> float:
    fn()
    _sync()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync()
    return (time.perf_counter() - start) / reps * 1e3


def device_intervals(prof) -> list:
    """(start_us, end_us) of every device activity (kernels, copies,
    fills) in a finished profiler's trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in DEVICE_CATEGORIES and "dur" in e]


def union_ms(intervals) -> float:
    """The length of the union of (start_us, end_us) intervals, in ms."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            total += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return (total + (0.0 if cur_e is None else cur_e - cur_s)) * 1e-3


def profiled(fn) -> tuple:
    """(wall ms, device busy ms, the profiler) of one call of ``fn`` under
    torch.profiler with the program's spans on, from a synchronize before
    it to one after; busy is the union of the device activities'
    intervals."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    _sync()
    with profile(activities=activities) as prof, tracing(True):
        start = time.perf_counter()
        fn()
        _sync()
        window_ms = (time.perf_counter() - start) * 1e3
    return window_ms, union_ms(device_intervals(prof)), prof


def stage_table(summary: dict) -> str:
    """The spans of ``trace_summary()`` by self time: calls, host ms, self
    ms and the self time's share of all spans' self time."""
    spans = summary["spans"]
    total = sum(v["self_s"] for v in spans.values()) or 1.0
    rows = [f"{'span':40s} {'calls':>6s} {'host ms':>10s} {'self ms':>10s} {'self share':>10s}"]
    for name, v in sorted(spans.items(), key=lambda kv: -kv[1]["self_s"]):
        rows.append(f"{name:40s} {v['calls']:6d} {1e3 * v['host_s']:10.3f} {1e3 * v['self_s']:10.3f} "
                    f"{v['self_s'] / total:10.1%}")
    counters = {k: v for k, v in summary["counters"].items() if v}
    return "\n".join(rows + [f"counters: {counters}"])


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
        ids, n_pix = field_pixel_ids(obs.boresight, obs.offsets, 128, 128, device=device)

        def realization():
            bin_total(fn(generator=gen, device=device), ids, n_pix)
    else:
        tod = sim.run()[0]
        center = tuple(np.degrees(tod.boresight.center()))

        def realization():
            tod = sim.run()[0]
            if args.scene == "sky":
                sky_mapper([tod], sim.map).run()
            else:
                BinMapper(tod, center=center, width=0.25, resolution=0.25 / 128, frame="az/el").run()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall_ms = _wall_ms(realization, args.reps)
    print(f"realization and its map: {wall_ms:.3f} ms (warm, mean of {args.reps}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)

    reset_trace()
    window_ms, busy_ms, prof = profiled(realization)
    print(f"profiled realization and its map: {window_ms:.3f} ms wall, device busy {busy_ms:.3f} ms "
          f"({busy_ms / window_ms:.1%} of the window, the union of device intervals)")
    print(stage_table(trace_summary()))
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
