"""End-to-end times of chip_smoke's single-process paths beside another
tree's (a parent commit's ``git archive``), on the card:

    python tools/profile_torch_paths.py --parent build/parent [--reps 5] [--pairs 2]

Each measurement runs in a fresh process, in pairs that alternate which
side runs first: parent, this tree, this tree, parent, ... A process times, warm (the mean of ``--reps``, each
ended by a synchronize): (a) MUSTANG-2 60 s ``run()`` and its 128 x 128
BinMapper, (c) the AtLAST-50k 60 s ``total_power_fn()`` and its binning,
(t) AtLAST-50k x 600 s streamed (block_tc 128, group_size 8) and (u)
MUSTANG-2 600 s streamed (block_tc 64, group_size 16), through the API
both trees share. It prints one JSON line a process, then each path's
times on both sides.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

TREE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(reps: int) -> dict:
    """The warm ms of each path in this process's maria_torch, on the card."""
    import torch

    import maria_torch
    from maria_torch.mappers.bin_mapper import bin_total, field_pixel_ids
    from maria_torch.ops import kernels
    from maria_torch.ops.program import build_tod_program
    from maria_torch.ops.streaming_exec import StreamingExecutor
    from maria_torch.scenes import simulation

    kernels.load()
    device = torch.device("cuda")

    def warm(fn):
        fn()
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            s = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - s) * 1e3)
        return float(np.mean(ms))

    out = {}
    sim = simulation("mustang2", 60.0, device)
    tod = sim.run()[0]
    center = np.degrees(tod.boresight.center())
    out["a_run_ms"] = warm(lambda: sim.run())
    out["a_map_ms"] = warm(lambda: maria_torch.BinMapper(tod, center=center, width=0.25, resolution=0.25 / 128,
                                                         frame="az/el").run())
    sim = simulation("atlast", 60.0, device)
    program, obs = sim.program(), sim.obs_list[0]
    fn = program.total_power_fn()
    ids, n_pix = field_pixel_ids(obs.boresight, obs.offsets, 128, 128, device=device)
    out["c_total_ms"] = warm(lambda: fn(generator=sim.generator, device=device))
    total = fn(generator=sim.generator, device=device)
    out["c_binning_ms"] = warm(lambda: bin_total(total, ids, n_pix))
    del total, ids, program, sim
    sim = simulation("atlast", 600.0, device)
    ex = StreamingExecutor(sim.program(), sim.obs_list[0], block_tc=128, device=device)
    out["t_ms"] = warm(lambda: ex.run(0, group_size=8))
    del ex, sim
    plan = maria_torch.get_plan("daisy_5arcmin_60s", start_time=1.75e9, scan_center=(150.0, 41.0), frame="az/el",
                                duration=600.0, sample_rate=50.0)
    sim = maria_torch.Simulation(instrument="MUSTANG-2", plans=plan, site="GBT", atmosphere="2d", noise=True, seed=0,
                                 device=device)
    ex = StreamingExecutor(build_tod_program(sim.obs_list[0], noise_kwargs=sim.noise_kwargs, device=device),
                           sim.obs_list[0], block_tc=64, device=device)
    out["u_ms"] = warm(lambda: ex.run(0, group_size=16))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="the other tree (it holds a maria_torch/ directory)")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--pairs", type=int, default=2)
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        print(json.dumps(measure(args.reps)), flush=True)
        return 0
    if not args.parent:
        parser.error("--parent is required")
    runs = {"parent": [], "this": []}
    order = [("parent", "this"), ("this", "parent")]
    for side in [side for i in range(args.pairs) for side in order[i % 2]]:
        tree = os.path.abspath(args.parent) if side == "parent" else TREE
        # the tree's package first on the path, and not this file's directory
        here = os.path.abspath(__file__)
        code = (f"import sys; sys.path[:1] = [{tree!r}]; sys.argv = ['profile_torch_paths', '--child', '1', '--reps', "
                f"'{args.reps}']; exec(compile(open({here!r}).read(), {here!r}, 'exec'), "
                f"{{'__name__': '__main__', '__file__': {here!r}}})")
        res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=False)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        line = json.loads(res.stdout.strip().splitlines()[-1])
        runs[side].append(line)
        print(f"{side}: {json.dumps(line)}", flush=True)
    for key in runs["this"][0]:
        print(f"{key}: parent {[round(r[key], 2) for r in runs['parent']]}, this "
              f"{[round(r[key], 2) for r in runs['this']]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
