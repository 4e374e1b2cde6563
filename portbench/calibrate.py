"""Read the numbers that decide ``correct`` over many seeds in one
process, for setting their limits: the program's readings (sound runs)
and the control's (the reference one step below the configuration's
precision in the program's place).

    python3 -m portbench.calibrate --workload <cell> --seeds 12 --control-seeds 3 [--first-seed N]

Set-up runs once; each seed stands for a run seeded so, whose checked
realizations are drawn and judged as a run judges them. On the first
``--control-seeds`` seeds it also reads the control and the entry's
``VARIANTS``: other controls and faults planted in the program. One
JSON line a reading, then
a summary line: the largest program reading and the smallest control
reading of each number.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

from . import run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    _, _, config, traffic, _ = run.cell_spec(args.workload)
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
    print(f"card: {run.power_limit()}", file=sys.stderr, flush=True)
    start = time.perf_counter()
    state = entry.setup(config, traffic, args.first_seed % (2**31 - 1), device)
    torch.cuda.synchronize()
    print(f"setup {time.perf_counter() - start:.1f} s", file=sys.stderr, flush=True)
    program, control = {}, {}
    for j in range(args.seeds):
        seed = args.first_seed + 7919 * j
        kept = []
        for i in run.checked_indices(seed):
            rseed = run.realization_seed(seed, i)
            kept.append((i, rseed, entry.realize(state, rseed, run.Spans(False, None))))
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = entry.judge(kept, config, traffic, device)
        print(json.dumps({"side": "program", "seed": seed, "judge_s": time.perf_counter() - t, **r}), flush=True)
        for k, v in r.items():
            program[k] = max(program.get(k, 0.0), v)
        if j < args.control_seeds:
            t = time.perf_counter()
            c = entry.control(kept[0][2], kept[0][1], device)
            print(json.dumps({"side": "control", "seed": seed, "control_s": time.perf_counter() - t, **c}), flush=True)
            for k, v in c.items():
                control[k] = min(control.get(k, float("inf")), v)
            for side, read in getattr(entry, "VARIANTS", {}).items():
                print(json.dumps({"side": side, "seed": seed, **read(state, kept[0][2], kept[0][1], device)}),
                      flush=True)
        del kept
    print(json.dumps({"summary": True, "program_max": program, "control_min": control}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
