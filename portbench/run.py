"""Run one cell of the benchmark of maria_torch once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration in ``portbench/configs/<config>.json``, its traffic mix in
``portbench/traffic/<traffic>.json``, whose ``entry`` names the module
``portbench/entries/<entry>.py`` that drives the program's entry
points, each per-layer metric's reader in ``portbench/metrics/<name>.py``
and each work item's cost in ``portbench/kernels/<item>.py``; the limits
of the check that decides ``correct`` are ``portbench/limits/<cell>.json``.

A run: set-up (imports, the scene, the program, one warm realization),
then a closed loop of realizations for ``--seconds`` (each drawn from
its own seed and ended by a synchronize), then the check of a sample of
them against the plain reference. The last line of standard output is
the result's JSON; the check's numbers close standard error. With
``--trace 1`` the window runs under ``torch.profiler`` with spans around
the calls into each layer, and the result carries the per-layer metrics.
"""

from __future__ import annotations

import os
import time

_BOOT_CLOCK = getattr(time, "CLOCK_BOOTTIME", None)


def _process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of
    its start (10 ms resolution), or 0 where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(_BOOT_CLOCK) - started
    except (OSError, IndexError, ValueError, TypeError):
        return 0.0


_T0 = time.perf_counter() - _process_age_s()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "maria_tpu")
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1"}  # one process, few threads
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
              "MARIA_TORCH_CACHE_DIR": "maria-torch-data"}
CHECKED, CHECK_CAP = 2, 8  # the check compares CHECKED realizations drawn from the window's first CHECK_CAP


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str) -> tuple:
    """(benchmark, cell, config, traffic, limits) of ``workload``."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload '{workload}' (known: {sorted(cells)})")
    cell = cells[workload]
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits_path = HERE / "limits" / f"{workload}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    return bench, cell, config, traffic, limits


def metrics_of(bench: dict, workload: str, kind: str) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics that cell
    ``workload`` reports."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def realization_seed(seed: int, index: int) -> int:
    """The seed of realization ``index`` of a run seeded ``seed``."""
    import numpy as np

    words = np.random.SeedSequence([int(seed) & (2**63 - 1), int(index) & (2**63 - 1)]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) | (int(words[1]) >> 1)


def checked_indices(seed: int) -> list:
    """The CHECKED realizations (of the window's first CHECK_CAP, which it
    always runs) that the check compares, drawn from the seed."""
    import numpy as np

    rng = np.random.default_rng([int(seed) & (2**63 - 1), 1])
    return sorted(int(i) for i in rng.choice(CHECK_CAP, size=CHECKED, replace=False))


def quantile95(values: list) -> float:
    """The 95th percentile of all values, Python's default (exclusive)
    method; the largest value where there are fewer than 20."""
    if len(values) < 20:
        return max(values)
    return statistics.quantiles(values, n=20)[-1]


class Spans:
    """Host spans around the calls into each layer, each ended by a
    synchronize, under the profiler's annotation of the same name; with
    ``on`` False they record nothing and never synchronize."""

    def __init__(self, on: bool, sync):
        self.on, self.sync, self.times = on, sync, {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        import torch

        start = time.perf_counter()
        with torch.profiler.record_function(f"portbench.{name}"):
            yield
            self.sync()
        self.times.setdefault(name, []).append(time.perf_counter() - start)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, config: dict = None,
             traffic: dict = None, limits: dict = None) -> dict:
    """One run of cell ``workload`` on ``device``; ``config``, ``traffic``
    and ``limits`` replace the cell's files (the CPU rehearsal's tiny
    sizes). Returns the result's fields."""
    import numpy as np
    import torch

    from . import trace as trace_mod

    bench, cell, cfg, trf, lim = cell_spec(workload)
    config, traffic, limits = config or cfg, traffic or trf, limits or lim
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    spans = Spans(trace, sync)

    start = time.perf_counter()
    state = entry.setup(config, traffic, int(seed) % (2**31 - 1), device)
    sync()
    scene_setup_s = time.perf_counter() - start
    entry.realize(state, realization_seed(seed, -1), Spans(False, sync))  # the warm realization
    sync()
    setup_s = time.perf_counter() - _T0
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    keep = set(checked_indices(seed))
    kept, times, held = [], [], 0
    window_peak = 0
    counters0 = entry.counters()
    profiler = trace_mod.profiler(cuda) if trace else contextlib.nullcontext()
    window = min(seconds, traffic.get("trace_seconds", seconds)) if trace else seconds
    with profiler as prof:
        with torch.profiler.record_function("portbench.window") if trace else contextlib.nullcontext():
            w0 = time.perf_counter()
            i = 0
            last_checked = max(keep)
            while time.perf_counter() - w0 < window or i <= last_checked:
                if cuda:
                    torch.cuda.reset_peak_memory_stats(device)
                t0 = time.perf_counter()
                out = entry.realize(state, realization_seed(seed, i), spans)
                sync()
                times.append(time.perf_counter() - t0)
                if cuda:
                    window_peak = max(window_peak, torch.cuda.max_memory_allocated(device) - held)
                if i in keep:
                    kept.append((i, realization_seed(seed, i), out))
                    held += entry.held_bytes(out)
                del out
                i += 1
            window_s = time.perf_counter() - w0
    counters = {k: v - counters0.get(k, 0) for k, v in entry.counters().items()}
    memory_peak = max(setup_peak, window_peak + held) if cuda else 0
    n = len(times)
    result = {
        "attempted": n, "failed": 0, "window_s": window_s, "setup_s": setup_s, "scene_setup_s": scene_setup_s,
        "samples": entry.samples(state) * n, "times": times, "peak": window_peak, "memory_peak": memory_peak,
    }
    if trace:
        start = time.perf_counter()
        summary = trace_mod.summarize(prof, cuda)
        print(f"trace of {n} realizations read in {time.perf_counter() - start:.1f} s", file=sys.stderr)
        ctx = {
            "spans": spans.times, "realizations": n, "trace": summary, "work": entry.work(state),
            "counters": counters, "scene_setup_s": scene_setup_s, "cuda": cuda,
        }
        result["per_layer"] = {}
        for m in metrics_of(bench, workload, "per_layer"):
            value = importlib.import_module(f"portbench.metrics.{m['name']}").read(ctx)
            if value is not None:
                result["per_layer"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["busy_s"], result["traced_window_s"] = summary["busy_s"], summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    else:
        result["end_to_end"] = {}
        e2e = {
            "samples_per_s": result["samples"] / window_s,
            "realization_ms_p95": 1e3 * quantile95(times) if times else None,
            "peak_device_gb": window_peak / 1e9,
            "setup_s": setup_s,
        }
        for m in metrics_of(bench, workload, "end_to_end"):
            if e2e.get(m["name"]) is not None:
                result["end_to_end"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # the check, once the window has closed and its peak is read
    del state
    if cuda:
        torch.cuda.empty_cache()
    readings = entry.judge(kept, config, traffic, device)
    checks = {}
    for name, value in readings.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
    correct = bool(kept) and bool(checks) and all(
        c["limit"] is not None and np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    result["correct"] = correct
    result["checks"] = checks
    result["checked"] = [i for i, _, _ in kept]
    print(f"checked realizations {result['checked']} of {n}", file=sys.stderr)
    return result


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20, check=False)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    for var, sub in CACHE_DIRS.items():
        path = ROOT / "build" / "portbench" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ.update(THREADS)

    bench, cell, _, _, _ = cell_spec(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = power_limit()
    print(f"card: {card}", file=sys.stderr)

    r = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device)

    loaded = sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))
    if loaded:
        print(f"the run loaded {loaded}: the benchmark measures maria_torch alone", file=sys.stderr)
        return 3
    device_info = {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
        "memory_peak_bytes": int(r["memory_peak"]),
    }
    out = {"correct": r["correct"], "attempted": r["attempted"], "failed": r["failed"]}
    if args.trace:
        device_info.update(busy_s=r["busy_s"], window_s=r["traced_window_s"])
        out["metrics"] = r["per_layer"]
        out["breakdown"] = r["breakdown"]
    else:
        out["metrics"] = r["end_to_end"]
    out["device"] = device_info
    out["power_limit"] = card
    out["checks"] = r["checks"]
    for name, c in r["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
