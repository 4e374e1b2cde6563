"""KC on a CUDA card at the streamed slices' block shapes, beside an
earlier form of the same kernel from another checkout and the Toeplitz
GEMM.

    python -m maria_torch.profile_cascade [--parent DIR] [--reps 20] [--sweep] [--loop]

The shapes are the blocks of chip_smoke's slices: (t) AtLAST-50k's 50,049
cascade rows x 640 in nine tables, (u) MUSTANG-2's 222 x 3,136 at 50 Hz
and (v) its 222 x 320 at 20 Hz, with cascades fit as the executor fits
them (seeded innovations and states). For each it prints the split the
dispatch chose (``cascade_plan``: G lanes a row, S samples a lane, the
chunks a row), this tree's time by CUDA events over ``--reps`` launches
a turn and, with ``--parent``, the time of the checkout in DIR (for
example ``git archive <commit>`` unpacked into ``build/parent``): its
``maria_torch/csrc/pink_cascade.cu`` compiled alone with nvcc and called
through the earlier C interface (w, pink, state in, state out, p, a,
row_table, rows, n, K, stream), in turns parent, this, this, parent, with
the largest difference of the two outputs over the pink std. Beside them
the yardstick, a float32 Toeplitz GEMM w @ LGT over one sub-chunk scaled
to n (TF32 off; never called by the port), and each time's share of the
bounds of ``cascade_bounds``. ``--sweep`` also times G = 1 at ring tiles of
32, 64 and 128 samples everywhere, every G from 32 to 256 at (u) and (v)
(``ops.pink_cascade.launch``), and G 1 against G 32 from 8,448 to 25,344
rows x 640 in nine tables, across the split's boundary. ``--loop`` (with
``--parent``) times the
block loop of slice (u) at 3,600 s (``StreamingExecutor.run``, 58 blocks
of 222 x 3,136, host-bound) with this KC and the earlier one in turns,
after one CUDA graph capture of this KC, and each run's device time
under torch.profiler. Every time is taken twice: over back-to-back
calls (as chip_smoke times every kernel; for a short kernel the host's
time a call) and from a CUDA graph of the same calls (``graph_ms``, the
device's). Needs a card: it fails without one.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess

import numpy as np
import torch

from .ops.pink_cascade import FILL_LANES, lane_fmas
from .profile_sht import F32_OPS, HBM_BYTES_S, LANE_INSTRUCTIONS_S

# (label, rows, n, sample rate, tables): chip_smoke's streamed blocks
SHAPES = (("t", 50049, 640, 50.0, 9), ("u", 222, 3136, 50.0, 1), ("v", 222, 320, 20.0, 1))
# --sweep: G 1 against G 32 at these rows x 640 (nine tables), across the split's boundary
BOUNDARY_ROWS = (8448, 10560, 12671, 12672, 14784, 16896, 25344)


def cascade_bounds(rows: int, n: int, K: int, G: int, S: int) -> dict:
    """{"bytes_bound_ms", "ops_bound_ms", "latency_bound_ms"}: w read and
    pink written once with the state read and written (bytes at 3.35
    TB/s); the contract's 2K FMAs a sample at the float32 peak; and the
    split's latency bound, ``lane_fmas`` issued one a cycle (a lane's share
    of the card's issue slots)."""
    return {"bytes_bound_ms": 8.0 * rows * (n + K) / HBM_BYTES_S * 1e3,
            "ops_bound_ms": 4.0 * K * rows * n / F32_OPS * 1e3,
            "latency_bound_ms": lane_fmas(n, K, G, S) * FILL_LANES / LANE_INSTRUCTIONS_S * 1e3}


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


def graph_ms(fn, reps: int) -> float:
    """The device's ms a call: ``reps`` calls captured in one CUDA graph
    and replayed between CUDA events, so no host time sits between the
    launches (back-to-back calls of a short kernel time the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _parent_library(parent: str):
    """The earlier pink_cascade.cu of the checkout ``parent``, compiled alone."""
    from .ops import kernels

    source = os.path.join(parent, "maria_torch", "csrc", "pink_cascade.cu")
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(os.path.dirname(kernels.library_path()), f"libparent_cascade_{digest}.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS[:-1], "-shared", "-o", out, source], check=True,
                       capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.maria_pink_cascade.argtypes = [p] * 7 + [i, i, i, p]
    lib.maria_pink_cascade.restype = i
    return lib


def _parent_call(lib, w, state, p, a, table):
    pink, new_state = torch.empty_like(w), torch.empty_like(state)
    code = lib.maria_pink_cascade(w.data_ptr(), pink.data_ptr(), state.data_ptr(), new_state.data_ptr(), p.data_ptr(),
                                  a.data_ptr(), None if table is None else table.data_ptr(), w.shape[0], w.shape[1],
                                  p.shape[1], torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"the earlier KC failed to launch: CUDA error {code}")
    return pink, new_state


def block_loop(parent, turns: int = 2):
    """Slice (u)'s streamed run at 3,600 s (chip_smoke's scene) with this
    tree's KC and the earlier one in turns, after a CUDA graph capture of
    this KC: (name, warm ms, device ms under torch.profiler) a run."""
    import time

    from . import Simulation, get_plan
    from .ops import streaming_exec
    from .ops.program import build_tod_program

    plan = get_plan("daisy_5arcmin_60s", start_time=1.75e9, scan_center=(150.0, 41.0), frame="az/el",
                    duration=3600.0, sample_rate=50.0)
    sim = Simulation(instrument="MUSTANG-2", plans=plan, site="GBT", atmosphere="2d", noise=True, seed=0,
                     device="cuda")
    program = build_tod_program(sim.obs_list[0], noise_kwargs=sim.noise_kwargs, device="cuda")
    ex = streaming_exec.StreamingExecutor(program, sim.obs_list[0], block_tc=64, device="cuda")
    ours = streaming_exec.pink_cascade
    t = ex._casc_tensors(torch.device("cuda"))
    w = torch.randn((ex._casc_rows["n"], ex.B), device="cuda")
    state = torch.randn((ex._casc_rows["n"], ex._casc_rows["K"]), device="cuda")
    graph_ms(lambda: ours(w, state, t["p"], t["a"], t["table"]), 20)

    def earlier(w, state, p, a, table=None):
        return _parent_call(parent, w.contiguous(), state.contiguous(), p, a, table)

    out = []
    try:
        for name, fn in (("earlier", earlier), ("this", ours), ("this", ours), ("earlier", earlier)) * turns:
            streaming_exec.pink_cascade = fn
            ex.run(0, group_size=16)
            torch.cuda.synchronize()
            start = time.perf_counter()
            ex.run(0, group_size=16)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - start) * 1e3
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                ex.run(0, group_size=16)
                torch.cuda.synchronize()
            device = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
            out.append((name, wall, device))
    finally:
        streaming_exec.pink_cascade = ours
    return out


def block_inputs(device, rows: int, n: int, sample_rate: float, tables: int, seed: int = 0):
    """(w, state, p, a, row_table) of a block: ``tables`` cascades fit at
    knees from 0.05 to 2 Hz, each over a contiguous span of rows."""
    from .noise.streaming import _fit_cascade

    fits = [_fit_cascade(sample_rate, knee, 1.0, 4096.0, 2.0) for knee in np.geomspace(0.05, 2.0, tables)]
    p = torch.as_tensor(np.stack([f[0] for f in fits]), device=device)
    a = torch.as_tensor(np.stack([f[1] for f in fits]), device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((rows, n), generator=gen, device=device)
    state = 30.0 * torch.randn((rows, p.shape[1]), generator=gen, device=device)
    table = None
    if tables > 1:
        table = (torch.arange(rows, device=device) * tables // rows).to(torch.int32)
    return w, state, p, a, table


def _sweep(label, w, state, p, a, table, splits, reps):
    """The device time of each forced (G, S) on one block."""
    from .ops.pink_cascade import launch

    rows, n = w.shape
    K = p.shape[1]
    for g, s in splits:
        t = graph_ms(lambda: launch(w, state, p, a, table, g, s), reps)
        b = cascade_bounds(rows, n, K, g, s)
        print(f"  sweep ({label}) G {g}, S {s}: device {t:.4f} ms, {b['bytes_bound_ms'] / t:.1%} of the byte "
              f"bound, latency bound {b['latency_bound_ms']:.4f} ms", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", default=None, help="a checkout holding the earlier maria_torch/csrc/pink_cascade.cu")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--sweep", action="store_true", help="also time every G at (u) and (v)")
    parser.add_argument("--loop", action="store_true", help="time slice (u)'s block loop with both KCs (--parent)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_cascade needs a CUDA card")

    from .ops.pink_cascade import (CHUNK, MAX_LANES, MIN_LANES, cascade_plan, pink_cascade, segment_length,
                                   toeplitz_tables)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    device = torch.device("cuda")
    parent = _parent_library(args.parent) if args.parent else None
    print(f"card: {card}; CUDA events over {args.reps} launches a turn{'; parent ' + args.parent if parent else ''}",
          flush=True)
    print("ms: CUDA events over back-to-back calls (host time included where it exceeds the kernel's); device ms: "
          "the same calls replayed from a CUDA graph", flush=True)
    print("| block | rows x n, K, tables | G, S, chunks | this ms (device) | earlier ms (device) | max diff / std | "
          "GEMM ms (device) | bytes bound ms | latency bound ms | share of bytes, device (this, earlier) | share of "
          "latency, device (this) |", flush=True)
    print("|---|---|---|---|---|---|---|---|---|---|---|", flush=True)
    for label, rows, n, fs, tables in SHAPES:
        w, state, p, a, table = block_inputs(device, rows, n, fs, tables)
        K = p.shape[1]
        G, S = cascade_plan(rows, n)
        chunks = -(-n // (G * S))
        b = cascade_bounds(rows, n, K, G, S)

        def ours():
            return pink_cascade(w, state, p, a, table)

        def earlier():
            return _parent_call(parent, w, state, p, a, table)

        nan = float("nan")
        ms, old_ms, dev, old_dev, diff = nan, nan, nan, nan, nan
        if parent is None:
            ms, dev = _ms(ours, args.reps), graph_ms(ours, args.reps)
        else:
            (y_new, _), (y_old, _) = ours(), earlier()
            diff = float((y_new - y_old).abs().max()) / float(y_old.std())
            o1, n1 = _ms(earlier, args.reps), _ms(ours, args.reps)
            n2, o2 = _ms(ours, args.reps), _ms(earlier, args.reps)
            ms, old_ms = (n1 + n2) / 2, (o1 + o2) / 2
            o1, n1 = graph_ms(earlier, args.reps), graph_ms(ours, args.reps)
            n2, o2 = graph_ms(ours, args.reps), graph_ms(earlier, args.reps)
            dev, old_dev = (n1 + n2) / 2, (o1 + o2) / 2
        chunk = min(n, CHUNK)
        LGT = toeplitz_tables(p[0], a[0], chunk, device)[0]
        gemm_in = w[:, :chunk].contiguous()

        def gemm():
            return torch.matmul(gemm_in, LGT)

        gemm_ms, gemm_dev = _ms(gemm, args.reps) * n / chunk, graph_ms(gemm, args.reps) * n / chunk
        print(f"| ({label}) | {rows} x {n}, {K}, {tables} | {G}, {S}, {chunks} | {ms:.4f} ({dev:.4f}) | "
              f"{old_ms:.4f} ({old_dev:.4f}) | {diff:.2e} | {gemm_ms:.4f} ({gemm_dev:.4f}) | "
              f"{b['bytes_bound_ms']:.4f} | {b['latency_bound_ms']:.4f} | {b['bytes_bound_ms'] / dev:.1%}, "
              f"{b['bytes_bound_ms'] / old_dev:.1%} | {b['latency_bound_ms'] / dev:.1%} |", flush=True)
        if args.sweep:  # G = 1 at every ring tile; with few rows every G
            splits = [(1, tile) for tile in (32, 64, 128)]
            if G > 1:
                g = MIN_LANES
                while g <= MAX_LANES:
                    splits.append((g, segment_length(n, g)))
                    g *= 2
            _sweep(label, w, state, p, a, table, splits, args.reps)
    if args.sweep:
        for rows in BOUNDARY_ROWS:
            w, state, p, a, table = block_inputs(device, rows, 640, 50.0, 9)
            G, _ = cascade_plan(rows, 640)
            label = f"{rows} x 640, plan G {G}"
            _sweep(label, w, state, p, a, table, [(1, 32), (MIN_LANES, segment_length(640, MIN_LANES))], args.reps)
    if args.loop and parent is not None:
        for name, wall, device in block_loop(parent):
            kc = "this tree's KC" if name == "this" else "the earlier KC"
            print(f"slice (u) at 3,600 s, the block loop with {kc}: {wall:.1f} ms warm, device busy {device:.1f} ms "
                  f"(profiler)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
