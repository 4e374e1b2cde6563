"""The AR extrusion kernel on a CUDA card: the cluster sizes that fix the
rule of ``ops.ar_extrude.ar_cluster_size``, and what a step's barrier costs.

    python -m maria_torch.profile_ar [--reps 20]

For the processes of the scenes chip_smoke.py drives with the
autoregressive atmosphere (MUSTANG-2's 2-D scene at 60 s and 600 s,
slices (e), (f): 8 processes; AtLAST-50k's 3-D scene at 60 s, slice (g):
one process of 209 x 252 x 510) it runs the kernel under every cluster
size of 1, 2, 4, 8 the card's shared memory admits (a lower ``smem_limit``
given to ``ar_plan`` forces the larger ones, and 0, one block reading A
and B through L2), checks every screen against the plain loop (1e-4 of its
std) and times each plan with CUDA events over ``--reps`` launches, the
plans of a scene in turns, there and back. Then it probes a dependent
FMA, a block barrier at 32 threads and at each plan's block size, and a
cluster barrier at each plan's cluster size. Needs a card: it fails
without one.
"""

from __future__ import annotations

import argparse
import subprocess

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
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_ar needs a CUDA card")

    from .ops import kernels
    from .ops.ar_extrude import (ar_cluster_size, ar_extrude, ar_extrude_reference, ar_plan, ar_smem_bytes,
                                 probe_latencies)
    from .scenes import simulation

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    device = torch.device("cuda")
    card_limit = kernels.load().maria_max_dynamic_smem(torch.cuda.current_device())
    print(f"card: {card}; {card_limit} B of shared memory a block; CUDA events over {args.reps} launches")
    print("| scene | processes | longest chain | cluster | threads | rows a block | smem a block B | ms | us a step | "
          "max err / std |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    gen = torch.Generator(device=device).manual_seed(0)
    ok, probed, sizes = True, set(), (1, 2, 4, 8)
    for label, scene, duration in (("e", "mustang2", 60.0), ("f", "mustang2", 600.0), ("g", "atlast", 60.0)):
        processes = simulation(scene, duration, device, method="ar").program().ar_processes
        draws = [p.draw(gen, device) for p in processes]
        buffers, noises = [d[0] for d in draws], [d[1] for d in draws]
        refs = [ar_extrude_reference(t["A"], t["B"], b, t["ext_idx"], t["cross_idx"], e)[: p.n_extrusion]
                for p, t, b, e in zip(processes, (p.tensors(device) for p in processes), buffers, noises)]
        # the limits that give the largest process each cluster size the card admits, then the through-L2 form
        big = max(processes, key=lambda p: p.n_cross_section * p.n_sample)
        n_cross, n_sample = big.n_cross_section, big.n_sample
        least = ar_cluster_size(n_cross, n_sample, card_limit, sizes)
        limits = [ar_smem_bytes(n_cross, n_sample, c) for c in sizes if least and c >= least]
        limits.append(ar_smem_bytes(n_cross, n_sample, sizes[-1]) - 4)
        plans = [ar_plan(processes, device, smem_limit=limit, sizes=sizes) for limit in limits]
        errs = []
        for plan in plans:
            out = ar_extrude(processes, buffers, noises, plan=plan)
            errs.append(max(float((o - r).abs().max() / r.std()) for o, r in zip(out, refs)))
        there = [_ms(lambda p=p: ar_extrude(processes, buffers, noises, plan=p), args.reps) for p in plans]
        back = [_ms(lambda p=p: ar_extrude(processes, buffers, noises, plan=p), args.reps) for p in reversed(plans)][::-1]
        steps = max(p.n_steps for p in processes)
        for plan, a, b, err in zip(plans, there, back, errs):
            ok &= err <= 1e-4
            for g in plan["groups"]:
                probed.add((g["cluster"], g["threads"]))
            chosen = sorted(set(plan["cluster"]))
            cells = [", ".join(str(g[k]) for g in plan["groups"]) for k in ("threads", "rows", "smem")]
            print(f"| {label} | {len(processes)} | {steps} | {chosen} | {' | '.join(cells)} | {(a + b) / 2:.4f} | "
                  f"{(a + b) / 2 * 1e3 / steps:.3f} | {err:.2e} |", flush=True)
    print("| probe | ns |")
    print("|---|---|")
    for cluster, threads in sorted(probed):
        lat = probe_latencies(device, cluster=cluster, threads=threads)
        what = f"cluster barrier, {cluster} blocks x {threads} threads" if cluster > 1 else f"block barrier, {threads} threads"
        print(f"| {what} | {lat['step_barrier_ns']:.2f} |")
    print(f"| dependent FMA | {lat['fma_ns']:.3f} |")
    print(f"| block barrier, 32 threads | {lat['barrier_ns']:.2f} |", flush=True)
    if not ok:
        print("FAIL: a plan's screens differ from the plain loop's")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
