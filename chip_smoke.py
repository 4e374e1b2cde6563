"""Smoke test of the maria_torch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. card: a CUDA device is required; prints its name and power limit;
2. build: compiles the hand-written kernels (maria_torch/csrc) with nvcc,
   one process per source, and prints ptxas's register and spill lines;
3. K1 pink_noise against its plain torch version (irfft) at the slices'
   shapes (one pass at n_fft 3072; two passes at 32768 and 65536), a
   1-hour scan at 50 Hz (n_fft 196608, odd part 3, two passes) and a
   small one-pass case, |diff| <= 2e-4 x std;
4. K3 shared_v against its plain torch version (the same Philox and
   Box-Muller in torch ops) at the AtLAST shape (50,004 rows, m+1 =
   1537), at a small odd one, and as slice (c) launches it, with its
   spectrum into the matrix product's wider left operand: every element
   within one bf16 ulp, the operand's other columns untouched, and at
   the large shapes every column of V / c with mean and variance within
   5 sigma of N(0, 1);
5. slices (a), (b) and (d), the MUSTANG-2 main path, Simulation(...).run()
   -> TOD in K_RJ -> BinMapper(..., frame="az/el").run(), for the daisy
   at 60 s, 600 s and 1,200 s (217 x 60,000 samples, K1 at n_fft 65536
   in two passes): finite fields of the expected shapes, a hit map
   centre, K1 and K2 launched by the main path, and the noise PSD above
   twice the knee within 10% of the process's expected PSD;
6. slice (c), the AtLAST-50k total-power path: build_tod_program ->
   TODProgram.total_power_fn() (3-D Fourier atmosphere, the noise as one
   matrix product with V from K3) -> total pW (50,004 x 3000) -> binned
   into a 128 x 128 map over the field by K2: finite total of that shape,
   K3 launched once and K1 never by the total, K2 by the binning, a hit
   map centre, the map's hit counts equal to the plain binning's of the
   same total and its sums within 1e-4 of the map's maximum of the plain
   sums taken in float64, and per band the noise PSD above twice the
   knee within 10% of the process's expected PSD;
7. slices (e) and (f), the MUSTANG-2 main path of phase 5 with the 2-D
   autoregressive atmosphere (atmosphere_kwargs={"method": "ar"}) at 60 s
   and 600 s, held as there, the AR kernel launched once a run();
8. slice (g), slice (c)'s path with the 3-D AR atmosphere (12 layers
   stacked in one process), held as there, the AR kernel launched once a
   total;
9. the AR kernel ar_extrude against its plain torch loop on the same
   draws, for the processes of (e), (f) and (g), each set in one launch
   (A and B in the shared memory of one block a process at (e) and (f),
   of a cluster of blocks at (g); the plan is printed): every screen
   within 1e-4 of its std;
10. K2 bin_map against its plain torch version (index_add_, bincount) on
   N(0, 1) data at the pixel ids of slices (a), (b), (d) and (c), a
   random case with -1 ids, six channels at (d)'s ids (channels split
   over blocks) and (d)'s ids on a 512 x 512 map (global atomics), each
   as (data, 1) and as data with the in-kernel count: hit counts exact,
   sums within 1e-5 of the map's maximum of the plain sums taken in
   float64; and at slice (h)'s ra/dec ids on its 512 x 512 map;
11. slice (h), the observer's flow at full width: MUSTANG-2 at the GBT on
   a Planner-made 600 s ra/dec daisy over the synthetic big_cluster map
   (512 x 512, 0.5 deg) at (150, 10) deg with the 2-D atmosphere and
   noise, Simulation(..., map=...).run() -> BinMapper(frame="ra/dec") on
   the input map's grid: finite fields atmosphere, map and noise of 217 x
   30,000, K1 launched twice a run() and K2 once a BinMapper.run(), the
   noise PSD as in phase 5;
12. slice (i), (h) without an atmosphere: with noise=False the binned map
   against the beam-smoothed input map sampled on the mapper's grid,
   correlation above 0.95 over the better-covered half of the hit
   pixels; with noise=True the noise PSD and K1's launches;
13. slice (j), slice (c)'s scene observing the dust family, widened to
   the scan's field and centred on the boresight's mean ra/dec, through
   build_tod_program(input_map=) and total_power_fn(): held as slice (c),
   the "map" field finite and on the map; and total_power_fn() of the
   same scene with the map 1e6 times brighter minus the total of a
   map-free program on the same draws equal to gains x the "map" field
   to 1e-5 of its maximum (at the family's own brightness the field,
   ~1e-5 pW, lies under the float32 rounding of a ~100 pW total, so
   the difference of two totals cannot show it);
14. the map stage on the card against the CPU for (h)'s pointing: the
   beam-smoothed map (rfft2 on the card, float32) within 1e-5 of its
   maximum of the same smoothing in float64 on the CPU, the detectors'
   offsets from the map's centre (float32 both) within 2e-6
   rad, the card's samples within 1e-5 of the map's maximum of a float64
   gather on the CPU at the card's own offsets, and the calibrated,
   time-filtered "map" field of the noise-free scene within what one
   float32 ulp of ra moves a sample by.

Every kernel is timed (CUDA events, in turns) beside its plain version,
the PyTorch library call that computes the same function where there is
one (K1 torch.fft.irfft; K2 torch.bincount or index_add_ on ids filtered
beforehand; K3 and the AR kernel none), and its bound: the larger of its
bytes at 3.35 TB/s and its operations at their peak rate (K3: the least
loop body that meets its contract, K3_LEAST_BODY, for every bin pair at
the card's issue and pipe rates; the AR kernel: the latency of its chain
of dependent steps, ``ar_bound``, from an FMA latency and a one-warp
block's barrier probed on the card in the same run; the barrier a step of
the kernel really pays, of its block or its cluster, is probed and printed
beside them and enters no bound).

The line before the last is the card as nvidia-smi reports it, the one
before that the kernels' JSON record; the last line is the JSON result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SLICES = {"a": 60.0, "b": 600.0, "d": 1200.0}
AR_SLICES = {"e": 60.0, "f": 600.0}  # MUSTANG-2 with the 2-D AR atmosphere
ATLAST_BANDS = 9
N_MAP = 128
WARM_REPS = 5  # warm realizations a slice is timed over
MAP_WIDTH_DEG = 0.25
# peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM bytes/s, and
# float32 operations/s outside the tensor cores (67 TFLOP/s, an FMA as two)
HBM_BYTES_S = 3.35e12
F32_OPS = 67e12
# issue slots a second: 132 SMs x 4 sub-partitions x 32 lanes at the clock
# that gives 67 TFLOP/s (1.98 GHz), one warp instruction a sub-partition a
# cycle
LANE_INSTRUCTIONS_S = 67e12 / 2
# K3's least loop body: the warp instructions one bin pair (a lane) needs
# to meet K3's contract (Philox4x32-10 on its counter layout, then every
# element within one bf16 ulp of the plain version), by the pipe that runs
# them. PERF.md section 6 counts them; tests/test_torch_kernels.py
# (test_k3_least_body_*) emulates the body against the plain version.
K3_LEAST_BODY = {"imad": 18, "fp32": 40, "alu": 43, "xu": 8, "other": 6}


def k3_least_cycles() -> int:
    """Cycles that a warp's 32 bin pairs of K3's least body hold one H100
    SM sub-partition: the larger of issuing them (one a cycle) and each
    pipe's share (lanes a cycle: FP32 on two FMA pipes of 16, IMAD on one
    of them; ALU 16; XU, for I2F and MUFU, 4)."""
    b = K3_LEAST_BODY
    return max(sum(b.values()), 2 * b["imad"], b["imad"] + b["fp32"], 2 * b["alu"], 8 * b["xu"])


def fail(message: str):
    print(f"FAIL: {message}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(plain, kernel, library=None) -> tuple:
    """(kernel ms, plain ms, library ms or None), timed in turns plain,
    kernel, library, library, kernel, plain."""
    p1, k1 = cuda_ms(plain), cuda_ms(kernel)
    lib = (cuda_ms(library) + cuda_ms(library)) / 2 if library is not None else None
    k2, p2 = cuda_ms(kernel), cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2, lib


def bound(n_bytes: float, n_ops: float, op_rate: float = F32_OPS) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their peak rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S * 1e3, n_ops / op_rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def timing_line(name: str, r: dict) -> str:
    lib = f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None else "none"
    return (f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library call {lib}; bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}, kernel at {r['bound_ms'] / r['ms']:.1%} of it")


def check_pink_noise(device, gen, n_det, n, n_fft):
    import torch

    from maria_torch.noise import band_half_spectrum
    from maria_torch.ops.pink_noise import pink_noise, pink_noise_plain, pink_plan

    c = band_half_spectrum(50.0, 5.0, 1.0, n_fft, corr_prop=0.5)
    S = torch.randn((n_det, n_fft // 2 + 1, 2), generator=gen, device=device)
    x = pink_noise(c, S, n, n_fft)
    ref = pink_noise_plain(c, S, n, n_fft)
    torch.cuda.synchronize()
    err = float((x - ref).abs().max())
    std = float(ref.std())
    ok = x.shape == (n_det, n) and bool(torch.isfinite(x).all()) and err <= 2e-4 * std
    print(f"K1 pink_noise ({n_det}, {n}, n_fft {n_fft}): max|diff| {err:.3e} = {err / std:.2e} std "
          f"(limit 2e-4) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"K1 disagrees with its plain version at ({n_det}, {n}, {n_fft})")
    spectrum = torch.view_as_complex(S)
    ms, plain_ms, library_ms = paired_ms(lambda: pink_noise_plain(c, S, n, n_fft), lambda: pink_noise(c, S, n, n_fft),
                                         lambda: torch.fft.irfft(spectrum, n=n_fft))
    plan = pink_plan(n_fft)
    m = n_fft // 2
    r = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "shape": [n_det, n, n_fft],
         # the spectrum and the fold's alpha, gamma read, the rows written; an m-point complex FFT a row
         **bound(S.numel() * 4 + 16 * m + n_det * n * 4, n_det * 5 * m * np.log2(m))}
    print(timing_line(f"K1 pink_noise ({n_det}, {n}, n_fft {n_fft}; {plan['passes']} pass(es), {plan['n1']} x "
                      f"{plan['n2']}, batch {plan['batch']}; library call torch.fft.irfft)", r), flush=True)
    return r


def plain_sums64(data, ids, n_pix):
    """The plain binning (index_add_) of one channel, summed in float64:
    the reference for the float32 sums, whose atomic order varies."""
    import torch

    ids, data = ids.reshape(-1), data.reshape(-1)
    keep = (ids >= 0) & (ids < n_pix)
    out = torch.zeros(n_pix, dtype=torch.float64, device=data.device)
    return out.index_add_(0, ids[keep].long(), data[keep].double())


def check_bin_map(device, gen, ids, name, n_channels=1, n_pix=N_MAP * N_MAP):
    """K2 against its plain version, in two forms: the channels (data, 1)
    ("stacked") and the data with the in-kernel count ("count"). In both the last row is the hit count,
    which must equal bin_map_plain's, and each data channel's sums must
    lie within 1e-5 of the map's maximum of the plain sums taken in
    float64 (the float32 plain sums' own distance from them is printed).
    Beside the kernel and the plain version it times the faster library
    call: torch.bincount a row, or one index_add_, on ids (int64) and
    data filtered to the map beforehand. Returns {form: record}."""
    import torch

    from maria_torch.ops.bin_map import bin_map, bin_map_plain, bin_plan

    data = torch.randn((n_channels, *ids.shape), generator=gen, device=device)
    keep = ((ids >= 0) & (ids < n_pix)).reshape(-1)
    ids_kept = ids.reshape(-1)[keep].long()
    exact = [plain_sums64(data[s], ids, n_pix) for s in range(n_channels)]
    results = {}
    for form, channels, count in (("stacked", torch.cat([data, torch.ones_like(data[:1])]).contiguous(), False),
                                  ("count", data, True)):
        plan = bin_plan(n_pix, channels.shape[0], ids.numel(), count)
        layout = f"{plan['blocks']} blocks of {plan['span']} samples"
        if plan["groups"] > 1:
            layout = (f"{plan['groups'] - 1} x {plan['full_blocks']} blocks of {plan['full_span']} samples, then "
                      f"{layout}")
        label = (f"K2 bin_map ({name}, {form}, {n_channels} channel(s) {tuple(ids.shape)} into {n_pix} pixels; "
                 f"{plan['form']}, {layout})")
        out = bin_map(channels, ids, n_pix, count=count)
        ref = bin_map_plain(channels, ids, n_pix, count=count)
        torch.cuda.synchronize()
        counts_exact = bool(torch.equal(out[-1], ref[-1])) and float(ref[-1].sum()) > 0
        scale = max(max(float(e.abs().max()) for e in exact), 1e-30)
        err = max(float((out[s] - exact[s]).abs().max()) for s in range(n_channels))
        plain_err = max(float((ref[s] - exact[s]).abs().max()) for s in range(n_channels))
        ok = counts_exact and err <= 1e-5 * scale
        print(f"{label}: counts exact {counts_exact}, sums max|diff| from the float64 plain sums {err:.3e} = "
              f"{err / scale:.2e} of max (limit 1e-5; float32 plain {plain_err / scale:.2e}) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail(f"K2 disagrees with its plain version ({name}, {form})")

        rows_kept = channels.reshape(channels.shape[0], -1)[:, keep].contiguous()
        if count:
            rows_kept = torch.cat([rows_kept, torch.ones_like(rows_kept[:1])])
        n_rows = rows_kept.shape[0]

        def by_bincount():
            return [torch.bincount(ids_kept, weights=rows_kept[s], minlength=n_pix) for s in range(n_rows - count)] + (
                [torch.bincount(ids_kept, minlength=n_pix)] if count else [])

        def by_index_add():
            return torch.zeros((n_rows, n_pix), dtype=torch.float32, device=device).index_add_(1, ids_kept, rows_kept)

        ms, plain_ms, bincount_ms = paired_ms(lambda: bin_map_plain(channels, ids, n_pix, count=count),
                                              lambda: bin_map(channels, ids, n_pix, count=count), by_bincount)
        index_add_ms = (cuda_ms(by_index_add) + cuda_ms(by_index_add)) / 2
        r = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": min(bincount_ms, index_add_ms),
             "shape": [channels.shape[0], *ids.shape, n_pix],
             # ids and every channel read once, the map and its count written once; an add a sample and row
             **bound(4 * ids.numel() * (1 + channels.shape[0]) + 4 * n_pix * plan["slots"],
                     ids.numel() * plan["slots"])}
        print(timing_line(f"{label}; library call {'bincount' if bincount_ms <= index_add_ms else 'index_add_'} "
                          f"(bincount {bincount_ms:.4f} ms, index_add_ {index_add_ms:.4f} ms)", r), flush=True)
        results[form] = r
    return results


def bf16_ulp(x):
    """One bfloat16 ulp at |x| (8 significant bits)."""
    import torch

    _, e = torch.frexp(x.abs().clamp_min(1e-30))
    return torch.ldexp(torch.ones_like(x), e - 8)


def check_shared_v(device, gen, n_det, m1, c=None, n_extra=0):
    """K3 against its plain version. With ``n_extra``, it writes V into a
    (1, n_det, 2 m1 + n_extra) buffer, as the noise matrix product's left
    operand, whose last ``n_extra`` columns must keep their sentinel. Its
    bound: the bytes of V written, or K3's least loop body for every bin
    pair at the card's issue and pipe rates. No library call draws these
    bits."""
    import torch

    from maria_torch.noise import band_half_spectrum
    from maria_torch.ops.shared_v import draw_key, shared_v, shared_v_plain

    if c is None:
        c = band_half_spectrum(50.0, 0.5, 1.0, 2 * (m1 - 1), corr_prop=0.5)
    name = f"K3 shared_v ({n_det}, m+1 {m1}{f', row stride {2 * m1 + n_extra}' if n_extra else ''})"
    key = draw_key(gen, device)
    sentinel = -12288.0
    buf = torch.full((1, n_det, 2 * m1 + n_extra), sentinel, dtype=torch.bfloat16, device=device)
    V = shared_v(key, c, n_det, out=buf)[0].float()
    ref = shared_v_plain(key, c, n_det)[0].float()
    torch.cuda.synchronize()
    diff = (V - ref).abs()
    err = float(diff.max())
    within = bool((diff <= bf16_ulp(torch.maximum(V.abs(), ref.abs()))).all())
    exact = float((V == ref).float().mean())
    untouched = bool((buf[0, :, 2 * m1:] == sentinel).all())
    ok = V.shape == (n_det, 2 * m1) and bool(torch.isfinite(V).all()) and within and untouched
    line = (f"{name}: max|diff| {err:.3e}, all within one bf16 ulp {within}, "
            f"exact-equal share {exact:.6f}, other columns untouched {untouched}")
    if n_det >= 1000:
        x = V.double() / torch.as_tensor(np.concatenate([c, c]), device=device)
        mean_z = float((x.mean(dim=0).abs() * np.sqrt(n_det)).max())
        var_z = float(((x.var(dim=0) - 1).abs() / np.sqrt(2 / n_det)).max())
        ok &= mean_z <= 5 and var_z <= 5
        line += f"; V/c columns: max |mean| {mean_z:.2f} sigma, max |var - 1| {var_z:.2f} sigma (limit 5)"
    print(f"{line} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    ms, plain_ms, _ = paired_ms(lambda: shared_v_plain(key, c, n_det, out=buf),
                                lambda: shared_v(key, c, n_det, out=buf))
    r = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None, "shape": [n_det, 2 * m1],
         "exact_share": exact,
         **bound(2 * n_det * 2 * m1 + 4 * m1, k3_least_cycles() * n_det * ((m1 + 1) // 2), LANE_INSTRUCTIONS_S)}
    print(timing_line(f"{name} (least body: {k3_least_cycles()} issue cycles a bin pair)", r), flush=True)
    return r


def ar_bound(processes, lat) -> dict:
    """The AR kernel's bound: the larger of its bytes (operators, gather
    offsets and innovations read once, the buffer read and written once)
    at 3.35 TB/s and its latency: each process's chain of n_steps
    dependent steps, a step at least one block barrier plus one
    n_cross x (n_sample + n_cross) dot (B lower triangular), the dot no
    faster than its dependent depth (one FMA, then a tree of adds: 1 +
    ceil(log2(n_sample + n_cross)) dependent FMAs) nor than its FMAs at
    the card's float32 peak. ``lat`` holds a dependent FMA's latency and
    a barrier's in a block of one warp (PROBE_THREADS, whatever block the
    kernel launches), probed on the card in this run."""
    n_bytes, latency_ms = 0, 0.0
    for p in processes:
        n_c, n_s = p.n_cross_section, p.n_sample
        n_fma = n_c * n_s + n_c * (n_c + 1) // 2
        depth_ns = (1 + int(np.ceil(np.log2(n_s + n_c)))) * lat["fma_ns"]
        step_ns = lat["barrier_ns"] + max(depth_ns, 2 * n_fma / F32_OPS * 1e9)
        latency_ms = max(latency_ms, p.n_steps * step_ns * 1e-6)
        n_bytes += 4 * (n_fma + n_s + p.n_steps * n_c + 2 * p.n_buffer * n_c)
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    return {"bound_ms": max(t_bytes, latency_ms), "bound_by": "bytes" if t_bytes >= latency_ms else "operations",
            "latency_bound_ms": latency_ms, "bytes_bound_ms": t_bytes}


def check_ar_extrude(device, gen, label, processes):
    """The AR kernel, one launch for ``processes``, against its plain
    version (a torch loop a process) on the same draws: every screen
    within 1e-4 of its std. Times both (CUDA events in turns plain,
    kernel, kernel, plain; 20 kernel launches, 2 plain calls a turn) beside
    ``ar_bound``. No PyTorch call computes this recurrence."""
    import torch

    from maria_torch.ops.ar_extrude import PROBE_THREADS, ar_extrude, ar_extrude_reference, ar_plan, probe_latencies

    plan = ar_plan(processes, device)
    draws = [p.draw(gen, device) for p in processes]
    buffers, noises = [d[0] for d in draws], [d[1] for d in draws]
    tabs = [p.tensors(device) for p in processes]

    def plain():
        return [ar_extrude_reference(t["A"], t["B"], b, t["ext_idx"], t["cross_idx"], e)[: p.n_extrusion]
                for p, t, b, e in zip(processes, tabs, buffers, noises)]

    def kernel():
        return ar_extrude(processes, buffers, noises, plan=plan)

    before = ar_extrude.launches
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    launched = ar_extrude.launches - before
    errs = [float((o - r).abs().max()) for o, r in zip(out, ref)]
    rel = max(e / float(r.std()) for e, r in zip(errs, ref))
    ok = launched == len(plan["groups"]) == 1 and all(bool(torch.isfinite(o).all()) for o in out) and rel <= 1e-4
    shapes = [(p.n_extrusion, p.n_cross_section, p.n_sample) for p in processes]
    (group,) = plan["groups"]
    layout = (f"clusters of {group['cluster']} block(s) of {group['threads']} threads, {min(group['rows'])}-"
              f"{max(group['rows'])} rows of A and B and {group['smem']} B of shared memory a block, "
              f"{sum(c > 0 for c in plan['cluster'])} of {len(processes)} with A and B in shared memory")
    name = (f"AR ar_extrude ({label}: {len(processes)} process(es) in one launch, {layout}; n_extrusion x n_cross x "
            f"n_sample {shapes})")
    print(f"{name}: {launched} launch, max|diff| {max(errs):.3e} = {rel:.2e} of the screen's std (limit 1e-4) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"the AR kernel disagrees with its plain version ({label})")
    p1, k1 = cuda_ms(plain, reps=2), cuda_ms(kernel)
    k2, p2 = cuda_ms(kernel), cuda_ms(plain, reps=2)
    lat = probe_latencies(device, cluster=group["cluster"], threads=group["threads"])
    r = {"max_abs_err": max(errs), "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": None,
         "shape": shapes, "steps": max(p.n_steps for p in processes), "cluster": group["cluster"], **lat,
         **ar_bound(processes, lat)}
    step_barrier = (f"the step's own barrier (a cluster of {group['cluster']} x {group['threads']} threads) "
                    if group["cluster"] > 1 else f"the step's own barrier (a block of {group['threads']} threads) ")
    print(timing_line(f"{name} (longest chain {r['steps']} steps, {r['ms'] * 1e3 / r['steps']:.3f} us a step; probed: "
                      f"dependent FMA {lat['fma_ns']:.3f} ns, barrier of {PROBE_THREADS} threads "
                      f"{lat['barrier_ns']:.3f} ns, {step_barrier}{lat['step_barrier_ns']:.3f} ns; latency bound "
                      f"{r['latency_bound_ms']:.4f} ms, bytes {r['bytes_bound_ms']:.4f} ms; no library call)", r),
          flush=True)
    return r


def map_tod(tod):
    import maria_torch

    center = np.degrees(tod.boresight.center())
    return maria_torch.BinMapper(
        tod, center=center, width=MAP_WIDTH_DEG, resolution=MAP_WIDTH_DEG / N_MAP, frame="az/el",
    ).run()


def slice_pixel_ids(tod, mapper_map, n_map=N_MAP):
    """The ids BinMapper bins the slice at, on an n_map x n_map grid over
    the mapper's width."""
    from maria_torch.mappers.bin_mapper import azel_pixel_ids

    res = mapper_map.resolution * N_MAP / n_map
    return azel_pixel_ids(tod.pointing, mapper_map.center, res, n_map, n_map, device=tod.device).contiguous()


def check_noise_psd(sim, tod_pw):
    """Mean periodogram of the pW noise field in bins above twice the
    knee against the expected PSD of the process."""
    import torch

    from maria_torch.atmosphere.fourier import good_fft_size
    from maria_torch.noise import _pink_weights_np
    from maria_torch.ops.program import band_noise_basis

    band = sim.instrument.dets.bands[0]
    fs = sim.obs_list[0].sample_rate
    basis, cp = band_noise_basis(sim.instrument.dets.offsets, sim.noise_kwargs)
    x = tod_pw.data["noise"].double()
    n = x.shape[-1]
    X = torch.fft.rfft(x - x.mean(dim=-1, keepdim=True), dim=-1)
    measured = (X.abs() ** 2).mean(dim=0).cpu().numpy() / n
    f = np.fft.rfftfreq(n, d=1 / fs)
    w2 = _pink_weights_np(good_fft_size(n), fs, band.knee, 1.0) ** 2
    f_fft = np.fft.rfftfreq(good_fft_size(n), d=1 / fs)
    w2 = np.interp(f, f_fft, w2)
    b2 = float(np.mean(np.sum(np.asarray(basis) ** 2, axis=-1))) if cp else 0.0
    expected = (1e12 * band.NEP) ** 2 * (fs + (1 - cp) * w2 + cp * b2 * w2)
    edges = np.geomspace(2 * band.knee, 0.98 * fs / 2, 7)
    ratios = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        sel = (f >= lo) & (f < hi)
        ratios.append(float(measured[sel].mean() / expected[sel].mean()))
    ok = all(abs(r - 1) <= 0.10 for r in ratios)
    print(f"noise PSD / expected in bins {np.round(edges, 2).tolist()} Hz: "
          f"{[round(r, 4) for r in ratios]} (limit 10%) {'ok' if ok else 'FAIL'}", flush=True)
    return ok


def run_slice(label, duration, device, method="fourier"):
    import torch

    from maria_torch.ops.ar_extrude import ar_extrude
    from maria_torch.ops.bin_map import bin_map
    from maria_torch.ops.pink_noise import pink_noise
    from maria_torch.scenes import simulation

    s = time.perf_counter()
    sim = simulation("mustang2", duration, device, method=method)
    program = sim.program()
    print(f"slice ({label}) {duration:.0f} s, {method} atmosphere: scene setup {time.perf_counter() - s:.2f} s"
          + (f" ({len(program.ar_processes)} AR processes, n_extrusion x n_cross x n_sample "
             f"{[(p.n_extrusion, p.n_cross_section, p.n_sample) for p in program.ar_processes]})"
             if method == "ar" else ""), flush=True)

    pink_noise.launches = bin_map.launches = ar_extrude.launches = 0
    s = time.perf_counter()
    tod = sim.run()[0]
    torch.cuda.synchronize()
    run_s = time.perf_counter() - s
    s = time.perf_counter()
    out_map = map_tod(tod)
    torch.cuda.synchronize()
    map_s = time.perf_counter() - s
    launches = {"pink_noise": pink_noise.launches, "bin_map": bin_map.launches, "ar_extrude": ar_extrude.launches}
    print(f"slice ({label}): first run() {run_s:.3f} s, first BinMapper.run() {map_s:.3f} s, "
          f"main-path launches {launches}", flush=True)

    n_det, n_t = 217, int(round(duration * 50.0))
    ok = tod.shape == (n_det, n_t) and tod.units == "K_RJ" and tod.device.type == "cuda"
    ok &= all(bool(torch.isfinite(v).all()) for v in tod.data.values())
    ok &= set(tod.fields) == {"atmosphere", "noise"}
    ok &= tuple(out_map.data.shape) == (1, 1, 1, N_MAP, N_MAP)
    ok &= bool(torch.isfinite(out_map.data).all()) and float(out_map.weight[..., N_MAP // 2, N_MAP // 2].min()) > 0
    ok &= launches["pink_noise"] > 0 and launches["bin_map"] > 0
    ok &= launches["ar_extrude"] == (1 if method == "ar" else 0)
    print(f"slice ({label}): TOD {tod.shape} {tod.fields} in {tod.units}, atmosphere mean "
          f"{float(tod.data['atmosphere'].mean()):.3f} K_RJ, noise std {float(tod.data['noise'].std()):.3e} K_RJ, "
          f"map {tuple(out_map.data.shape)} centre weight {float(out_map.weight[..., N_MAP // 2, N_MAP // 2].min()):.0f} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"slice ({label}) output check")

    run_ms, map_ms = [], []
    for _ in range(WARM_REPS):
        s = time.perf_counter()
        tod = sim.run()[0]
        torch.cuda.synchronize()
        run_ms.append((time.perf_counter() - s) * 1e3)
        s = time.perf_counter()
        map_tod(tod)
        torch.cuda.synchronize()
        map_ms.append((time.perf_counter() - s) * 1e3)
    print(f"slice ({label}): warm run() {np.mean(run_ms):.2f} ms, warm BinMapper.run() {np.mean(map_ms):.2f} ms "
          f"(means of {WARM_REPS}; {[round(x, 2) for x in run_ms]}, {[round(x, 2) for x in map_ms]}; "
          f"{n_det * n_t} samples)", flush=True)

    if not check_noise_psd(sim, sim.run(units="pW")[0]):
        fail(f"slice ({label}) noise PSD")
    return tod, out_map, launches, program


def check_total_noise_psd(program, device, gen, label):
    """Per band, the mean periodogram of the matrix-product noise (A = 0)
    in bins above twice the knee against the process's expected PSD."""
    import torch

    from maria_torch.atmosphere.fourier import good_fft_size
    from maria_torch.noise import _pink_weights_np
    from maria_torch.noise.dft import noise_total_matmul

    specs, corr_cols, n_fft, shared_c, row_scale = program._noise_matmul_specs()
    noise = noise_total_matmul(0.0, specs, n=program.n_t, n_fft=n_fft, corr_cols=corr_cols, shared_c=shared_c,
                               row_scale=row_scale, generator=gen, device=device)
    fs, n = program.sample_rate, program.n_t
    f = np.fft.rfftfreq(n, d=1 / fs)
    worst = 0.0
    for i in program.band_order:
        band = program.bands[i]
        x = noise[int(band.det_index[0]):int(band.det_index[-1]) + 1].double()
        X = torch.fft.rfft(x - x.mean(dim=-1, keepdim=True), dim=-1)
        measured = (X.abs() ** 2).mean(dim=0).cpu().numpy() / n
        w2 = np.interp(f, np.fft.rfftfreq(good_fft_size(n), d=1 / fs),
                       _pink_weights_np(good_fft_size(n), fs, band.knee, 1.0) ** 2)
        cp = band.corr_prop
        b2 = float(np.mean(np.sum(np.asarray(band.noise_basis) ** 2, axis=-1))) if cp else 0.0
        expected = (1e12 * band.NEP) ** 2 * (fs + (1 - cp) * w2 + cp * b2 * w2)
        edges = np.geomspace(2 * band.knee, 0.98 * fs / 2, 7)
        ratios = [float(measured[(f >= lo) & (f < hi)].mean() / expected[(f >= lo) & (f < hi)].mean())
                  for lo, hi in zip(edges[:-1], edges[1:])]
        worst = max(worst, max(abs(r - 1) for r in ratios))
        print(f"slice ({label}) noise PSD / expected, {band.name}, bins {np.round(edges, 2).tolist()} Hz: "
              f"{[round(r, 4) for r in ratios]}", flush=True)
    ok = worst <= 0.10
    print(f"slice ({label}) noise PSD: worst |ratio - 1| {worst:.4f} (limit 10%) {'ok' if ok else 'FAIL'}", flush=True)
    return ok


def run_atlast(device, label="c", method="fourier", duration=60.0, n_det=5556 * ATLAST_BANDS, input_map=None):
    """Slices (c), (g) and (j): the AtLAST-50k total-power path (bench.py's
    config_b), with the 3-D Fourier or AR atmosphere and, with
    ``input_map``, that family of sky over the field."""
    import torch

    from maria_torch.mappers.bin_mapper import bin_total, field_pixel_ids
    from maria_torch.noise.dft import gemm_form
    from maria_torch.ops.ar_extrude import ar_extrude
    from maria_torch.ops.bin_map import bin_map, bin_map_plain
    from maria_torch.ops.pink_noise import pink_noise
    from maria_torch.ops.shared_v import shared_v
    from maria_torch.scenes import simulation

    s = time.perf_counter()
    sim = simulation("atlast", duration, device, method=method, input_map=input_map)
    program = sim.program()
    fn = program.total_power_fn()
    obs = sim.obs_list[0]
    ids, n_pix = field_pixel_ids(obs.boresight, obs.offsets, N_MAP, N_MAP, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - s
    if method == "ar":
        (p,) = program.ar_processes
        atmosphere = (f"{len(program.screens)} layers stacked in one AR process of n_extrusion {p.n_extrusion}, "
                      f"n_cross {p.n_cross_section}, n_sample {p.n_sample}")
    else:
        g = program.groups[0]
        atmosphere = f"{len(g.heights)} layers on a {g.ny} x {g.nx} grid, {g.W.shape[0]} kz nodes"
    print(f"slice ({label}) AtLAST-50k {duration:.0f} s, {method} atmosphere: host setup {setup_s:.2f} s "
          f"({program.n_det} detectors x {program.n_t} samples, {len(program.t_coarse)} coarse steps, {atmosphere}; "
          f"noise matmul {program.use_noise_matmul()}, shared shape {program._noise_matmul_specs()[3] is not None}, "
          f"GEMM form {gemm_form(device)})", flush=True)
    if input_map is not None:
        state = sim.generator.get_state()
        field = program.fields(generator=sim.generator, device=device, upto="signal")["map"]
        sim.generator.set_state(state)
        on_map = float((torch.cat([samples for b in program.bands for _, samples in b.map_stages]) != 0).float().mean())
        ok = tuple(field.shape) == (program.n_det, program.n_t) and bool(torch.isfinite(field).all())
        ok &= float(field.abs().max()) > 0 and on_map > 0.999
        print(f"slice ({label}): input map {sim.map}; 'map' field max {float(field.abs().max()):.3e} pW, share of the "
              f"samples on the map {on_map:.5f} {'ok' if ok else 'FAIL'}", flush=True)
        del field
        if not ok:
            fail(f"slice ({label}) map field")

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    pink_noise.launches = shared_v.launches = bin_map.launches = ar_extrude.launches = 0
    s = time.perf_counter()
    total = fn(generator=sim.generator, device=device)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - s
    launches_total = {"shared_v": shared_v.launches, "pink_noise": pink_noise.launches,
                      "ar_extrude": ar_extrude.launches}
    s = time.perf_counter()
    sums, hits = bin_total(total, ids, n_pix)
    torch.cuda.synchronize()
    map_s = time.perf_counter() - s
    launches = {"pink_noise": pink_noise.launches, "shared_v": shared_v.launches, "bin_map": bin_map.launches,
                "ar_extrude": ar_extrude.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if torch.device(device).type == "cuda" else float("nan")
    centre = (N_MAP // 2) * N_MAP + N_MAP // 2
    ok = tuple(total.shape) == (program.n_det, program.n_t) == (n_det, int(round(duration * 50.0)))
    ok &= total.dtype == torch.float32 and total.device.type == torch.device(device).type
    ok &= bool(torch.isfinite(total).all())
    ok &= launches_total == {"shared_v": 1, "pink_noise": 0, "ar_extrude": 1 if method == "ar" else 0}
    ok &= launches["bin_map"] == 1 and float(hits[centre]) > 0
    ok &= float(hits.double().sum()) == program.n_det * program.n_t
    print(f"slice ({label}): first total_power_fn() {cold_s:.3f} s, first binning {map_s:.3f} s, main-path launches "
          f"{launches}; total {tuple(total.shape)} {total.dtype} on {total.device.type}, mean "
          f"{float(total.mean()):.4f} pW, std {float(total.std()):.4f} pW; centre pixel hits {float(hits[centre]):.0f}; "
          f"peak device memory {peak_gb:.2f} GB (pixel ids and program tables included) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"slice ({label}) output check")

    # the main path's map against the plain binning of the same total.
    # Sums of ~3e4 positive samples a pixel, added in float32 in atomic
    # order, round at ~1e-5 of the sum, so the limit here is 1e-4 of the
    # map's maximum; K2's 1e-5 limit on zero-mean data at these ids is
    # held in check_bin_map.
    ref_hits = bin_map_plain(torch.stack([total, torch.ones_like(total)]), ids, n_pix)[1]
    exact = plain_sums64(total, ids, n_pix)
    hits_exact = bool(torch.equal(hits, ref_hits))
    scale = float(exact.abs().max())
    map_err = float((sums - exact).abs().max())
    ok = hits_exact and map_err <= 1e-4 * scale
    print(f"slice ({label}) map against the plain binning of the same total: hits exact {hits_exact}, sums max|diff| "
          f"from the float64 plain sums {map_err:.3e} = {map_err / scale:.2e} of max (limit 1e-4) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"slice ({label}) map disagrees with the plain version")

    del total, sums, hits, ref_hits, exact
    reps = WARM_REPS
    total_ms, map_ms = [], []
    for _ in range(reps):
        s = time.perf_counter()
        total = fn(generator=sim.generator, device=device)
        torch.cuda.synchronize()
        total_ms.append((time.perf_counter() - s) * 1e3)
        s = time.perf_counter()
        bin_total(total, ids, n_pix)
        torch.cuda.synchronize()
        map_ms.append((time.perf_counter() - s) * 1e3)
        del total
    t_ms, m_ms = float(np.mean(total_ms)), float(np.mean(map_ms))
    n_samples = program.n_det * program.n_t
    print(f"slice ({label}): warm total_power_fn() {t_ms:.2f} ms, warm binning {m_ms:.2f} ms (means of {reps}; "
          f"{[round(x, 2) for x in total_ms]}, {[round(x, 2) for x in map_ms]}), "
          f"{n_samples / ((t_ms + m_ms) * 1e-3):.4e} samples/s, GEMM form {gemm_form(device)}", flush=True)

    if not check_total_noise_psd(program, device, sim.generator, label):
        fail(f"slice ({label}) noise PSD")
    return launches, program, ids, sim


def run_sky_slice(label, device, atmosphere, noise, card, duration=600.0):
    """Slices (h) and (i): ``maria_torch.scenes.sky_simulation`` ->
    run() -> BinMapper in ra/dec on the input map's grid."""
    import torch

    from maria_torch.ops.ar_extrude import ar_extrude
    from maria_torch.ops.bin_map import bin_map
    from maria_torch.ops.pink_noise import pink_noise
    from maria_torch.scenes import sky_mapper, sky_recovery, sky_simulation

    s = time.perf_counter()
    sim = sky_simulation(duration, device, atmosphere=atmosphere, noise=noise)
    if atmosphere is not None:
        sim.program()
    torch.cuda.synchronize()
    plan = sim.plans[0]
    print(f"slice ({label}) {duration:.0f} s, atmosphere {atmosphere}, noise {noise}: scene setup "
          f"{time.perf_counter() - s:.2f} s; the Planner's plan starts {plan.start_time - 1.75e9:.0f} s after 1.75e9 in "
          f"{plan.frame}, boresight el {np.degrees(plan.el.min()):.1f}-{np.degrees(plan.el.max()):.1f} deg; input map "
          f"{sim.map}", flush=True)

    pink_noise.launches = bin_map.launches = ar_extrude.launches = 0
    s = time.perf_counter()
    tod = sim.run()[0]
    torch.cuda.synchronize()
    run_s = time.perf_counter() - s
    k1_run = pink_noise.launches
    s = time.perf_counter()
    out_map = sky_mapper([tod], sim.map).run()
    torch.cuda.synchronize()
    map_s = time.perf_counter() - s
    launches = {"pink_noise": pink_noise.launches, "bin_map": bin_map.launches, "ar_extrude": ar_extrude.launches}
    print(f"slice ({label}): first run() {run_s:.3f} s, first BinMapper.run() {map_s:.3f} s, main-path launches "
          f"{launches}", flush=True)

    n_det, n_t = 217, int(round(duration * 50.0))
    fields = {"map"} | ({"atmosphere"} if atmosphere is not None else set()) | ({"noise"} if noise else set())
    n = sim.map.n_x
    ok = tod.shape == (n_det, n_t) and tod.units == "K_RJ" and tod.device.type == "cuda"
    ok &= set(tod.fields) == fields and all(bool(torch.isfinite(v).all()) for v in tod.data.values())
    ok &= float(tod.data["map"].abs().max()) > 0
    ok &= tuple(out_map.data.shape) == (1, 1, 1, n, n) and out_map.frame == "ra/dec"
    ok &= bool(torch.isfinite(out_map.data).all()) and float(out_map.weight[..., n // 2, n // 2].min()) > 0
    ok &= float(out_map.weight.sum()) == n_det * n_t  # the whole scan lies on the input map
    ok &= k1_run == launches["pink_noise"] == (2 if noise else 0) and launches["bin_map"] == 1
    ok &= launches["ar_extrude"] == 0
    print(f"slice ({label}): TOD {tod.shape} {tod.fields} in {tod.units}, max |map| "
          f"{float(tod.data['map'].abs().max()):.3e} K_RJ, map {tuple(out_map.data.shape)} in {out_map.frame}, hit share "
          f"{float((out_map.weight > 0).float().mean()):.3f}, centre weight "
          f"{float(out_map.weight[..., n // 2, n // 2].min()):.0f} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"slice ({label}) output check")

    if atmosphere is None and not noise:
        corr = sky_recovery(sim, out_map)
        ok = corr > 0.95
        print(f"slice ({label}): binned map against the beam-smoothed input map on the mapper's grid, correlation over "
              f"the better-covered half of the hit pixels {corr:.5f} (limit 0.95) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"slice ({label}) does not recover its input map")

    run_ms, map_ms = [], []
    for _ in range(WARM_REPS):
        s = time.perf_counter()
        tod = sim.run()[0]
        torch.cuda.synchronize()
        run_ms.append((time.perf_counter() - s) * 1e3)
        s = time.perf_counter()
        sky_mapper([tod], sim.map).run()
        torch.cuda.synchronize()
        map_ms.append((time.perf_counter() - s) * 1e3)
    print(f"slice ({label}): warm run() {np.mean(run_ms):.2f} ms, warm BinMapper.run() {np.mean(map_ms):.2f} ms "
          f"(means of {WARM_REPS}; {[round(x, 2) for x in run_ms]}, {[round(x, 2) for x in map_ms]}; "
          f"{n_det * n_t} samples into {n} x {n} pixels; {card})", flush=True)

    if noise and not check_noise_psd(sim, sim.run(units="pW")[0]):
        fail(f"slice ({label}) noise PSD")
    return sim, tod, out_map, launches


def check_map_stage(sim, device):
    """The map stage on the card against the CPU, for the pointing and
    the map of ``sim`` (a scene without atmosphere or noise):
    ``maria_torch.scenes.map_stage_errors`` and its limits."""
    from maria_torch.scenes import map_stage_errors

    e = map_stage_errors(sim, device)
    ok = e["smooth"] <= 1e-5 and e["offsets_rad"] <= 2e-6 and e["gather"] <= 1e-5 and e["field"] <= e["field_limit"]
    print(f"map stage on the card against the CPU at slice (h)'s pointing {sim.obs_list[0].shape}: the beam-smoothed "
          f"map against a float64 smoothing {e['smooth']:.2e} of its max (limit 1e-5); offsets max|diff| "
          f"{e['offsets_rad']:.2e} rad (limit 2e-6); samples against a float64 gather at the card's offsets "
          f"{e['gather']:.2e} of the map's max (limit 1e-5); the 'map' field card against CPU {e['field']:.2e} of its "
          f"max (limit {e['field_limit']:.2e}: one float32 ulp of ra over the map's steepest pixel) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the map stage on the card disagrees with the CPU")


def check_total_carries_map(sim, device, label):
    """With slice (j)'s map made 1e6 times brighter: total_power_fn()
    minus the total of a map-free program on the same draws against
    gains x the "map" field, to 1e-5 of its maximum."""
    import torch

    from maria_torch.ops.program import build_tod_program

    obs = sim.obs_list[0]
    bright = sim.map._replace(data=sim.map.data * 1e6)
    kw = dict(with_noise=True, noise_kwargs=sim.noise_kwargs, device=device)
    program, bare = build_tod_program(obs, input_map=bright, **kw), build_tod_program(obs, **kw)
    state = sim.generator.get_state()
    with_map = program.total_power_fn()(generator=sim.generator, device=device)
    sim.generator.set_state(state)
    diff = with_map.double()
    largest = float(with_map.abs().max())
    del with_map
    diff -= bare.total_power_fn()(generator=sim.generator, device=device)
    sim.generator.set_state(state)
    field = program.fields(generator=sim.generator, device=device, upto="signal")["map"]
    gains = program.draw_gains(generator=sim.generator, device=device)
    expected = (gains * field).double()
    scale = float(expected.abs().max())
    err = float((diff - expected).abs().max())
    ok = scale > 0 and err <= 1e-5 * scale
    print(f"slice ({label}) with the map 1e6 times brighter: total minus the map-free total of the same draws against "
          f"gains x the 'map' field: max|diff| {err:.3e} pW = {err / scale:.2e} of the field's max {scale:.3e} pW "
          f"(limit 1e-5; largest total {largest:.1f} pW) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"slice ({label}): the total does not carry the map with the gains applied")


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on a card")
    sys.path.insert(0, HERE)
    try:
        import maria_torch  # noqa: F401
    except ImportError as e:
        fail(f"maria_torch is not importable from {HERE}: {e}")
    from maria_torch.mappers.bin_mapper import radec_pixel_ids
    from maria_torch.ops import kernels

    card = card_line()
    device = torch.device("cuda")
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    maria_torch.set_cache_dir(os.path.join(HERE, "build", "maria_torch", "cache"))

    built = kernels.build()
    print(f"build: {built['seconds']:.2f} s -> {os.path.relpath(built['path'], HERE)}", flush=True)
    for line in built["log"].splitlines():
        if any(word in line for word in ("entry function", "registers", "spill", "smem")):
            print(f"  ptxas: {line.strip()}", flush=True)
    kernels.load()

    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    k1 = {}
    for n_det, n, n_fft in ((217, 3000, 3072), (217, 30000, 32768), (5, 500, 512), (217, 60000, 65536),
                            (217, 180000, 196608)):
        k1[(n, n_fft)] = check_pink_noise(device, gen, n_det, n, n_fft)
    k3 = {}
    for n_det, m1 in ((5556 * ATLAST_BANDS, 1537), (5, 257)):
        k3[n_det] = check_shared_v(device, gen, n_det, m1)

    results = {}
    for label, duration in SLICES.items():
        results[label] = run_slice(label, duration, device)
    for label, duration in AR_SLICES.items():
        results[label] = run_slice(label, duration, device, method="ar")
    launches_c, program_c, ids_c, _ = run_atlast(device)
    _, corr_cols, _, shared_c, _ = program_c._noise_matmul_specs()
    check_shared_v(device, gen, program_c.n_det, len(shared_c), c=shared_c, n_extra=corr_cols.shape[1])
    launches_g, program_g, ids_g, _ = run_atlast(device, label="g", method="ar")
    del ids_g

    sim_h, tod_h, _, launches_h = run_sky_slice("h", device, "2d", True, card)
    sim_i, _, _, launches_i = run_sky_slice("i", device, None, False, card)
    check_map_stage(sim_i, device)
    launches_i_noise = run_sky_slice("i, noise on", device, None, True, card)[3]
    launches_j, _, ids_j, sim_j = run_atlast(device, label="j", input_map="dust")
    del ids_j
    check_total_carries_map(sim_j, device, "j")
    del sim_j

    ar = {label: check_ar_extrude(device, gen, f"slice {label}", results[label][3].ar_processes)
          for label in AR_SLICES}
    ar["g"] = check_ar_extrude(device, gen, "slice g", program_g.ar_processes)

    k2 = {}
    for label in SLICES:
        tod, out_map = results[label][:2]
        k2[label] = check_bin_map(device, gen, slice_pixel_ids(tod, out_map), f"slice {label} ids")
    k2["c"] = check_bin_map(device, gen, ids_c, "slice c ids")
    del ids_c
    ids = torch.randint(-1, N_MAP * N_MAP, (217, 3000), generator=gen, device=device, dtype=torch.int32)
    k2["random"] = check_bin_map(device, gen, ids, "random ids with -1")
    tod_d, map_d = results["d"][:2]
    k2["six"] = check_bin_map(device, gen, slice_pixel_ids(tod_d, map_d), "slice d ids", n_channels=6)
    k2["512"] = check_bin_map(device, gen, slice_pixel_ids(tod_d, map_d, n_map=512), "slice d ids, 512 x 512",
                              n_pix=512 * 512)
    sky = sim_h.map
    ids_h = radec_pixel_ids(tod_h.pointing, sky.center, sky.resolution, sky.n_x, sky.n_y, device=device).contiguous()
    k2["h"] = check_bin_map(device, gen, ids_h, "slice h ra/dec ids, 512 x 512", n_pix=sky.n_x * sky.n_y)
    for key, r in k2.items():
        for form, x in r.items():
            print(f"K2 summary {key} {form}: {x['ms']:.4f} ms, library {x['library_ms']:.4f} ms, bound "
                  f"{x['bound_ms']:.4f} ms ({x['bound_ms'] / x['ms']:.1%}), plain {x['plain_ms']:.4f} ms", flush=True)

    launches_b = results["b"][2]
    by_slice = {**{label: r[2] for label, r in results.items()}, "c": launches_c, "g": launches_g, "h": launches_h,
                "i": launches_i, "i, noise on": launches_i_noise, "j": launches_j}
    for name in ("pink_noise", "bin_map", "shared_v", "ar_extrude"):
        print(f"main-path launches of {name} by slice: {({k: v[name] for k, v in by_slice.items() if name in v})}",
              flush=True)
    kernels_line = {"kernels": [
        {"name": "pink_noise", "route": "cuda", "source": "maria_torch/csrc/pink_noise.cu",
         "replaces": "maria_tpu/ops/pallas_noise.py:269", "launches": launches_b["pink_noise"],
         **k1[(30000, 32768)]},
        {"name": "bin_map", "route": "cuda", "source": "maria_torch/csrc/bin_map.cu",
         "replaces": "maria_tpu/ops/pallas_binning.py:119", "launches": launches_b["bin_map"],
         **k2["b"]["stacked"]},
        {"name": "shared_v", "route": "cuda", "source": "maria_torch/csrc/shared_v.cu",
         "replaces": "maria_tpu/ops/pallas_noise.py:427", "launches": launches_c["shared_v"],
         **k3[5556 * ATLAST_BANDS]},
        {"name": "ar_extrude", "route": "cuda", "source": "maria_torch/csrc/ar_extrude.cu",
         "replaces": "maria_tpu/atmosphere/process.py:34", "launches": results["f"][2]["ar_extrude"],
         **ar["f"]},
    ]}
    for key, r in ar.items():
        launches = launches_g if key == "g" else results[key][2]
        print(f"AR summary {key}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_ms'] / r['ms']:.1%}), {r['steps']} steps, main-path launches {launches['ar_extrude']}",
              flush=True)
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
