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
   float32 ulp of ra moves a sample by;
15. KS1 sht_synth and KS2 sht_anal, the spherical harmonic transforms'
   Wigner-d recursion, against their plain torch versions at nside 1024
   and lmax 2500, for one CMB's aT, aE and aB drawn on the card: the
   scalar and spin-2 synthesis (every acc element equal, and the whole
   T, Q and U maps within 1e-5 of their maximum), then the analysis of
   those maps (every ys plane within 1e-5 of its maximum, and the a_lm);
   each timed beside its bound and the instruction bound of its rounding
   contract (``sht_bound``);
16. the spectra of a full-width CMB: generate_cmb(nside=1024) analysed at
   lmax 2500, TT, EE and BB band-averaged over l in [30, 1500) in bands
   of 100 within 10% of get_cmb_spectrum, the TE correlation within 0.1
   of the input's; KS1 and KS2 launched; the warm generate_cmb's
   seconds by stage (host tables, sign and phase tables, caps tables,
   draw, KS1, belt FFT, the polar caps' chirp-z on the card), the median
   of three runs with one seed, whose maps must be equal;
17. slice (k), the documented flow with a CMB: slice (h)'s scene with
   cmb="generate" (nside 1024): fields atmosphere, cmb, map and noise of
   217 x 30,000, the "cmb" field against _compute_cmb_loading's path on
   the same fine pwv (the difference's std under 5% of the field's, its
   max under half of it), KS1 launched by generate_cmb, K1 twice a run()
   and K2 once a BinMapper.run(), the noise PSD; the CMB stage's share of
   a warm run();
18. slice (l), (k) with only the CMB (no atmosphere, no input map, noise
   off) on (k)'s grid: the "cmb" field within 1e-5 of its maximum of a
   float64 evaluation of P0 w_I + dP/dT sum_s w_s map_s[pix] at the
   card's own pixel ids, the TOD's field the gains times it, and the
   binned sky term (the gains divided out, the monopole P0 w_I taken
   off) correlating above 0.95 with the unsmoothed CMB at the mapper's
   pixel centres over the better-covered half of the hit pixels;
19. slice (m), slice (c)'s AtLAST-50k total with cmb="generate" (nside
   1024) through build_tod_program(cmb=) and total_power_fn(), held as
   slice (c), and with the CMB 1e6 times brighter the total minus a
   CMB-free total on the same draws equal to gains x the "cmb" field to
   1e-5 of its maximum.

Every kernel is timed (CUDA events, in turns) beside its plain version,
the PyTorch library call that computes the same function where there is
one (K1 torch.fft.irfft; K2 torch.bincount or index_add_ on ids filtered
beforehand; K3, the AR kernel, KS1 and KS2 none), and its bound: the larger of its
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

import contextlib
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
SKY_NSIDE, SKY_LMAX = 1024, 2500  # the CMB's default nside and its lmax, min(3 nside - 1, 2500)
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


def cuda_ms(fn, reps: int = 20, warm: bool = True) -> float:
    import torch

    if warm:
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


@contextlib.contextmanager
def plain_transforms():
    """The spherical harmonic transforms with KS1 and KS2's plain versions
    in their place, on the card."""
    import maria_torch.healpix.sht as sht
    from maria_torch.ops.sht import sht_anal_plain, sht_synth_plain

    own = sht.sht_synth, sht.sht_anal
    sht.sht_synth, sht.sht_anal = sht_synth_plain, sht_anal_plain
    try:
        yield
    finally:
        sht.sht_synth, sht.sht_anal = own


@contextlib.contextmanager
def stage_times(targets: dict):
    """{label: seconds} of the functions ``targets`` names ({label: (module,
    attribute)}), each call timed from a synchronize before it to one after."""
    import torch

    times, own = {label: 0.0 for label in targets}, {}
    for label, (module, name) in targets.items():
        fn = own[label] = getattr(module, name)

        def timed(*args, _fn=fn, _label=label, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[_label] += time.perf_counter() - start
            return out

        setattr(module, name, timed)
    try:
        yield times
    finally:
        for label, (module, name) in targets.items():
            setattr(module, name, own[label])


def sht_bound(launches, synth: bool) -> dict:
    """The bound of KS1 (``synth``) or KS2 over ``launches`` [(tables,
    planes)]: the larger of the bytes (tables, seeds and planes read once,
    the output written once) at 3.35 TB/s and the flops at 67 TFLOP/s: a
    lane-step of the m <= l triangle (counted from these tables' seed
    steps) is 5 of the recursion and 2 a plane. Beside it
    ``contract_bound_ms``, the instruction bound of the same work as the
    kernels must do it: one FP32-pipe instruction a separately rounded
    operation (the recursion's 5; KS1's multiply and add a plane, which its
    bit-equal contract keeps from fusing; KS2's FMA a plane) at 132 SMs x
    128 lanes at 1.98 GHz."""
    n_bytes = n_flops = n_instructions = 0
    for t, x in launches:
        L, nh = t["seed_val"].shape
        S = x.shape[0]
        lane_steps = nh * int((L - t["seed_step"].clamp(max=L)).sum())
        n_flops += lane_steps * (5 + 2 * S)
        n_instructions += lane_steps * (5 + (2 * S if synth else S))
        n_bytes += 4 * (4 * L * L + 2 * L * nh + L + nh) + 4 * S * L * L + 4 * S * L * nh
    return {**bound(n_bytes, n_flops), "contract_bound_ms": n_instructions / LANE_INSTRUCTIONS_S * 1e3}


def check_sht_planes(label, launches, synth: bool):
    """One kind of KS1 or KS2 launch set against the plain version on the
    same inputs: every output plane within 1e-5 of its maximum and, for
    KS1, every element equal (the share of bit-equal elements printed),
    then kernel and plain timed in turns (plain, kernel, kernel, plain; 5
    kernel runs and 1 plain a turn)."""
    import torch

    from maria_torch.ops.sht import sht_anal, sht_anal_plain, sht_synth, sht_synth_plain

    kernel, plain = (sht_synth, sht_synth_plain) if synth else (sht_anal, sht_anal_plain)
    outs = [kernel(t, x) for t, x in launches]
    refs = [plain(t, x) for t, x in launches]
    torch.cuda.synchronize()
    worst, err, n_equal, n_all = 0.0, 0.0, 0, 0
    for out, ref in zip(outs, refs):
        for o, r in zip(out, ref):
            scale = float(r.abs().max())
            e = float((o - r).abs().max())
            err, worst = max(err, e), max(worst, e / scale if scale > 0 else float("inf"))
        n_equal += int((out == ref).sum())
        n_all += out.numel()
    ok = all(bool(torch.isfinite(o).all()) for o in outs) and worst <= 1e-5 and (n_equal == n_all or not synth)
    shapes = [tuple(x.shape) for _, x in launches]
    name = f"{'KS1 sht_synth' if synth else 'KS2 sht_anal'} ({label}; {len(launches)} launch(es) of planes {shapes})"
    print(f"{name}: every plane within {worst:.2e} of its maximum (limit 1e-5), bit-equal share {n_equal / n_all:.6f} "
          f"(KS1: limit 1) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    del outs, refs

    def run_kernel():
        return [kernel(t, x) for t, x in launches]

    def run_plain():
        return [plain(t, x) for t, x in launches]

    p1, k1 = cuda_ms(run_plain, reps=1, warm=False), cuda_ms(run_kernel, reps=5)
    k2, p2 = cuda_ms(run_kernel, reps=5), cuda_ms(run_plain, reps=1, warm=False)
    r = {"max_abs_err": err, "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": None,
         "shape": shapes, "exact_share": n_equal / n_all, **sht_bound(launches, synth)}
    print(timing_line(f"{name}; no library call; the contract's instruction bound {r['contract_bound_ms']:.4f} ms, kernel at "
                      f"{r['contract_bound_ms'] / r['ms']:.1%} of it", r), flush=True)
    return r


def check_maps_within(label, ours, refs, limit=1e-5):
    worst = max(float((o - r).abs().max()) / float(r.abs().max()) for o, r in zip(ours, refs))
    ok = worst <= limit and all(bool(o.isfinite().all()) for o in ours)
    print(f"{label}: within {worst:.2e} of their maximum (limit {limit:.0e}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{label} disagree with the plain transforms")


def check_sht(device, gen):
    """Phase 15: KS1 and KS2 against their plain versions at nside 1024
    and lmax 2500, for one CMB's aT, aE and aB drawn on the card."""
    from maria_torch.cmb import get_cmb_spectrum
    from maria_torch.healpix.sht import (
        alm2map, alm2map_spin, anal_inputs, map2alm, map2alm_spin, synalm_cmb_device, synth_inputs,
    )

    aT, aE, aB = synalm_cmb_device(get_cmb_spectrum(lmax=SKY_LMAX), SKY_LMAX, generator=gen)
    out = {"synth": check_sht_planes("scalar synthesis of aT", synth_inputs(aT, SKY_NSIDE), True),
           "synth_spin": check_sht_planes("spin-2 synthesis of aE, aB", synth_inputs(aB, SKY_NSIDE, e=aE), True)}
    T, (Q, U) = alm2map(aT, SKY_NSIDE), alm2map_spin(aE, aB, SKY_NSIDE)
    with plain_transforms():
        T_plain, (Q_plain, U_plain) = alm2map(aT, SKY_NSIDE), alm2map_spin(aE, aB, SKY_NSIDE)
    check_maps_within(f"the T, Q and U maps (nside {SKY_NSIDE}) against the plain transforms'", (T, Q, U),
                      (T_plain, Q_plain, U_plain))
    del T_plain, Q_plain, U_plain
    out["anal"] = check_sht_planes("scalar analysis of T", anal_inputs(T, SKY_LMAX), False)
    out["anal_spin"] = check_sht_planes("spin-2 analysis of Q, U", anal_inputs(Q, SKY_LMAX, U=U), False)
    alms = (map2alm(T, SKY_LMAX), *map2alm_spin(Q, U, SKY_LMAX))
    with plain_transforms():
        alms_plain = (map2alm(T, SKY_LMAX), *map2alm_spin(Q, U, SKY_LMAX))
    check_maps_within(f"aT, aE and aB of those maps (lmax {SKY_LMAX}) against the plain transforms'", alms, alms_plain)
    return out


def band_spectra(alms, spec):
    """TT, EE, BB band powers over l in [30, 1500) in bands of 100 against
    the input's, and the TE correlation against the input's, per band."""
    import torch

    aT, aE, aB = alms
    ell = np.arange(SKY_LMAX + 1)
    bands = [(lo, min(lo + 100, 1500)) for lo in range(30, 1500, 100)]

    def cross(x, y):
        p = (x * y.conj()).real.double()
        return ((2 * p.sum(1) - p[:, 0]) / torch.as_tensor(2 * ell + 1, device=p.device)).cpu().numpy()

    cl = {"TT": cross(aT, aT), "EE": cross(aE, aE), "BB": cross(aB, aB), "TE": cross(aT, aE)}
    ratios = {k: [float(cl[k][lo:hi].sum() / spec[k][lo:hi].sum()) for lo, hi in bands] for k in ("TT", "EE", "BB")}
    rho = [(float(cl["TE"][lo:hi].sum() / np.sqrt(cl["TT"][lo:hi].sum() * cl["EE"][lo:hi].sum())),
            float(spec["TE"][lo:hi].sum() / np.sqrt(spec["TT"][lo:hi].sum() * spec["EE"][lo:hi].sum())))
           for lo, hi in bands]
    return bands, ratios, rho


def check_cmb_spectra(device):
    """Phase 16: a full-width CMB's spectra, KS1's and KS2's launches on
    that path, and the warm generate_cmb by stage."""
    import torch

    import maria_torch.cmb as cmb_module
    import maria_torch.healpix.sht as sht
    from maria_torch.cmb import generate_cmb, get_cmb_spectrum
    from maria_torch.ops.sht import sht_anal, sht_synth

    sht_synth.launches = sht_anal.launches = 0
    s = time.perf_counter()
    cmb = generate_cmb(nside=SKY_NSIDE, seed=0, device=device)
    T, Q, U = cmb.data[:, 0, 0]
    alms = (sht.map2alm(T, SKY_LMAX), *sht.map2alm_spin(Q, U, SKY_LMAX))
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - s
    launches = {"sht_synth": sht_synth.launches, "sht_anal": sht_anal.launches}
    bands, ratios, rho = band_spectra(alms, get_cmb_spectrum(lmax=SKY_LMAX))
    worst = max(abs(r - 1) for v in ratios.values() for r in v)
    worst_rho = max(abs(a - b) for a, b in rho)
    ok = launches == {"sht_synth": 3, "sht_anal": 3} and cmb.shape == (3, 1, 1, 12 * SKY_NSIDE**2)
    ok &= bool(torch.isfinite(cmb.data).all()) and worst <= 0.10 and worst_rho <= 0.1
    for k, v in ratios.items():
        print(f"CMB spectra: {k} band power / input in bands {bands[0]}..{bands[-1]}: {[round(r, 4) for r in v]}",
              flush=True)
    print(f"CMB spectra: TE correlation (measured, input) per band {[(round(a, 3), round(b, 3)) for a, b in rho]}",
          flush=True)
    print(f"CMB spectra of generate_cmb(nside={SKY_NSIDE}) at lmax {SKY_LMAX}: worst |band power / input - 1| "
          f"{worst:.4f} (limit 0.10), worst |TE correlation - input| {worst_rho:.4f} (limit 0.1); launches {launches}; "
          f"cold generate + analysis {cold_s:.2f} s {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the generated CMB does not carry its input spectra")
    del alms, cmb, T, Q, U
    targets = {"host tables": (sht, "lane_tables"), "sign and phase tables": (sht, "_device_consts"),
               "caps tables": (sht, "_cap_tables"), "draw": (cmb_module, "synalm_cmb_device"),
               "KS1 (with its row packing)": (sht, "sht_synth"), "belt FFT": (sht, "_belt_synth"),
               "polar caps (chirp-z)": (sht, "_caps_synth")}
    warm, first, same = [], None, True
    for _ in range(3):
        with stage_times(targets) as times:
            torch.cuda.synchronize()
            s = time.perf_counter()
            maps = generate_cmb(nside=SKY_NSIDE, seed=1, device=device).data
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - s, dict(times)))
        if first is None:
            first = maps
        else:
            same &= bool(torch.equal(maps, first))
    del maps, first
    warm_s, times = sorted(warm, key=lambda w: w[0])[1]
    stages = ", ".join(f"{k} {v:.4f} s" for k, v in times.items())
    print(f"warm generate_cmb(nside={SKY_NSIDE}, lmax {SKY_LMAX}), the median of 3: {warm_s:.4f} s "
          f"({[round(w[0], 4) for w in warm]}); by stage: {stages}; the rest (the a_lm streams, complex assembly, "
          f"casts) {warm_s - sum(times.values()):.4f} s; the same seed gives the same maps: {same}", flush=True)
    if not same:
        fail("generate_cmb gives different maps for one seed")
    return launches, {"warm_s": warm_s, **times}


def check_cmb_only(sim, tod, out_map, device):
    """Slice (l)'s checks: the "cmb" field against a float64 evaluation
    at the card's own pixel ids, the TOD's field against the gains times
    it, and the binned sky term against the unsmoothed CMB."""
    import torch

    from maria_torch.ops.program import gain_errors
    from maria_torch.scenes import cmb_recovery, sky_mapper
    from maria_torch.sim.cmb import cmb_power_grids
    from maria_torch.tod import TOD, Pointing

    obs = sim.obs_list[0]
    dets = obs.instrument.dets
    loading = sim._compute_cmb_loading(obs)
    sw = torch.as_tensor(np.asarray(dets.stokes_weight(), dtype=np.float64))
    pix = sim.cmb.radec_pixels(*Pointing(obs.boresight, obs.offsets, obs.q).det_radec(device=device)).cpu()
    data = sim.cmb.data[:, 0, 0].double().cpu()
    sky = sum(sw[:, s, None] * data[s][pix] for s in range(sim.cmb.n_stokes))
    expected = torch.zeros(obs.shape, dtype=torch.float64)
    P0s = {}
    for band in dets.bands:
        rows = torch.as_tensor(np.where(dets.band_name == band.name)[0])
        P0, dPdT = (x.double().cpu() for x in cmb_power_grids(obs, band, device))
        P0s[band.name] = P0
        expected[rows] = P0 * sw[rows, :1] + dPdT * sky[rows]
    scale = float(expected.abs().max())
    err = float((loading.double().cpu() - expected).abs().max())
    state = sim.generator.get_state()
    tod_pw = sim.run(units="pW")[0]
    sim.generator.set_state(state)
    gains = gain_errors(dets.gain_error, sim.generator, None, device)
    sim.generator.set_state(state)
    gained = bool(torch.equal(tod_pw.data["cmb"], loading * gains))
    ok = err <= 1e-5 * scale and gained and tod.fields == ["cmb"]
    print(f"slice (l): 'cmb' field against a float64 evaluation of P0 w_I + dP/dT sum_s w_s map_s[pix] at the card's "
          f"pixel ids: {err / scale:.2e} of its max (limit 1e-5); the TOD's field the gains times it: {gained} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (l) cmb field")
    # the binned sky term: the 5% gain errors times the monopole P0 w_I
    # (~0.03 pW) outweigh the anisotropy (~1e-5 pW) a hundredfold, so the
    # gains are divided out and the monopole taken off before binning
    term = tod_pw.data["cmb"] / gains
    for band in dets.bands:
        rows = torch.as_tensor(np.where(dets.band_name == band.name)[0], device=device)
        term[rows] -= (P0s[band.name].to(device) * sw[rows.cpu(), :1].to(device)).float()
    sky_tod = TOD(data={"cmb": term}, pointing=tod_pw.pointing, units="pW", dets=dets, metadata=tod_pw.metadata)
    binned = sky_mapper([sky_tod], out_map).run()
    corr = cmb_recovery(sim.cmb, binned)
    ok = corr > 0.95
    print(f"slice (l): the binned sky term against the unsmoothed CMB at the mapper's pixel centres, correlation over "
          f"the better-covered half of the hit pixels {corr:.5f} (limit 0.95) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (l) does not recover the CMB")


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


def run_atlast(device, label="c", method="fourier", duration=60.0, n_det=5556 * ATLAST_BANDS, input_map=None,
               cmb=None):
    """Slices (c), (g), (j) and (m): the AtLAST-50k total-power path
    (bench.py's config_b), with the 3-D Fourier or AR atmosphere and, with
    ``input_map``, that family of sky over the field, with ``cmb`` a CMB."""
    import torch

    from maria_torch.mappers.bin_mapper import bin_total, field_pixel_ids
    from maria_torch.noise.dft import gemm_form
    from maria_torch.ops.ar_extrude import ar_extrude
    from maria_torch.ops.bin_map import bin_map, bin_map_plain
    from maria_torch.ops.pink_noise import pink_noise
    from maria_torch.ops.shared_v import shared_v
    from maria_torch.scenes import simulation

    s = time.perf_counter()
    sim = simulation("atlast", duration, device, method=method, input_map=input_map, cmb=cmb)
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
    if cmb is not None:
        state = sim.generator.get_state()
        field = program.fields(generator=sim.generator, device=device, upto="signal")["cmb"]
        sim.generator.set_state(state)
        ok = tuple(field.shape) == (program.n_det, program.n_t) and bool(torch.isfinite(field).all())
        ok &= all(b.cmb_samples is not None and b.cmb_samples.device.type == "cuda" for b in program.bands)
        ok &= float(field.std()) > 0
        print(f"slice ({label}): CMB {sim.cmb}; 'cmb' field mean {float(field.mean()):.4e} pW, std "
              f"{float(field.std()):.3e} pW {'ok' if ok else 'FAIL'}", flush=True)
        del field
        if not ok:
            fail(f"slice ({label}) cmb field")

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


def run_sky_slice(label, device, atmosphere, noise, card, duration=600.0, cmb=None, input_map=True):
    """Slices (h), (i), (k) and (l): ``maria_torch.scenes.sky_simulation``
    -> run() -> BinMapper in ra/dec on the input map's grid (big_cluster's,
    also where the simulation leaves the map out)."""
    import torch

    import maria_torch
    import maria_torch.sim.simulation as simulation_module
    from maria_torch.ops.ar_extrude import ar_extrude
    from maria_torch.ops.bin_map import bin_map
    from maria_torch.ops.pink_noise import pink_noise
    from maria_torch.ops.sht import sht_anal, sht_synth
    from maria_torch.scenes import SKY_CENTER, sky_mapper, sky_recovery, sky_simulation

    pink_noise.launches = bin_map.launches = ar_extrude.launches = sht_synth.launches = sht_anal.launches = 0
    s = time.perf_counter()
    with stage_times({"cmb": (simulation_module, "initialize_cmb")}) as cmb_s:
        sim = sky_simulation(duration, device, atmosphere=atmosphere, noise=noise, cmb=cmb, input_map=input_map)
    if atmosphere is not None:
        sim.program()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - s
    setup_launches = {"sht_synth": sht_synth.launches, "sht_anal": sht_anal.launches}
    grid = sim.map if sim.map is not None else maria_torch.map.get("big_cluster", center=SKY_CENTER)
    plan = sim.plans[0]
    print(f"slice ({label}) {duration:.0f} s, atmosphere {atmosphere}, noise {noise}, cmb {cmb}: scene setup "
          f"{setup_s:.2f} s (the CMB {cmb_s['cmb']:.2f} s of it; setup launches {setup_launches}); the Planner's plan "
          f"starts {plan.start_time - 1.75e9:.0f} s after 1.75e9 in {plan.frame}, boresight el "
          f"{np.degrees(plan.el.min()):.1f}-{np.degrees(plan.el.max()):.1f} deg; input map {sim.map}; CMB {sim.cmb}",
          flush=True)

    pink_noise.launches = bin_map.launches = ar_extrude.launches = sht_synth.launches = sht_anal.launches = 0
    s = time.perf_counter()
    tod = sim.run()[0]
    torch.cuda.synchronize()
    run_s = time.perf_counter() - s
    k1_run = pink_noise.launches
    s = time.perf_counter()
    out_map = sky_mapper([tod], grid).run()
    torch.cuda.synchronize()
    map_s = time.perf_counter() - s
    launches = {"pink_noise": pink_noise.launches, "bin_map": bin_map.launches, "ar_extrude": ar_extrude.launches,
                "sht_synth": setup_launches["sht_synth"] + sht_synth.launches, "sht_anal": sht_anal.launches}
    print(f"slice ({label}): first run() {run_s:.3f} s, first BinMapper.run() {map_s:.3f} s, main-path launches "
          f"{launches} (KS1's in the setup)", flush=True)

    n_det, n_t = 217, int(round(duration * 50.0))
    fields = ({"map"} if input_map else set()) | ({"atmosphere"} if atmosphere is not None else set()) | (
        {"noise"} if noise else set()) | ({"cmb"} if cmb else set())
    n = grid.n_x
    ok = tod.shape == (n_det, n_t) and tod.units == "K_RJ" and tod.device.type == "cuda"
    ok &= set(tod.fields) == fields and all(bool(torch.isfinite(v).all()) for v in tod.data.values())
    ok &= all(float(tod.data[k].abs().max()) > 0 for k in fields & {"map", "cmb"})
    ok &= tuple(out_map.data.shape) == (1, 1, 1, n, n) and out_map.frame == "ra/dec"
    ok &= bool(torch.isfinite(out_map.data).all()) and float(out_map.weight[..., n // 2, n // 2].min()) > 0
    ok &= float(out_map.weight.sum()) == n_det * n_t  # the whole scan lies on the input map
    ok &= k1_run == launches["pink_noise"] == (2 if noise else 0) and launches["bin_map"] == 1
    ok &= launches["ar_extrude"] == 0 and launches["sht_anal"] == 0
    ok &= launches["sht_synth"] == (3 if cmb else 0) and sht_synth.launches == 0  # KS1 in generate_cmb alone
    maxima = ", ".join(f"max |{k}| {float(tod.data[k].abs().max()):.3e} K_RJ" for k in sorted(fields & {"map", "cmb"}))
    print(f"slice ({label}): TOD {tod.shape} {tod.fields} in {tod.units}, {maxima}, map {tuple(out_map.data.shape)} in "
          f"{out_map.frame}, hit share {float((out_map.weight > 0).float().mean()):.3f}, centre weight "
          f"{float(out_map.weight[..., n // 2, n // 2].min()):.0f} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"slice ({label}) output check")

    if cmb and atmosphere is not None:
        # the program's CMB stage against the chain outside it, on the same fine pwv
        obs = sim.obs_list[0]
        state = sim.generator.get_state()
        signal, pwv = sim.program().fields(generator=sim.generator, device=device)
        sim.generator.set_state(state)
        obs.zenith_scaled_pwv = pwv
        outside = sim._compute_cmb_loading(obs)
        diff = (signal["cmb"] - outside).double()
        std = float(outside.double().std())
        ok = float(diff.std()) < 0.05 * std and float(diff.abs().max()) < 0.5 * std
        print(f"slice ({label}): the program's 'cmb' field against _compute_cmb_loading's on the same fine pwv: the "
              f"difference's std {float(diff.std()) / std:.4f} of the field's (limit 0.05), its max "
              f"{float(diff.abs().max()) / std:.4f} (limit 0.5) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"slice ({label}) program cmb stage")
        del signal, outside, diff
        program = sim.program()
        stage_ms = {}
        for stage in ("with", "without"):
            kept = [b.cmb_samples for b in program.bands]
            if stage == "without":
                for b in program.bands:
                    b.cmb_samples = None
            ms = []
            for _ in range(WARM_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                program.fields(generator=sim.generator, device=device, upto="signal")
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            for b, samples in zip(program.bands, kept):
                b.cmb_samples = samples
            stage_ms[stage] = float(np.mean(ms))
        print(f"slice ({label}): fields(upto='signal') {stage_ms['with']:.2f} ms with the CMB stage, "
              f"{stage_ms['without']:.2f} ms without: the CMB stage {stage_ms['with'] - stage_ms['without']:.2f} ms "
              f"(means of {WARM_REPS}; {card})", flush=True)
    if cmb and atmosphere is None:
        check_cmb_only(sim, tod, out_map, device)

    if atmosphere is None and not noise and input_map:
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
        sky_mapper([tod], grid).run()
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


def check_total_carries(sim, device, label, stage="map"):
    """With slice (j)'s map (stage "map") or slice (m)'s CMB ("cmb") made
    1e6 times brighter: total_power_fn() minus the total of a program
    without that stage on the same draws against gains x the stage's
    field, to 1e-5 of its maximum."""
    import torch

    from maria_torch.ops.program import build_tod_program

    obs = sim.obs_list[0]
    sky = sim.map if stage == "map" else sim.cmb
    bright = {"input_map" if stage == "map" else "cmb": sky._replace(data=sky.data * 1e6)}
    kw = dict(with_noise=True, noise_kwargs=sim.noise_kwargs, device=device)
    program, bare = build_tod_program(obs, **bright, **kw), build_tod_program(obs, **kw)
    state = sim.generator.get_state()
    with_map = program.total_power_fn()(generator=sim.generator, device=device)
    sim.generator.set_state(state)
    diff = with_map.double()
    largest = float(with_map.abs().max())
    del with_map
    diff -= bare.total_power_fn()(generator=sim.generator, device=device)
    sim.generator.set_state(state)
    field = program.fields(generator=sim.generator, device=device, upto="signal")[stage]
    gains = program.draw_gains(generator=sim.generator, device=device)
    expected = (gains * field).double()
    scale = float(expected.abs().max())
    err = float((diff - expected).abs().max())
    ok = scale > 0 and err <= 1e-5 * scale
    print(f"slice ({label}) with the {stage} 1e6 times brighter: total minus the {stage}-free total of the same draws "
          f"against gains x the '{stage}' field: max|diff| {err:.3e} pW = {err / scale:.2e} of the field's max "
          f"{scale:.3e} pW (limit 1e-5; largest total {largest:.1f} pW) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"slice ({label}): the total does not carry the {stage} with the gains applied")


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
    check_total_carries(sim_j, device, "j")
    del sim_j

    ks = check_sht(device, gen)
    launches_spectra, _ = check_cmb_spectra(device)
    launches_k = run_sky_slice("k", device, "2d", True, card, cmb="generate")[3]
    launches_l = run_sky_slice("l", device, None, False, card, cmb="generate", input_map=False)[3]
    launches_m, _, ids_m, sim_m = run_atlast(device, label="m", cmb="generate")
    del ids_m
    check_total_carries(sim_m, device, "m", stage="cmb")
    del sim_m

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
                "i": launches_i, "i, noise on": launches_i_noise, "j": launches_j, "CMB spectra": launches_spectra,
                "k": launches_k, "l": launches_l, "m": launches_m}
    for name in ("pink_noise", "bin_map", "shared_v", "ar_extrude", "sht_synth", "sht_anal"):
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
        {"name": "sht_synth", "route": "cuda", "source": "maria_torch/csrc/sht.cu",
         "replaces": "maria_tpu/healpix/sht.py:480", "launches": launches_k["sht_synth"], **ks["synth"]},
        {"name": "sht_anal", "route": "cuda", "source": "maria_torch/csrc/sht.cu",
         "replaces": "maria_tpu/healpix/sht.py:523", "launches": launches_spectra["sht_anal"], **ks["anal"]},
    ]}
    for key, r in ks.items():
        print(f"KS summary {key}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_ms'] / r['ms']:.1%}), the contract's instruction bound {r['contract_bound_ms']:.4f} ms "
              f"({r['contract_bound_ms'] / r['ms']:.1%}), bit-equal share {r['exact_share']:.6f}", flush=True)
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
