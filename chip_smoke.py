"""Smoke test of the maria_torch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. card: a CUDA device is required; prints its name and power limit;
2. build: compiles the hand-written kernels (maria_torch/csrc) with nvcc;
3. K1 pink_noise against its plain torch version (irfft) at the slice's
   shapes and a small single-DFT case, |diff| <= 2e-4 x std;
4. K2 bin_map against its plain torch version (index_add_) on the
   slice's pixel ids and a random case with -1 ids: hit counts exact,
   sums within 1e-5 of the map's maximum;
5. the main path, Simulation(...).run() -> TOD in K_RJ ->
   BinMapper(..., frame="az/el").run(), for the MUSTANG-2 daisy at 60 s
   and at 600 s: finite fields of the expected shapes, a hit map centre,
   both kernels launched by the main path, and the noise PSD above twice
   the knee within 10% of the process's expected PSD.

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
SLICES = {"a": 60.0, "b": 600.0}
N_MAP = 128
MAP_WIDTH_DEG = 0.25


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


def paired_ms(plain, kernel) -> tuple:
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def check_pink_noise(device, gen, n_det, n, n_fft):
    import torch

    from maria_torch.noise import band_half_spectrum
    from maria_torch.ops.pink_noise import pink_noise, pink_noise_plain

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
    ms, plain_ms = paired_ms(lambda: pink_noise_plain(c, S, n, n_fft), lambda: pink_noise(c, S, n, n_fft))
    print(f"K1 pink_noise ({n_det}, {n}, n_fft {n_fft}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "shape": [n_det, n, n_fft]}


def check_bin_map(device, gen, ids, name):
    import torch

    from maria_torch.ops.bin_map import bin_map, bin_map_plain

    n_pix = N_MAP * N_MAP
    data = torch.randn(ids.shape, generator=gen, device=device)
    channels = torch.stack([data, torch.ones_like(data)]).contiguous()
    out = bin_map(channels, ids, n_pix)
    ref = bin_map_plain(channels, ids, n_pix)
    torch.cuda.synchronize()
    counts_exact = bool(torch.equal(out[1], ref[1]))
    err = float((out[0] - ref[0]).abs().max())
    scale = max(float(ref[0].abs().max()), 1e-30)
    ok = counts_exact and err <= 1e-5 * scale and float(ref[1].sum()) > 0
    print(f"K2 bin_map ({name}, {tuple(ids.shape)}): counts exact {counts_exact}, "
          f"max|diff| {err:.3e} = {err / scale:.2e} of max (limit 1e-5) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"K2 disagrees with its plain version ({name})")
    ms, plain_ms = paired_ms(lambda: bin_map_plain(channels, ids, n_pix), lambda: bin_map(channels, ids, n_pix))
    print(f"K2 bin_map ({name}, {tuple(ids.shape)}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "shape": [2, *ids.shape, n_pix]}


def make_sim(duration, device):
    import maria_torch

    plan = maria_torch.get_plan(
        "daisy_5arcmin_60s", start_time=1.75e9, scan_center=(150.0, 41.0), frame="az/el",
        duration=duration, sample_rate=50.0, scan_options={"radius": 0.083, "speed": 0.017},
    )
    return maria_torch.Simulation(
        instrument="MUSTANG-2", plans=plan, site="GBT", atmosphere="2d", noise=True, seed=0, device=device,
    )


def map_tod(tod):
    import maria_torch

    center = np.degrees(tod.boresight.center())
    return maria_torch.BinMapper(
        tod, center=center, width=MAP_WIDTH_DEG, resolution=MAP_WIDTH_DEG / N_MAP, frame="az/el",
    ).run()


def slice_pixel_ids(tod, mapper_map):
    import torch

    from maria_torch.coords import phi_theta_to_offsets
    from maria_torch.mappers.bin_mapper import pixel_ids

    az, el = tod.pointing.det_azel(device=tod.device)
    offs = phi_theta_to_offsets(torch.stack([az, el], dim=-1), *np.radians(mapper_map.center))
    res = np.radians(mapper_map.resolution)
    x0 = y0 = -(N_MAP - 1) / 2 * res
    return pixel_ids(offs[..., 0], offs[..., 1], x0, y0, res, N_MAP, N_MAP).contiguous()


def check_noise_psd(sim, tod_pw):
    """Mean periodogram of the pW noise field in bins above twice the
    knee against the expected PSD of the process."""
    import torch

    from maria_torch.atmosphere.fourier import good_fft_size
    from maria_torch.noise import _pink_weights_np

    program = sim.program()
    band = program.bands[0]
    fs = program.sample_rate
    x = tod_pw.data["noise"].double()
    n = x.shape[-1]
    X = torch.fft.rfft(x - x.mean(dim=-1, keepdim=True), dim=-1)
    measured = (X.abs() ** 2).mean(dim=0).cpu().numpy() / n
    f = np.fft.rfftfreq(n, d=1 / fs)
    w2 = _pink_weights_np(good_fft_size(n), fs, band.knee, 1.0) ** 2
    f_fft = np.fft.rfftfreq(good_fft_size(n), d=1 / fs)
    w2 = np.interp(f, f_fft, w2)
    cp = band.corr_prop
    b2 = float(np.mean(np.sum(np.asarray(band.noise_basis) ** 2, axis=-1))) if cp else 0.0
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


def run_slice(label, duration, device):
    import torch

    from maria_torch.ops.bin_map import bin_map
    from maria_torch.ops.pink_noise import pink_noise

    s = time.perf_counter()
    sim = make_sim(duration, device)
    sim.program()
    print(f"slice ({label}) {duration:.0f} s: scene setup {time.perf_counter() - s:.2f} s", flush=True)

    pink_noise.launches = 0
    bin_map.launches = 0
    s = time.perf_counter()
    tod = sim.run()[0]
    torch.cuda.synchronize()
    run_s = time.perf_counter() - s
    s = time.perf_counter()
    out_map = map_tod(tod)
    torch.cuda.synchronize()
    map_s = time.perf_counter() - s
    launches = {"pink_noise": pink_noise.launches, "bin_map": bin_map.launches}
    print(f"slice ({label}): first run() {run_s:.3f} s, first BinMapper.run() {map_s:.3f} s, "
          f"main-path launches {launches}", flush=True)

    n_det, n_t = 217, int(round(duration * 50.0))
    ok = tod.shape == (n_det, n_t) and tod.units == "K_RJ" and tod.device.type == "cuda"
    ok &= all(bool(torch.isfinite(v).all()) for v in tod.data.values())
    ok &= set(tod.fields) == {"atmosphere", "noise"}
    ok &= tuple(out_map.data.shape) == (1, 1, 1, N_MAP, N_MAP)
    ok &= bool(torch.isfinite(out_map.data).all()) and float(out_map.weight[..., N_MAP // 2, N_MAP // 2].min()) > 0
    ok &= launches["pink_noise"] > 0 and launches["bin_map"] > 0
    print(f"slice ({label}): TOD {tod.shape} {tod.fields} in {tod.units}, atmosphere mean "
          f"{float(tod.data['atmosphere'].mean()):.3f} K_RJ, noise std {float(tod.data['noise'].std()):.3e} K_RJ, "
          f"map {tuple(out_map.data.shape)} centre weight {float(out_map.weight[..., N_MAP // 2, N_MAP // 2].min()):.0f} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"slice ({label}) output check")

    s = time.perf_counter()
    tod = sim.run()[0]
    torch.cuda.synchronize()
    warm_run = time.perf_counter() - s
    s = time.perf_counter()
    map_tod(tod)
    torch.cuda.synchronize()
    warm_map = time.perf_counter() - s
    print(f"slice ({label}): warm run() {warm_run * 1e3:.2f} ms, warm BinMapper.run() {warm_map * 1e3:.2f} ms "
          f"({n_det * n_t} samples)", flush=True)

    if not check_noise_psd(sim, sim.run(units="pW")[0]):
        fail(f"slice ({label}) noise PSD")
    return tod, out_map, launches


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
    from maria_torch.ops import kernels

    card = card_line()
    device = torch.device("cuda")
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    maria_torch.set_cache_dir(os.path.join(HERE, "build", "maria_torch", "cache"))

    built = kernels.build()
    print(f"build: {built['seconds']:.2f} s -> {os.path.relpath(built['path'], HERE)}", flush=True)
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}", flush=True)
    kernels.load()

    gen = torch.Generator(device=device)
    gen.manual_seed(1234)
    k1 = {}
    for n_det, n, n_fft in ((217, 3000, 3072), (217, 30000, 32768), (5, 500, 512)):
        k1[(n, n_fft)] = check_pink_noise(device, gen, n_det, n, n_fft)

    results = {}
    for label, duration in SLICES.items():
        results[label] = run_slice(label, duration, device)

    k2 = {}
    for label, (tod, out_map, _) in results.items():
        k2[label] = check_bin_map(device, gen, slice_pixel_ids(tod, out_map), f"slice {label} ids")
    ids = torch.randint(-1, N_MAP * N_MAP, (217, 3000), generator=gen, device=device, dtype=torch.int32)
    k2["random"] = check_bin_map(device, gen, ids, "random ids with -1")

    launches_b = results["b"][2]
    kernels_line = {"kernels": [
        {"name": "pink_noise", "route": "cuda", "source": "maria_torch/csrc/pink_noise.cu",
         "replaces": "maria_tpu/ops/pallas_noise.py:269", "launches": launches_b["pink_noise"],
         **k1[(30000, 32768)]},
        {"name": "bin_map", "route": "cuda", "source": "maria_torch/csrc/bin_map.cu",
         "replaces": "maria_tpu/ops/pallas_binning.py:119", "launches": launches_b["bin_map"],
         **k2["b"]},
    ]}
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
