"""Smoke test of the maria_torch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. card: a CUDA device is required; prints its name and power limit;
2. build: compiles the hand-written kernels (maria_torch/csrc) with nvcc,
   one process per source, and prints ptxas's register and spill lines;
3. K1 pink_noise against its plain torch version (irfft) at the slices'
   shapes (one pass at n_fft 3072, also at slice (s)'s 5,556 rows; two
   passes at 32768 and 65536), a 1-hour scan at 50 Hz (n_fft 196608, odd
   part 3, two passes) and a small one-pass case, |diff| <= 2e-4 x std;
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
   float64; and at slice (h)'s ra/dec ids on its 512 x 512 map and slice
   (r)'s on its 417 x 417 maps;
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
   1e-5 of its maximum;
20. slice (n), the documented map-making flow (docs/usage.md:94-107) on a
   TOD of slice (h)'s scene, on a 417 x 417 ra/dec grid (0.25 deg at
   6e-4 deg) with the overflow buckets: BinMapper(tod_preprocessing=
   {"remove_slope": True}), MaximumLikelihoodMapper(n_epochs=2,
   n_cg_iters=50) fits at k=3 and k=0 and by gradient descent: finite
   maps of that shape with weight at the centre, K2 launched by each fit
   as often as ``ml_launches`` reckons, the blocks on the card; the ML
   P^T through K2 against its plain version at the ML ids (1e-5 of the
   float64 plain sums' maximum); the k=3 fit through K2 against the
   same fit with the plain P^T, of the TOD processed by the tutorial's
   chain (2e-3 of the map's maximum; on the unprocessed TOD, whose
   ~400 K_RJ of atmosphere leave the float32 solve ill-conditioned,
   printed beside the plain fit against itself summed in float64, not
   held); decompose's
   modes, by torch.linalg.svd and by the Gram matrix's eigh, against a
   float64 SVD (1e-5); the tutorial's processing chain
   (docs/tutorials.md:59-60) on the card against the CPU (1e-5 of the
   input's maximum); times: the fit, an epoch, a CG step by part, the
   noise-model update with and without decompose, K2 a P^T beside
   index_add_ and its bound, BinMapper with preprocessing, each
   processing op, the device's busy share over one fit;
21. slice (o), tests/test_ml_mapper.py's recovery at 600 s on slice (i)'s
   scene and big_cluster's 512 x 512 grid: with noise off the ML map
   (n_epochs=2, n_cg_iters=40) correlates above 0.9 with the
   beam-smoothed input over the better-covered half of the hit pixels,
   gradient descent above 0.8, and t_bins=2 gives two different weight
   maps, each frame above 0.8; with noise on and a common mode the k=2 ML
   map's residual rms lies below BinMapper's;
22. slice (p), the CMB patch of docs/tutorials.md:129-157 as written:
   act/pa5/f090 and f150 at NET_RJ 10 uK_RJ√s (the setter) and a 10 s
   knee on a polarized sunflower/circle array (0.7 deg, 1.5 beams, 10 m:
   1,052 detectors), a 600 s, 20 Hz back-and-forth at cerro_toco,
   Simulation(cmb="generate", nside 1024) with noise, run() -> the IQU
   MaximumLikelihoodMapper at 2 arcmin in ra/dec after remove_spline
   (60 s knots, elevation gradient to order 3) -> fit(epochs=2,
   steps_per_epoch=25): finite fields and IQU maps of both bands, K1
   launched by run(), K2 twice building the mapper and 2 x 28 times in
   fit(); K2 as the three-channel IQU P^T against its float64 plain sums
   (1e-5 of their maximum), timed beside index_add_ and its byte bound;
   the fit through K2 against the same fit with the plain P^T (2e-3 of
   the map's maximum); both bands' noise PSD within 10% of the process
   of their NEP; the scene without noise on the card against the CPU,
   one CMB (the card's) and one gains draw handed to both and the card's
   ra/dec and HEALPix pixels to the CPU (1e-5 of the TOD's maximum; on
   the CPU's own float32 pointing the share of samples that took a
   neighbouring pixel is printed); with noise off, the gains' draw
   zeros and each band's monopole off, the IQU fit without processing
   correlating with the CMB's T, Q and U at the hit pixel centres above
   0.95 (I) and 0.8 (Q, U), with more CG steps if 25 fall short
   (printed); the pure-Q source
   of tests/test_ml_mapper.py:82-124 on the card (Q correlation above
   0.7, Q's std over twice I's rms); setup seconds by part, warm run(),
   processing and fit ms, a CG step by part, the device's busy share;
23. slice (q), the ACT camera: get_instrument("ACT") (pa4, pa5, pa6:
   9,000 polarized detectors, six bands) at the ACT site on the registry
   plan back_and_forth_10deg_45el for 600 s (1.08e8 samples) with the
   2-D atmosphere, a CMB at nside 1024 and noise -> BinMapper(frame=
   "ra/dec", resolution=1/30), IQU by itself: finite fields and maps of
   six bands, K1 and K2 launched; K2 at a band's six IQU channels
   against its float64 plain sums (1e-5), timed beside index_add_ and
   its byte bound; every band's noise PSD within 10%; setup seconds by
   part, warm run() and map ms, peak device memory, the device's busy
   share;
24. slice (r), docs/usage.md:43-63 as written: MUSTANG-2 at the GBT on the
   Planner's 600 s ra/dec daisy over (150, 10) deg (its default 20 Hz: 217
   x 12,000), the 2-D atmosphere, cmb="generate" (nside 1024, KS1 in the
   setup), the cluster map, noise, the loose pwv=1.2 and seed 0, then
   run(units="K_RJ"): the loose pwv reaches the weather (zenith pwv 1.2
   mm within 1e-4), finite fields atmosphere, cmb, map and noise, K1
   launched by the run; Simulation.from_config(config) with the same
   keywords gives the same TOD to the bit (else within 1e-6 of its
   maximum, and the differing fields are printed); tod.to("uK_CMB") on
   the card within 1e-5 of the same conversion on the CPU of the same pW
   TOD, and the per-sample dP/dT_CMB factor within 1e-5 relative; BinMapper
   maps in uK_RJ, uK_CMB and Jy/pixel on docs/usage.md:94-107's 417 x 417
   grid, K2 once a map, the Jy/pixel map equal to the K_RJ map's
   .to("Jy/pixel") and the uK_RJ map to 1e6 x the K_RJ map within 1e-6 of
   the TOD's largest sample in that unit; Simulation(fused=False) of the
   same scene, each field's std within 0.5-2x of the fused run's; the noise
   PSD; warm times and peak memory;
25. slice (s), AtLAST-50k photon noise: slice (c)'s scene with every band's
   NEP_per_loading set to its NEP over the band's mean loading (so the
   loading term equals the NEP there) and the last band without a knee,
   through total_power_fn(): no matrix product, K3 never and K1 twice a
   band with a knee (its 5,556 rows at n_fft 3072 and its correlated
   modes); the total equal to the gained sum of the program's fields
   (1e-6 of its maximum); each band's noise (NEP + NEP_per_loading P) /
   NEP times that of the same program without the term on the same draws,
   within 1e-5 relative sample by sample; the knee-free band's noise in
   the program without the term of variance fs NEP^2 within 5% and a PSD
   flat within 10%; warm time and peak memory;
26. slice (t), AtLAST-50k x 600 s streamed (bench.py:844-880's scene:
   (c)'s scene at 600 s, 1.5e9 samples, uncut): StreamingExecutor(program,
   obs, block_tc=128).run(group_size=8): every sample in the map (hits
   summed in float64 equal to n_det x n_t), KC and K2 once a block, the
   block loop's peak above what init_state holds under 16 (n_det, B)
   float32 buffers; setup seconds, the warm run (mean of 3), samples/s,
   the coarse stage's and the loop's peaks, and the stage split (coarse,
   upsample, noise, binning); at 60 s with noise off the concatenated
   tod_blocks equal to total_power_fn() on the same draws (1e-6 of its
   maximum), with noise on the streamed Welch PSD of every band equal to
   the Welch PSD of the concatenated blocks (1e-3 relative); KC against
   its plain version (the Toeplitz form) at the block, every band's
   detector and mode rows in one launch: both held against a float64
   recurrence on 256 rows over 47 consecutive blocks, KC under 1e-4 of
   the pink part's std or twice the Toeplitz form's error; timed beside
   the Toeplitz GEMM alone, the byte bound, the split's latency bound
   (ops.pink_cascade.lane_fmas issued one a cycle) and the earlier
   one-thread-a-row kernel's recorded time, with the split (G lanes a row,
   S samples a lane) the launch took, and from a CUDA graph; K2 at a
   block's ids;
27. slice (u), tools/streaming_memory_demo.py's scene (MUSTANG-2, GBT,
   daisy_5arcmin_60s at 50 Hz, 2-D atmosphere, noise, block_tc 64,
   group_size 16) at 600 s and 3,600 s: warm times, whole and loop peaks,
   the loop's peak at 3,600 s within 1.15x of 600 s; a run broken off
   after two checkpoints and resumed equal to the uninterrupted one (hits
   exactly, sums within 1e-6 of their maximum), a wrong seed or geometry
   refused; (g)'s 3-D AR process in four chunks of 128 rows through
   StreamingExtrusion equal to one long extrusion on the same
   innovations bit for bit (else within 1e-6 of a screen's std), the AR
   kernel at the chunk against its plain loop; KC at the block; block 1
   with a fresh executor and no cached split tables inside
   torch.inference_mode (KC launched, its split's tables keyed by value)
   equal to the block outside bit for bit;
28. slice (v), the streamed ML mapper on tests/test_streaming_ml.py's
   scene at 600 s (MUSTANG-2 at 20 Hz, an az/el blob, 48 x 48 over 0.2
   deg), fit(n_epochs=2, n_cg_iters=25): recovery above 0.8 and no worse
   than the naive map's less 0.02, the fit through K2 against the same
   fit with the plain P^T within 2e-3 of the map's maximum, K2 as P^T at
   a block against its float64 plain sums; the fit's warm time, a CG
   step, K2's launches; at 60 s the batch MaximumLikelihoodMapper on the
   same TOD, the weighted RMS of the two maps' difference recorded; KC at
   the block as at (t) and (u);
29. slice (w), docs/tutorials.md:94-127's transfer functions as written
   (the Planner given a start time): the cluster2 product made by
   io.fetch in a private cache, map.load at 150 and 270 GHz 20 arcmin
   wide, map.concatenate along nu; TolTEC's array-1 and array-3 (5,184
   detectors, toltec/f150 and f270) from get_instrument_config and
   Instrument.from_config; the Planner at llano_de_chajnantor above 60
   deg, a 360 s daisy of 6.5 arcmin (miss_factor 0.3) at its 20 Hz;
   Simulation(map=maps, atmosphere="2d").run() -> BinMapper(units=
   "uK_RJ", stokes="I", resolution=maps.resolution, one mode and a 60 s
   spline with the elevation gradient removed).run() ->
   transfer_function(window=True) and the tutorial's three windows ->
   to_fits read back by map.load: finite fields atmosphere, map and noise
   of 5,184 x 7,200, K1 launched by run() and K2 by the map, the map read
   back equal element for element; the output map on the card: the
   input's sampled_onto its grid within 1e-5 of the map's maximum of a
   float64 gather at the card's own offsets, and every curve of the
   tutorial's transfer functions equal to maria_tpu's estimator in
   float64 numpy on the host on the same two maps (the same bins, 1e-6
   relative in every bin); the curves between the beams and the map's
   width printed beside the same flow without atmosphere and noise (not
   held); K1 and K2 at its band's shape; warm run(), BinMapper and
   transfer_function ms and peak memory;
30. slice (x), slice (a)'s TOD (217 x 3,000 at 50 Hz) through
   tod.to_fits(format="MUSTANG-2") and maria_torch.tod.load: the FNU
   column read back equal to the K_RJ signal bit for bit, DX/DY within
   2e-6 rad of the port's det_radec in float32; BinMapper(frame="ra/dec")
   on the reloaded TOD (K2 launched): total hits equal to the in-memory
   TOD's map's and to n_det x n_t, the summed signal within 1e-5 of it
   (the maps' correlation printed: the reader rebuilds the offsets from
   the first sample, so pixels may move); the write and read seconds;
31. phase (y), the (det, time) mesh (maria_torch.parallel) over a gloo
   world of two ranks started by torch.multiprocessing (spawn) that share
   the one card (NCCL refuses two ranks on one device), each holding only
   its rows, held against this process's one-process runs: (y1) slice
   (c)'s AtLAST-50k x 60 s, each rank its 25,002 detectors through
   process_detector_range and host_local_shard, total_power_fn(rows=)
   with K3 at its row0, K2 on its rows and one all_reduce (hits exact,
   sums within 1e-5 of the float64 sums' maximum, each rank's TOD rows
   within 1e-5 of the rows' std; peak memory and warm time a rank beside
   the one-process run's); (y2) slice (a)'s TOD through BinMapper.run(mesh)
   (within atol 1e-5 of the map's maximum and rtol 1e-4), and over a
   one-rank NCCL world in this process (the same tolerance, its
   bit-equality printed: K2's atomics order a pixel's adds anyhow); (y3)
   slice (n)'s TOD
   after the tutorial's chain, the k=3 ML fit with mesh= (1e-3 of the
   map's maximum); (y4) slice (u)'s MUSTANG-2 600 s streamed with
   run(mesh=) (hits exact and equal to n_real_det x n_t, sums within rtol
   1e-5 and atol 1e-3); (y5) slice (g)'s AR process through
   extrude_time_sharded (bit for bit against StreamingExtrusion's chunks
   on the same innovations); (y6) slice (a)'s MUSTANG-2 program, each
   rank its rows of every field through fields(rows=), the noise by K1 on
   those rows (the noise within 2e-4 of the rows' std, K1's gate, the
   other fields within 1e-5, K1 launched as often as in one process);
   K1 at (y6)'s row count and K3 at row0 25,002 against their plain
   versions, K3 also against the rows of a row0 = 0 launch; the times of all_reduce and
   send/recv (gloo on one card, staged through the host: not NCCL across
   cards) and each phase's warm time a rank beside the one-process run's.
   A rank that fails, or a world that outlives its join timeout, fails the
   run.

A line says that HDF5 files and plotting are not driven on the card
(the CPU tests hold them), with whether h5py and matplotlib are found.

Every kernel is timed (CUDA events, in turns) beside its plain version,
the PyTorch library call that computes the same function where there is
one (K1 torch.fft.irfft; K2 torch.bincount or index_add_ on ids filtered
beforehand; KC the Toeplitz GEMM w @ LGT; K3, the AR kernel, KS1 and KS2 none), and its bound: the larger of its
bytes at 3.35 TB/s and its operations at their peak rate (K3: the least
loop body that meets its contract, K3_LEAST_BODY, for every bin pair at
the card's issue and pipe rates; the AR kernel: the latency of its chain
of dependent steps, ``ar_bound``, from an FMA latency and a one-warp
block's barrier probed on the card in the same run; the barrier a step of
the kernel really pays, of its block or its cluster, is probed and printed
beside them and enters no bound).

The line before the last is the card as nvidia-smi reports it, the one
before that the kernels' JSON record (K1's launches counted over slices
(b), (r), (s) and (w), K2's over (b), (p), (q), (r), (t), (v), (w), (x)
and (y), K3's over (c) and (y), the AR kernel's over (f), (u)'s chunks
and (y), KC's over (t) and (y); a phase (y) launch counts in its rank's
process, and both ranks' counts are summed); the last line is the JSON
result.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
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


def graph_ms(fn, reps: int = 20) -> float:
    """The device's ms a call: ``reps`` calls captured in one CUDA graph
    and replayed between CUDA events, so no host time sits between the
    launches (back-to-back calls of a short kernel time the host)."""
    import torch

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


def check_shared_v(device, gen, n_det, m1, c=None, n_extra=0, row0=0):
    """K3 against its plain version. With ``n_extra``, it writes V into a
    (1, n_det, 2 m1 + n_extra) buffer, as the noise matrix product's left
    operand, whose last ``n_extra`` columns must keep their sentinel. With
    ``row0`` (a rank's first detector), it draws rows row0 .. row0 + n_det
    - 1, which must also equal those rows of a row0 = 0 launch bit for
    bit. Its bound: the bytes of V written, or K3's least loop body for
    every bin pair at the card's issue and pipe rates. No library call
    draws these bits."""
    import torch

    from maria_torch.noise import band_half_spectrum
    from maria_torch.ops.shared_v import draw_key, shared_v, shared_v_plain

    if c is None:
        c = band_half_spectrum(50.0, 0.5, 1.0, 2 * (m1 - 1), corr_prop=0.5)
    name = (f"K3 shared_v ({n_det}, m+1 {m1}{f', row stride {2 * m1 + n_extra}' if n_extra else ''}"
            f"{f', row0 {row0}' if row0 else ''})")
    key = draw_key(gen, device)
    sentinel = -12288.0
    buf = torch.full((1, n_det, 2 * m1 + n_extra), sentinel, dtype=torch.bfloat16, device=device)
    V = shared_v(key, c, n_det, out=buf, row0=row0)[0].float()
    ref = shared_v_plain(key, c, n_det, row0=row0)[0].float()
    torch.cuda.synchronize()
    rows_equal = True
    if row0:
        rows_equal = bool(torch.equal(shared_v(key, c, row0 + n_det)[0, row0:].float(), V))
    diff = (V - ref).abs()
    err = float(diff.max())
    within = bool((diff <= bf16_ulp(torch.maximum(V.abs(), ref.abs()))).all())
    exact = float((V == ref).float().mean())
    untouched = bool((buf[0, :, 2 * m1:] == sentinel).all())
    ok = V.shape == (n_det, 2 * m1) and bool(torch.isfinite(V).all()) and within and untouched and rows_equal
    line = (f"{name}: max|diff| {err:.3e}, all within one bf16 ulp {within}, "
            f"exact-equal share {exact:.6f}, other columns untouched {untouched}"
            f"{f', equal to rows {row0}.. of a row0 = 0 launch bit for bit {rows_equal}' if row0 else ''}")
    if n_det >= 1000:
        x = V.double() / torch.as_tensor(np.concatenate([c, c]), device=device)
        mean_z = float((x.mean(dim=0).abs() * np.sqrt(n_det)).max())
        var_z = float(((x.var(dim=0) - 1).abs() / np.sqrt(2 / n_det)).max())
        ok &= mean_z <= 5 and var_z <= 5
        line += f"; V/c columns: max |mean| {mean_z:.2f} sigma, max |var - 1| {var_z:.2f} sigma (limit 5)"
    print(f"{line} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    ms, plain_ms, _ = paired_ms(lambda: shared_v_plain(key, c, n_det, out=buf, row0=row0),
                                lambda: shared_v(key, c, n_det, out=buf, row0=row0))
    r = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None, "shape": [n_det, 2 * m1],
         "exact_share": exact,
         **bound(2 * n_det * 2 * m1 + 4 * m1, k3_least_cycles() * n_det * ((m1 + 1) // 2), LANE_INSTRUCTIONS_S)}
    print(timing_line(f"{name} (least body: {k3_least_cycles()} issue cycles a bin pair)", r), flush=True)
    return r


def ar_bound(processes, lat, steps=None) -> dict:
    """The AR kernel's bound: the larger of its bytes (operators, gather
    offsets and innovations read once, the buffer read and written once)
    at 3.35 TB/s and its latency: each process's chain of n_steps
    dependent steps, a step at least one block barrier plus one
    n_cross x (n_sample + n_cross) dot (B lower triangular), the dot no
    faster than its dependent depth (one FMA, then a tree of adds: 1 +
    ceil(log2(n_sample + n_cross)) dependent FMAs) nor than its FMAs at
    the card's float32 peak. ``lat`` holds a dependent FMA's latency and
    a barrier's in a block of one warp (PROBE_THREADS, whatever block the
    kernel launches), probed on the card in this run. ``steps`` gives each
    process's step count where a call runs others than its n_steps (a
    streamed chunk, on a buffer of steps + n_extrusion rows)."""
    n_bytes, latency_ms = 0, 0.0
    steps = [p.n_steps for p in processes] if steps is None else steps
    for p, n_steps in zip(processes, steps):
        n_c, n_s = p.n_cross_section, p.n_sample
        n_fma = n_c * n_s + n_c * (n_c + 1) // 2
        depth_ns = (1 + int(np.ceil(np.log2(n_s + n_c)))) * lat["fma_ns"]
        step_ns = lat["barrier_ns"] + max(depth_ns, 2 * n_fma / F32_OPS * 1e9)
        latency_ms = max(latency_ms, n_steps * step_ns * 1e-6)
        n_bytes += 4 * (n_fma + n_s + n_steps * n_c + 2 * (p.n_extrusion + n_steps) * n_c)
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


def map_tod(tod, mesh=None):
    import maria_torch

    center = np.degrees(tod.boresight.center())
    return maria_torch.BinMapper(
        tod, center=center, width=MAP_WIDTH_DEG, resolution=MAP_WIDTH_DEG / N_MAP, frame="az/el",
    ).run(mesh=mesh)


def slice_pixel_ids(tod, mapper_map, n_map=N_MAP):
    """The ids BinMapper bins the slice at, on an n_map x n_map grid over
    the mapper's width."""
    from maria_torch.mappers.bin_mapper import azel_pixel_ids

    res = mapper_map.x_res * N_MAP / n_map
    return azel_pixel_ids(tod.pointing, mapper_map.center, res, n_map, n_map, device=tod.device).contiguous()


def check_noise_psd(sim, tod_pw):
    """Per band, the mean periodogram of the pW noise field in bins from
    twice the knee (from fs / 8 where that is above fs / 4) to Nyquist
    against the expected PSD of the process of the band's NEP."""
    import torch

    from maria_torch.atmosphere.fourier import good_fft_size
    from maria_torch.noise import _pink_weights_np
    from maria_torch.ops.program import band_noise_basis

    dets = sim.instrument.dets
    fs = sim.obs_list[0].sample_rate
    ok = True
    for band in dets.bands:
        rows = np.where(dets.band_name == band.name)[0]
        basis, cp = band_noise_basis(dets.offsets[rows], sim.noise_kwargs)
        x = tod_pw.data["noise"][torch.as_tensor(rows, device=tod_pw.device)].double()
        n = x.shape[-1]
        X = torch.fft.rfft(x - x.mean(dim=-1, keepdim=True), dim=-1)
        measured = (X.abs() ** 2).mean(dim=0).cpu().numpy() / n
        f = np.fft.rfftfreq(n, d=1 / fs)
        w2 = _pink_weights_np(good_fft_size(n), fs, band.knee, 1.0) ** 2
        f_fft = np.fft.rfftfreq(good_fft_size(n), d=1 / fs)
        w2 = np.interp(f, f_fft, w2)
        b2 = float(np.mean(np.sum(np.asarray(basis) ** 2, axis=-1))) if cp else 0.0
        expected = (1e12 * band.NEP) ** 2 * (fs + (1 - cp) * w2 + cp * b2 * w2)
        edges = np.geomspace(2 * band.knee if 2 * band.knee <= fs / 4 else fs / 8, 0.98 * fs / 2, 7)
        ratios = []
        for lo, hi in zip(edges[:-1], edges[1:]):
            sel = (f >= lo) & (f < hi)
            ratios.append(float(measured[sel].mean() / expected[sel].mean()))
        band_ok = all(abs(r - 1) <= 0.10 for r in ratios)
        ok &= band_ok
        print(f"noise PSD / expected{'' if len(dets.bands) == 1 else f', {band.name} (NEP {band.NEP:.4e} W√s)'} in "
              f"bins {np.round(edges, 2).tolist()} Hz: {[round(r, 4) for r in ratios]} (limit 10%) "
              f"{'ok' if band_ok else 'FAIL'}", flush=True)
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


ML_KW = dict(center=(150.0, 10.0), width=0.25, resolution=6e-4, frame="ra/dec", units="K_RJ")  # docs/usage.md:94-107
ML_EPOCHS, ML_CG_ITERS, ML_K = 2, 50, 3
TUTORIAL_CHAIN = {"remove_spline": {"knot_spacing": 60, "remove_el_gradient": True},
                  "remove_modes": {"modes_to_remove": 1}}  # docs/tutorials.md:59-60


def ml_launches(n_blocks, method, n_epochs, n_steps) -> int:
    """K2 launches of one fit: a P^T a block for the right-hand side and
    for the white-noise diagonal and one for each of the CG's n_steps + 1
    operator calls an epoch; steepest descent: one for the right-hand side
    and two a step an epoch, and the weights' diagonal once at the end."""
    if method == "conjugate_gradient":
        return n_blocks * n_epochs * (n_steps + 3)
    return n_blocks * (n_epochs * (1 + 2 * n_steps) + 1)


def bin_map_float64(channels, pixel_ids, n_pix: int, count: bool = False):
    """K2's plain version summed in float64, rounded to float32 once."""
    import torch

    out = torch.zeros((channels.shape[0], n_pix), dtype=torch.float64, device=channels.device)
    out.index_add_(1, pixel_ids.reshape(-1).long(), channels.reshape(channels.shape[0], -1).double())
    return out.float()


@contextlib.contextmanager
def plain_pt(plain=None):
    """The ML mapper's P^T with ``plain`` (K2's plain version by default)
    in K2's place."""
    import maria_torch.mappers.ml_mapper as ml
    from maria_torch.ops.bin_map import bin_map_plain

    own, ml.bin_map = ml.bin_map, plain or bin_map_plain
    try:
        yield
    finally:
        ml.bin_map = own


def warm_ms(fn, reps: int = WARM_REPS) -> tuple:
    """(mean ms, list of ms) of ``reps`` host-timed calls, each ended by a synchronize."""
    import torch

    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - start) * 1e3)
    return float(np.mean(ms)), [round(x, 2) for x in ms]


def check_ml_pt(mapper, gen, card, label="n") -> dict:
    """P^T through K2 against K2's plain version on the card at the ML
    ids, for a random vector: the n_s Stokes-weighted rows' sums within
    1e-5 of the maximum of the plain sums taken in float64; timed beside
    index_add_ on the same ids (all in range: the overflow buckets are real
    ids) and its byte bound."""
    import torch

    from maria_torch.ops.bin_map import bin_map, bin_map_plain, bin_plan

    block = mapper.blocks[0]
    ids = block["pix"]
    v = torch.randn(ids.shape, generator=gen, device=ids.device)
    channels = (block["sw"].T[:, :, None] * v[None]).contiguous()
    n_s = channels.shape[0]
    out = mapper._project_T(v, block).view(n_s, -1)
    exact = torch.stack([plain_sums64(channels[s], ids, mapper.n_cpix) for s in range(n_s)])
    plain = bin_map_plain(channels, ids, mapper.n_cpix)
    torch.cuda.synchronize()
    scale = float(exact.abs().max())
    err, plain_err = float((out - exact).abs().max()), float((plain - exact).abs().max())
    ok = err <= 1e-5 * scale
    plan = bin_plan(mapper.n_cpix, n_s, ids.numel())
    print(f"slice ({label}): the ML P^T through K2 ({plan['form']} form, {plan['blocks']} blocks of {plan['span']} "
          f"samples) against the float64 plain sums, {n_s} Stokes channel(s) at the ML ids {tuple(ids.shape)} into "
          f"{mapper.n_cpix} pixels (overflow buckets included): max|diff| {err:.3e} = {err / scale:.2e} of max (limit "
          f"1e-5; float32 plain {plain_err / scale:.2e}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"slice ({label}): K2 as the ML P^T disagrees with its plain version")
    flat_ids, flat = ids.reshape(-1).long(), channels.reshape(n_s, -1)

    def by_index_add():
        return torch.zeros((n_s, mapper.n_cpix), device=ids.device).index_add_(1, flat_ids, flat)

    ms, plain_ms, library_ms = paired_ms(lambda: bin_map_plain(channels, ids, mapper.n_cpix),
                                         lambda: bin_map(channels, ids, mapper.n_cpix), by_index_add)
    r = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
         "shape": [n_s, *ids.shape, mapper.n_cpix],
         # the ids and the Stokes-weighted rows read once, the maps written once; an add a sample and row
         **bound(4 * ids.numel() * (1 + n_s) + 4 * n_s * mapper.n_cpix, n_s * ids.numel())}
    print(timing_line(f"K2 as the ML P^T (slice {label}, {n_s} channel(s); library call index_add_; {card})", r),
          flush=True)
    return r


def ml_step_times(mapper) -> dict:
    """ms of one CG step on the card by CUDA events (means of 20 calls):
    P, N^-1 as rfft, the weight A^-1, the Woodbury term and irfft, P^T
    (K2), and the vector updates (a step whose operator hands back a
    stored A p); and the whole step."""
    import torch

    from maria_torch.mappers.ml_mapper import cg_step

    block = mapper.blocks[0]
    v, n = block["data"], block["data"].shape[-1]
    m = mapper.naive_map
    fv = torch.fft.rfft(v, dim=-1)
    x = fv * block["A_inv"]
    diag = mapper._white_diag()
    inv_diag = torch.where(diag > 0, 1.0 / torch.clamp(diag, min=1e-30), 1.0)
    r = mapper._rhs() - mapper._apply_PNP(m)
    z = r * inv_diag
    state = (m, r, torch.dot(r, z), z)
    atol2 = 1e-16 * torch.dot(r, r)
    Ap = mapper._apply_PNP(z)
    times = {
        "P": cuda_ms(lambda: mapper._project(m, block)),
        "rfft": cuda_ms(lambda: torch.fft.rfft(v, dim=-1)),
        "weight": cuda_ms(lambda: fv * block["A_inv"]),
        "Woodbury": cuda_ms(lambda: mapper._woodbury(block, x)),
        "irfft": cuda_ms(lambda: torch.fft.irfft(x, n=n, dim=-1)),
        "P^T (K2)": cuda_ms(lambda: mapper._project_T(v, block)),
        "vector updates": cuda_ms(lambda: cg_step(lambda p: Ap, state, inv_diag, atol2)),
        "step": cuda_ms(lambda: cg_step(mapper._apply_PNP, state, inv_diag, atol2)),
    }
    return times


def check_decompose(mapper, card):
    """The top-k modes of the windowed residuals two ways on the card:
    torch.linalg.svd of the (n_det, n_t) float32 residuals, and the
    eigenvectors of their float64 Gram matrix (``decompose``, the one the
    port keeps); U @ modes against a float64 SVD on the host, where the
    kept one must lie within 1e-5 of its maximum, and both timed."""
    import torch

    from maria_torch.mappers.ml_mapper import _tukey
    from maria_torch.utils.signal import decompose

    block = mapper.blocks[0]
    resid = block["data"] - mapper._project(mapper.naive_map, block)
    resid = resid - resid.mean(dim=-1, keepdim=True)
    wd = (resid * _tukey(resid.shape[-1], resid.device)).contiguous()
    k = ML_K

    def by_svd():
        u, s, vh = torch.linalg.svd(wd, full_matrices=False)
        return u[:, :k] * s[:k], vh[:k]

    u, s, vh = np.linalg.svd(wd.double().cpu().numpy(), full_matrices=False)
    exact = (u[:, :k] * s[:k]) @ vh[:k]
    scale = float(np.abs(exact).max())
    errs = {}
    for name, fn in (("svd", by_svd), ("gram eigh", lambda: decompose(wd, k=k))):
        a, b = fn()
        errs[name] = float(np.abs((a @ b).double().cpu().numpy() - exact).max()) / scale
    svd_ms, gram_ms = cuda_ms(by_svd, reps=5), cuda_ms(lambda: decompose(wd, k=k), reps=5)
    ok = errs["gram eigh"] <= 1e-5
    print(f"slice (n): decompose of the windowed residuals {tuple(wd.shape)}, k = {k}, on the card: U @ modes against "
          f"a float64 host SVD, the float64 Gram matrix's eigh (decompose, kept) {errs['gram eigh']:.2e} of max in "
          f"{gram_ms:.3f} ms (limit 1e-5) {'ok' if ok else 'FAIL'}; torch.linalg.svd in float32 {errs['svd']:.2e} "
          f"({'within' if errs['svd'] <= 1e-5 else 'outside'} the limit) in {svd_ms:.3f} ms ({card})", flush=True)
    if not ok:
        fail("slice (n): decompose does not meet its contract")


def run_ml_slice(device, card, sim, gen):
    """Slice (n): the documented map-making flow (docs/usage.md:94-107) on
    a TOD of slice (h)'s scene: BinMapper with preprocessing, the ML
    mapper's fits, the tutorial's processing chain on the card against the
    CPU, with their gates and times."""
    import torch

    import maria_torch
    from maria_torch.mappers.ml_mapper import MaximumLikelihoodMapper
    from maria_torch.ops.bin_map import bin_map
    from maria_torch.ops.pink_noise import pink_noise
    from maria_torch.profile_slice import profiled
    from maria_torch.tod import TOD

    tod = sim.run()[0]
    n_det, n_t = tod.shape
    n = int(np.ceil(ML_KW["width"] / ML_KW["resolution"]))

    def check_map(label, out, launches, expected):
        ok = tuple(out.data.shape) == (1, 1, 1, n, n) and bool(torch.isfinite(out.data).all())
        ok &= float(out.weight[0, 0, 0, n // 2, n // 2]) > 0 and launches == expected
        print(f"slice (n): {label}: map {tuple(out.data.shape)}, max |map| {float(out.data.abs().max()):.3e} K_RJ, "
              f"centre weight {float(out.weight[0, 0, 0, n // 2, n // 2]):.3e}, K2 launches {launches} (expected "
              f"{expected}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"slice (n): {label}")

    pink_noise.launches = bin_map.launches = 0
    binned = maria_torch.BinMapper(tod, tod_preprocessing={"remove_slope": True}, **ML_KW).run()
    torch.cuda.synchronize()
    check_map("BinMapper(tod_preprocessing={'remove_slope': True})", binned, bin_map.launches, 1)

    fits = {}
    for label, k, method in (("k=3 CG", ML_K, "conjugate_gradient"), ("k=0 CG", 0, "conjugate_gradient"),
                             ("k=0 gradient descent", 0, "gradient_descent")):
        pink_noise.launches = bin_map.launches = 0
        mapper = MaximumLikelihoodMapper(tod, n_epochs=ML_EPOCHS, n_cg_iters=ML_CG_ITERS, k=k, **ML_KW)
        built = bin_map.launches
        out = mapper.fit(method=method)
        torch.cuda.synchronize()
        expected = ml_launches(1, method, ML_EPOCHS, ML_CG_ITERS)
        on_card = all(mapper.blocks[0][key].device.type == "cuda" for key in ("pix", "sw", "data"))
        print(f"slice (n): {label}: K2 launches {built} building the mapper (hits and the naive map), {bin_map.launches - built} "
              f"in fit(): {ML_EPOCHS} epochs x ({'1 right-hand side + 1 diagonal + ' + str(ML_CG_ITERS + 1) + ' CG operator calls' if method == 'conjugate_gradient' else '1 right-hand side + 2 x ' + str(ML_CG_ITERS) + ' steps'})"
              f"{'' if method == 'conjugate_gradient' else ' + 1 final diagonal'} = {expected}; ids, Stokes weights "
              f"and data on the card {on_card}", flush=True)
        if built != 2 or not on_card or pink_noise.launches:
            fail(f"slice (n): {label} blocks")
        check_map(f"MaximumLikelihoodMapper(n_epochs={ML_EPOCHS}, n_cg_iters={ML_CG_ITERS}, k={k}).fit"
                  f"(method='{method}')", out, bin_map.launches - built, expected)
        fits[label] = (mapper, out)

    mapper, out = fits["k=3 CG"]
    fit_kw = dict(n_epochs=ML_EPOCHS, n_cg_iters=ML_CG_ITERS, k=ML_K, **ML_KW)
    through = MaximumLikelihoodMapper(tod, tod_preprocessing=TUTORIAL_CHAIN, **fit_kw).fit()
    with plain_pt():
        plain = MaximumLikelihoodMapper(tod, tod_preprocessing=TUTORIAL_CHAIN, **fit_kw).fit()
        raw_plain = MaximumLikelihoodMapper(tod, **fit_kw).fit()
    with plain_pt(bin_map_float64):
        raw_plain64 = MaximumLikelihoodMapper(tod, **fit_kw).fit()
    scale = float(plain.data.abs().max())
    err = float((through.data - plain.data).abs().max())
    ok = err <= 2e-3 * scale
    raw_scale = float(raw_plain.data.abs().max())
    print(f"slice (n): the k=3 fit of the TOD processed by the tutorial's chain with K2 against the same fit with the "
          f"plain P^T on the card: max|diff| {err:.3e} = {err / scale:.2e} of the map's max (limit 2e-3) "
          f"{'ok' if ok else 'FAIL'}; on the unprocessed TOD (~400 K_RJ of atmosphere; float32-ill-conditioned, not "
          f"held): K2 against plain {float((out.data - raw_plain.data).abs().max()) / raw_scale:.2e}, plain against "
          f"plain summed in float64 {float((raw_plain64.data - raw_plain.data).abs().max()) / raw_scale:.2e} of the "
          f"map's max", flush=True)
    if not ok:
        fail("slice (n): the fit through K2 disagrees with the plain P^T's")
    pt = check_ml_pt(mapper, gen, card)
    check_decompose(mapper, card)

    cpu_tod = TOD(data={key: val.cpu() for key, val in tod.data.items()}, pointing=tod.pointing, weight=tod.weight.cpu(),
                  units=tod.units, dets=tod.dets, metadata=tod.metadata)
    on_card, on_cpu = tod.process(**TUTORIAL_CHAIN), cpu_tod.process(**TUTORIAL_CHAIN)
    input_scale = float(tod.signal.abs().max())
    err = float((on_card.signal.cpu() - on_cpu.signal).abs().max()) / input_scale
    ok = on_card.device.type == "cuda" and on_card.fields == ["signal"] and err <= 1e-5
    print(f"slice (n): tod.process({TUTORIAL_CHAIN}) on the card against the CPU: max|diff| {err:.2e} of the input's "
          f"max {input_scale:.1f} K_RJ (limit 1e-5, as tests/test_torch_processing.py holds chains with an SVD) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (n): the processed TOD on the card disagrees with the CPU")

    fit_ms, fit_list = warm_ms(lambda: mapper.fit())
    steps = ml_step_times(mapper)
    parts = sum(v for key, v in steps.items() if key != "step")
    print(f"slice (n): warm k=3 fit() {fit_ms:.2f} ms ({fit_list}), {fit_ms / ML_EPOCHS:.2f} ms an epoch of "
          f"{ML_CG_ITERS} CG steps; one CG step {steps['step']:.4f} ms by CUDA events: "
          + ", ".join(f"{key} {val:.4f}" for key, val in steps.items() if key != "step")
          + f" (sum {parts:.4f}) ms ({n_det} x {n_t} samples, {mapper.n_cpix} pixels; {card})", flush=True)
    with_ms, _ = warm_ms(lambda: mapper._update_noise_model(mapper.naive_map))
    k0 = fits["k=0 CG"][0]
    without_ms, _ = warm_ms(lambda: k0._update_noise_model(k0.naive_map))
    for m in (mapper, k0):
        del m.noise_model_history[-WARM_REPS:]
    gd_ms, _ = warm_ms(lambda: fits["k=0 gradient descent"][0].fit(method="gradient_descent"), reps=2)
    k0_ms, _ = warm_ms(lambda: k0.fit(), reps=2)
    bin_ms, bin_list = warm_ms(lambda: maria_torch.BinMapper(tod, tod_preprocessing={"remove_slope": True},
                                                             **ML_KW).run())
    print(f"slice (n): noise-model update {with_ms:.2f} ms with decompose (k=3), {without_ms:.2f} ms without (k=0); "
          f"warm k=0 CG fit() {k0_ms:.2f} ms, gradient-descent fit() {gd_ms:.2f} ms (means of 2); BinMapper(tod_"
          f"preprocessing={{'remove_slope': True}}).run() {bin_ms:.2f} ms ({bin_list}); means of {WARM_REPS} "
          f"unless stated; {card}", flush=True)
    ops = {"despike": {"despike": True}, "remove_slope": {"remove_slope": True},
           "remove_spline (60 s knots, el gradient)": {"remove_spline": TUTORIAL_CHAIN["remove_spline"]},
           "window (tukey)": {"window": {}}, "filter (fft, 0.1-5 Hz)": {"filter": {"f_lower": 0.1, "f_upper": 5.0}},
           "filter (bessel, 0.1 Hz)": {"filter": {"f_lower": 0.1, "method": "bessel"}},
           "remove_modes (1)": {"remove_modes": TUTORIAL_CHAIN["remove_modes"]},
           "the tutorial chain": TUTORIAL_CHAIN}
    op_ms = {label: warm_ms(lambda c=config: tod.process(**c))[0] for label, config in ops.items()}
    print("slice (n): TOD.process ops on the card, warm means of "
          f"{WARM_REPS}: " + ", ".join(f"{label} {ms:.2f} ms" for label, ms in op_ms.items()) + f" ({card})", flush=True)
    wall, busy, _ = profiled(lambda: mapper.fit())
    print(f"slice (n): one k=3 fit() under torch.profiler: {wall:.2f} ms wall, {busy:.2f} ms device kernel time, device "
          f"busy {busy / wall:.1%} of the window ({busy / fit_ms:.1%} of the warm fit's {fit_ms:.2f} ms without the "
          f"profiler; {card})", flush=True)
    return pt


def run_ml_recovery(device, card, clean_sim, noisy_sim):
    """Slice (o): tests/test_ml_mapper.py's recovery at full length on
    slice (i)'s scene and big_cluster's own 512 x 512 grid."""
    import torch

    import maria_torch
    from maria_torch.scenes import sky_mapper, sky_recovery, sky_residual_rms

    tod = clean_sim.run()[0]
    ML = maria_torch.MaximumLikelihoodMapper
    start = time.perf_counter()
    cg = sky_mapper([tod], clean_sim.map, mapper=ML, n_epochs=2, n_cg_iters=40).fit()
    gd = sky_mapper([tod], clean_sim.map, mapper=ML, n_epochs=1, n_cg_iters=40).fit(method="gradient_descent")
    bins = sky_mapper([tod], clean_sim.map, mapper=ML, n_epochs=1, n_cg_iters=30, t_bins=2).fit()
    torch.cuda.synchronize()
    corr = {"CG": sky_recovery(clean_sim, cg), "GD": sky_recovery(clean_sim, gd),
            "t bin 0": sky_recovery(clean_sim, bins, t=0), "t bin 1": sky_recovery(clean_sim, bins, t=1)}
    w = bins.weight[0, 0]
    different = bool((w[0] > 0).any() and (w[1] > 0).any()) and not bool(torch.equal(w[0] > 0, w[1] > 0))
    ok = corr["CG"] > 0.9 and corr["GD"] > 0.8 and corr["t bin 0"] > 0.8 and corr["t bin 1"] > 0.8 and different
    ok &= tuple(bins.data.shape) == (1, 1, 2, 512, 512) and not bool(torch.allclose(bins.data[0, 0, 0],
                                                                                      bins.data[0, 0, 1]))
    print(f"slice (o), noise off, {tod.shape} on 512 x 512: correlation with the beam-smoothed input over the "
          f"better-covered half of the hit pixels: " + ", ".join(f"{k} {v:.5f}" for k, v in corr.items())
          + f" (limits 0.9 CG, 0.8 GD and each time bin; the bins' weight maps differ {different}) "
          f"{'ok' if ok else 'FAIL'} ({time.perf_counter() - start:.2f} s)", flush=True)
    if not ok:
        fail("slice (o): the ML mapper does not recover the input map")

    noisy = noisy_sim.run()[0]
    common = 5e-3 * np.cumsum(np.random.default_rng(0).standard_normal(noisy.shape[-1]))
    data = dict(noisy.data)
    data["common"] = torch.as_tensor(np.broadcast_to(common, noisy.shape).astype(np.float32), device=device)
    corrupted = maria_torch.TOD(data=data, pointing=noisy.pointing, units=noisy.units, dets=noisy.dets,
                                metadata=noisy.metadata)
    binned = sky_mapper([corrupted], noisy_sim.map).run()
    ml = sky_mapper([corrupted], noisy_sim.map, mapper=ML, n_epochs=2, n_cg_iters=40, k=2).fit()
    rms_ml, rms_bin = sky_residual_rms(noisy_sim, ml), sky_residual_rms(noisy_sim, binned)
    ok = rms_ml < rms_bin
    print(f"slice (o), noise on with a common mode (5e-3 x cumsum of default_rng(0) normals): residual rms against the "
          f"beam-smoothed input, ML k=2 {rms_ml:.4e} K_RJ, BinMapper {rms_bin:.4e} K_RJ {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail("slice (o): the ML mapper does not beat binning on the common mode")


PATCH_EPOCHS, PATCH_STEPS = 2, 25  # docs/tutorials.md:150
PATCH_NSIDE = 1024
ACT_DURATION = 600.0


def patch_fit(mapper, steps=PATCH_STEPS):
    return mapper.fit(epochs=PATCH_EPOCHS, steps_per_epoch=steps)


def check_iqu_map(label, out, n_nu):
    import torch

    n_y, n_x = out.data.shape[-2:]
    ok = out.stokes == "IQU" and tuple(out.data.shape[:3]) == (3, n_nu, 1)
    ok &= bool(torch.isfinite(out.data).all()) and float(out.weight[:, :, 0, n_y // 2, n_x // 2].min()) > 0
    print(f"slice ({label}): IQU map {tuple(out.data.shape)} in {out.frame} at {np.degrees(out.resolution) * 60:.2f} "
          f"arcmin, max |I| {float(out.data[0].abs().max()):.3e}, max |Q| {float(out.data[1].abs().max()):.3e}, max |U| "
          f"{float(out.data[2].abs().max()):.3e} {out.units}, centre weights "
          f"{out.weight[:, :, 0, n_y // 2, n_x // 2].flatten().tolist()} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"slice ({label}) IQU map")


def run_cmb_patch(device, card, gen):
    """Slice (p): the CMB patch of docs/tutorials.md:129-157 as written,
    at full size: its instrument, plan and Simulation with a CMB at nside
    1024, run() -> TOD -> the IQU MaximumLikelihoodMapper after
    remove_spline, fit(epochs=2, steps_per_epoch=25); its gates (K2 as the
    IQU P^T, the fit against the plain P^T's, the card against the CPU,
    the noise PSD of both bands, the IQU recovery and the pure-Q source)
    and times. Returns (K2's record, main-path launches)."""
    import torch

    import maria_torch
    import maria_torch.sim.simulation as simulation_module
    from maria_torch import scenes
    from maria_torch.ops.bin_map import bin_map
    from maria_torch.ops.pink_noise import pink_noise
    from maria_torch.ops.sht import sht_anal, sht_synth
    from maria_torch.profile_slice import profiled

    def reset():
        pink_noise.launches = bin_map.launches = sht_synth.launches = sht_anal.launches = 0

    reset()
    s = time.perf_counter()
    instrument = scenes.cmb_patch_instrument()
    inst_s = time.perf_counter() - s
    s = time.perf_counter()
    plan = scenes.cmb_patch_plan()
    plan_s = time.perf_counter() - s
    s = time.perf_counter()
    with stage_times({"cmb": (simulation_module, "initialize_cmb")}) as cmb_s:
        sim = maria_torch.Simulation(instrument, plans=[plan], site="cerro_toco", cmb="generate",
                                     cmb_kwargs={"nside": PATCH_NSIDE}, seed=0, device=device)
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - s
    setup = {"sht_synth": sht_synth.launches}
    n_det, n_t = instrument.n_dets, plan.n
    print(f"slice (p) the CMB patch (docs/tutorials.md:129-157): {n_det} detectors ({[b.name for b in instrument.bands]}, "
          f"NEP {[f'{b.NEP:.4e}' for b in instrument.bands]} W√s from NET_RJ 10 uK_RJ√s) x {n_t} samples; host setup "
          f"{inst_s + plan_s + sim_s:.2f} s: instrument {inst_s:.2f} s, plan {plan_s:.2f} s, Simulation {sim_s:.2f} s of "
          f"which generate_cmb(nside={PATCH_NSIDE}) {cmb_s['cmb']:.2f} s (KS1 launches {setup['sht_synth']})", flush=True)

    reset()
    s = time.perf_counter()
    tod = sim.run()[0]
    torch.cuda.synchronize()
    run_s = time.perf_counter() - s
    k1_run = pink_noise.launches
    s = time.perf_counter()
    mapper = scenes.cmb_patch_mapper([tod])
    built = bin_map.launches
    out = patch_fit(mapper)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - s
    fit_launches = bin_map.launches - built
    expected = ml_launches(1, "conjugate_gradient", PATCH_EPOCHS, PATCH_STEPS)
    launches = {"pink_noise": k1_run, "bin_map": bin_map.launches, "sht_synth": setup["sht_synth"] + sht_synth.launches}
    print(f"slice (p): first run() {run_s:.3f} s, the mapper and its first fit {fit_s:.3f} s; main-path launches "
          f"{launches} (K2: {built} building the mapper, {fit_launches} in fit(), expected {expected})", flush=True)
    ok = tod.shape == (n_det, n_t) == (1052, 12000) and set(tod.fields) == {"cmb", "noise"}
    ok &= all(bool(torch.isfinite(v).all()) for v in tod.data.values()) and tod.device.type == "cuda"
    ok &= k1_run >= len(instrument.bands) and built == 2 and fit_launches == expected and setup["sht_synth"] == 3
    ok &= mapper.stokes == "IQU" and all(mapper.blocks[0][k].device.type == "cuda" for k in ("pix", "sw", "data"))
    print(f"slice (p): TOD {tod.shape} {tod.fields} in {tod.units}, max |cmb| {float(tod.data['cmb'].abs().max()):.3e}, "
          f"noise std {float(tod.data['noise'].std()):.3e} K_RJ; mapper {mapper.stokes} on {mapper.n_x} x "
          f"{mapper.n_y} pixels a band ({mapper.n_cpix} with the buckets) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (p) output check")
    check_iqu_map("p", out, 2)

    pt = check_ml_pt(mapper, gen, card, label="p")
    with plain_pt():
        plain = patch_fit(scenes.cmb_patch_mapper([tod]))
    scale = float(plain.data.abs().max())
    err = float((out.data - plain.data).abs().max())
    ok = err <= 2e-3 * scale
    print(f"slice (p): the IQU fit of the processed TOD through K2 against the same fit with the plain P^T on the card: "
          f"max|diff| {err:.3e} = {err / scale:.2e} of the map's max (limit 2e-3) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (p): the IQU fit through K2 disagrees with the plain P^T's")
    if not check_noise_psd(sim, sim.run(units="pW")[0]):
        fail("slice (p) noise PSD")

    # the scene without noise on the card against the CPU: one CMB (the
    # card's) and one gains draw handed to both. A sample within an ulp of
    # a pixel's edge may take the neighbouring pixel, so the CPU is run
    # twice: given the card's HEALPix pixels (held at 1e-5), and on its own
    # pointing, where at most 1e-4 of the samples may differ, each only
    # where the CPU's own pixel is a neighbour of the card's (centres
    # within 2 pixel sizes; a neighbour is within about 1.6), and at most
    # 1e-3 of the pixels may move (an ulp-wide band along the edges: ~1e-4)
    from maria_torch.healpix.core import pix2ang_ring
    from maria_torch.tod import Pointing

    gains = torch.randn(n_det, generator=torch.Generator().manual_seed(5))
    quiet = {}
    for where in (device, "cpu"):
        q = maria_torch.Simulation(instrument, plans=[plan], site="cerro_toco", cmb=sim.cmb, noise=False, seed=0,
                                   device=where)
        s = time.perf_counter()
        quiet[str(where)] = q.run(draws=[{"gains": gains.to(where)}])[0].signal.cpu()
        torch.cuda.synchronize()
        quiet[f"{where} s"] = time.perf_counter() - s
    obs, cmb, dets = q.obs_list[0], sim.cmb, instrument.dets
    pix = {where: torch.zeros((n_det, n_t), dtype=torch.int64) for where in ("card", "cpu")}
    for band in dets.bands:  # the order compute_cmb_loading takes the bands in
        rows = np.where(dets.band_name == band.name)[0]
        for where, on in (("card", device), ("cpu", "cpu")):
            pix[where][rows] = cmb.radec_pixels(*Pointing(obs.boresight, obs.offsets[rows], obs.q).det_radec(
                device=on)).cpu()
    order = iter(pix["card"][np.where(dets.band_name == band.name)[0]] for band in dets.bands)
    cmb.radec_pixels = lambda ra, dec: next(order)
    try:
        handed = q.run(draws=[{"gains": gains}])[0].signal
    finally:
        del cmb.radec_pixels
    ref, card_tod = quiet["cpu"], quiet[str(device)]
    scale = float(handed.abs().max())
    err = float((card_tod - handed).abs().max())
    beyond = (card_tod - ref).abs() > 1e-5 * scale
    moved = pix["card"] != pix["cpu"]
    centres = []  # unit vectors of the moved samples' pixel centres, the card's and the CPU's
    for w in ("card", "cpu"):
        theta, phi = pix2ang_ring(cmb.nside, pix[w][moved].numpy())
        centres.append(np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], -1))
    apart = np.arccos(np.clip((centres[0] * centres[1]).sum(-1), -1, 1))
    ok = err <= 1e-5 * scale
    own_ok = float(beyond.float().mean()) <= 1e-4 and float(moved.float().mean()) <= 1e-3
    own_ok &= not bool((beyond & ~moved).any()) and bool((apart <= 2 * cmb.resolution).all())
    print(f"slice (p), noise off: the TOD on the card against the CPU, one CMB and one gains draw; the CPU given the "
          f"card's HEALPix pixels: max|diff| {err:.3e} = {err / scale:.2e} of its max {scale:.4f} K_RJ (limit 1e-5) "
          f"{'ok' if ok else 'FAIL'}; the CPU on its own pointing: {float(beyond.float().mean()):.2e} of the samples "
          f"beyond 1e-5 (limit 1e-4), {float(moved.float().mean()):.2e} in another pixel than the card's (limit 1e-3), "
          f"each beyond only where its pixel moved {not bool((beyond & ~moved).any())}, the moved pixels' centres at "
          f"most {float(apart.max(initial=0.0)) / cmb.resolution:.2f} pixel sizes apart (limit 2: a neighbour), max "
          f"|diff| {float((card_tod - ref).abs().max()) / scale:.2e} of the max {'ok' if own_ok else 'FAIL'} (run() "
          f"{quiet[f'{device} s']:.2f} s on the card, {quiet['cpu s']:.2f} s on the CPU)", flush=True)
    if not ok:
        fail("slice (p): the card disagrees with the CPU")
    if not own_ok:
        fail("slice (p): the card's pixels disagree with the CPU's own pointing beyond a neighbouring pixel")
    del quiet, handed, ref, card_tod, beyond, moved, pix

    # recovery: noise off, no processing; the gains' draw zeros and each
    # band's monopole off leave the sky term
    q = maria_torch.Simulation(instrument, plans=[plan], site="cerro_toco", cmb=sim.cmb, noise=False, seed=0,
                               device=device)
    clean = scenes.without_band_means(q.run(draws=[{"gains": torch.zeros(n_det, device=device)}])[0])
    for steps in (PATCH_STEPS, 2 * PATCH_STEPS, 4 * PATCH_STEPS):
        rec = patch_fit(scenes.cmb_patch_mapper([clean], tod_preprocessing={}), steps=steps)
        corr = [scenes.stokes_recovery(sim.cmb, rec, nu_index=b) for b in range(2)]
        ok = all(c["I"] >= 0.95 and c["Q"] >= 0.8 and c["U"] >= 0.8 for c in corr)
        print(f"slice (p), noise off, no processing, {PATCH_EPOCHS} x {steps} CG steps: correlation of the IQU map with "
              f"the CMB's T, Q, U at the hit pixel centres, " + "; ".join(
                  f"{instrument.bands[b].name}: " + ", ".join(f"{k} {v:.5f}" for k, v in c.items())
                  for b, c in enumerate(corr)) + f" (limits I 0.95, Q and U 0.8) {'ok' if ok else 'not yet'}",
              flush=True)
        if ok:
            break
    if not ok:
        fail("slice (p) does not recover the CMB's I, Q and U")
    corr_iqu = {instrument.bands[b].name: {k: round(v, 5) for k, v in c.items()} for b, c in enumerate(corr)}
    steps_used = f"{PATCH_EPOCHS} x {steps}"
    del q, clean, rec

    # tests/test_ml_mapper.py:82-124, the pure-Q source, on the card
    n = 32
    data = np.zeros((3, 1, 1, n, n), dtype=np.float32)
    yy, xx = np.mgrid[:n, :n]
    data[1] = 2e-3 * np.exp(-((xx - n / 2) ** 2 + (yy - n / 2) ** 2) / (2 * (n / 7) ** 2))
    qmap = maria_torch.map.ProjectionMap(data=data, center=(150.0, 41.0), width=2.0, frame="az/el", stokes="IQU",
                                         units="K_RJ", degrees=True)
    arr = maria_torch.array.Array.from_config({"name": "pol", "n": 60, "field_of_view": 1.0, "primary_size": 10,
                                               "polarized": True, "bands": ["test/f150"]})
    qplan = maria_torch.get_plan("five_second_stare", start_time=1.75e9, sample_rate=20, scan_center=(150.0, 41.0),
                                 frame="az/el", scan_pattern="daisy", scan_options={"radius": 0.4, "speed": 0.25})
    qsim = maria_torch.Simulation(instrument=maria_torch.Instrument(arrays=[arr]), plans=qplan, site="chajnantor",
                                  atmosphere=None, noise=False, map=qmap, seed=0, device=device)
    qout = maria_torch.MaximumLikelihoodMapper([qsim.run()[0]], center=(150.0, 41.0), width=2.0, resolution=2.0 / n,
                                               frame="az/el", units="K_RJ", n_epochs=1, n_cg_iters=60).fit()
    qq, w = qout.data[1, 0, 0].cpu().numpy(), qout.weight[1, 0, 0].cpu().numpy()
    mask = w > 0
    a, b = qq[mask] - qq[mask].mean(), data[1, 0, 0][mask] - data[1, 0, 0][mask].mean()
    corr = float((a * b).sum() / np.sqrt((a**2).sum() * (b**2).sum() + 1e-30))
    ratio = float(qq[mask].std() / qout.data[0, 0, 0].cpu().numpy()[mask].std())
    ok = qout.stokes == "IQU" and corr > 0.7 and ratio > 2
    print(f"slice (p): tests/test_ml_mapper.py's pure-Q source on the card: Q correlation {corr:.5f} (limit 0.7), Q's "
          f"std / I's rms {ratio:.3f} (limit 2) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (p): the pure-Q source is not recovered")

    run_ms, run_list = warm_ms(lambda: sim.run())
    proc_ms, proc_list = warm_ms(lambda: tod.process(**scenes.CMB_PATCH_PREPROCESSING))
    build_ms, _ = warm_ms(lambda: scenes.cmb_patch_mapper([tod]), reps=2)
    fit_ms, fit_list = warm_ms(lambda: patch_fit(mapper), reps=3)
    steps = ml_step_times(mapper)
    parts = sum(v for key, v in steps.items() if key != "step")
    wall, busy, _ = profiled(lambda: patch_fit(mapper))
    print(f"slice (p): warm run() {run_ms:.2f} ms ({run_list}), processing (remove_spline, el gradient order 3) "
          f"{proc_ms:.2f} ms ({proc_list}), the mapper built (processing, blocks, naive map) {build_ms:.2f} ms, warm "
          f"fit(epochs={PATCH_EPOCHS}, steps_per_epoch={PATCH_STEPS}) {fit_ms:.2f} ms ({fit_list}); one CG step "
          f"{steps['step']:.4f} ms by CUDA events: " + ", ".join(f"{k} {v:.4f}" for k, v in steps.items() if k != "step")
          + f" (sum {parts:.4f}) ms; one fit under torch.profiler {wall:.2f} ms wall, {busy:.2f} ms device kernel "
          f"time, device busy {busy / wall:.1%} ({n_det} x {n_t} samples, n_s = 3, {mapper.n_cpix} pixels; {card})",
          flush=True)
    summary = {"setup_s": round(inst_s + plan_s + sim_s, 2), "instrument_s": round(inst_s, 2),
               "plan_s": round(plan_s, 2), "generate_cmb_s": round(cmb_s["cmb"], 2), "run_ms": round(run_ms, 2),
               "processing_ms": round(proc_ms, 2), "fit_ms": round(fit_ms, 2), "cg_step_ms": round(steps["step"], 4),
               "busy": round(busy / wall, 3), "recovery": corr_iqu, "cg_steps": steps_used}
    return pt, launches, summary


def check_binmapper_k2(tod, mapper, gen, card, label):
    """K2 as BinMapper bins one band in IQU: six channels (w sw_s d and
    w |sw_s|) at the band's ids into the map, against the float64 plain
    sums (1e-5 of their maximum); timed beside index_add_ on the ids kept
    beforehand and the byte bound."""
    import torch

    from maria_torch.mappers.bin_mapper import radec_pixel_ids
    from maria_torch.ops.bin_map import bin_map, bin_map_plain, bin_plan

    band = mapper.bands[0]
    rows = torch.as_tensor(np.where(tod.dets.band_name == band.name)[0], device=tod.device)
    n_pix = mapper.n_x * mapper.n_y
    ids = radec_pixel_ids(tod.pointing, mapper.center, mapper.res, mapper.n_x, mapper.n_y,
                          device=tod.device)[rows].contiguous()
    sw = torch.as_tensor(tod.dets.stokes_weight()[rows.cpu().numpy()][:, :3], dtype=torch.float32, device=tod.device)
    d, w = tod.signal[rows], tod.weight[rows]
    channels = torch.stack([w * sw[:, s, None] * d for s in range(3)]
                           + [w * torch.abs(sw[:, s, None]) for s in range(3)]).contiguous()
    out = bin_map(channels, ids, n_pix)
    exact = torch.stack([plain_sums64(channels[c], ids, n_pix) for c in range(6)])
    torch.cuda.synchronize()
    scale = float(exact.abs().max())
    err = float((out - exact).abs().max())
    ok = err <= 1e-5 * scale
    plan = bin_plan(n_pix, 6, ids.numel())
    print(f"slice ({label}): K2 as BinMapper's IQU band ({band.name}, 6 channels {tuple(ids.shape)} into {n_pix} "
          f"pixels; {plan['form']}, {plan['groups']} group(s) of at most 4 slots) against the float64 plain sums: "
          f"max|diff| {err:.3e} = {err / scale:.2e} of max (limit 1e-5) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"slice ({label}): K2 disagrees with its plain version at BinMapper's IQU channels")
    keep = (ids >= 0).reshape(-1)
    ids_kept, rows_kept = ids.reshape(-1)[keep].long(), channels.reshape(6, -1)[:, keep].contiguous()

    def by_index_add():
        return torch.zeros((6, n_pix), device=tod.device).index_add_(1, ids_kept, rows_kept)

    ms, plain_ms, library_ms = paired_ms(lambda: bin_map_plain(channels, ids, n_pix),
                                         lambda: bin_map(channels, ids, n_pix), by_index_add)
    r = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
         "shape": [6, *ids.shape, n_pix],
         # ids and six channels read once, six maps written once; an add a sample and channel
         **bound(4 * ids.numel() * 7 + 4 * 6 * n_pix, 6 * ids.numel())}
    print(timing_line(f"K2 as BinMapper's IQU band (slice {label}; library call index_add_; {card})", r), flush=True)
    return r


def run_act(device, card, gen):
    """Slice (q): the ACT camera (pa4, pa5, pa6: 9,000 polarized detectors
    in six bands) at the ACT site on back_and_forth_10deg_45el for
    ACT_DURATION seconds, with the 2-D atmosphere, a CMB at nside 1024 and
    noise, run() -> BinMapper(frame="ra/dec", resolution=1/30), IQU by
    itself; K2 at BinMapper's six IQU channels, the noise PSD of every
    band, times, peak memory, the device's busy share. Returns (K2's
    record, main-path launches)."""
    import torch

    import maria_torch
    import maria_torch.sim.simulation as simulation_module
    from maria_torch import scenes
    from maria_torch.ops.bin_map import bin_map
    from maria_torch.ops.pink_noise import pink_noise
    from maria_torch.ops.sht import sht_synth
    from maria_torch.profile_slice import profiled

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pink_noise.launches = bin_map.launches = sht_synth.launches = 0
    s = time.perf_counter()
    with stage_times({"instrument": (simulation_module, "get_instrument"), "plan": (maria_torch, "get_plan"),
                      "cmb": (simulation_module, "initialize_cmb")}) as parts:
        sim = scenes.act_simulation(ACT_DURATION, device, cmb_kwargs={"nside": PATCH_NSIDE})
    setup_s = time.perf_counter() - s
    instrument, plan = sim.instrument, sim.plans[0]
    inst_s, plan_s = parts["instrument"], parts["plan"]
    sim_s = setup_s - inst_s - plan_s
    s = time.perf_counter()
    program = sim.program()
    torch.cuda.synchronize()
    prog_s = time.perf_counter() - s
    ks1 = sht_synth.launches
    n_det, n_t = instrument.n_dets, plan.n
    print(f"slice (q) the ACT camera: {n_det} detectors in {len(instrument.bands)} bands ({instrument.bands.names}) x "
          f"{n_t} samples at {plan.sample_rate:.0f} Hz; host setup {inst_s + plan_s + sim_s + prog_s:.2f} s: instrument "
          f"{inst_s:.2f} s, plan {plan_s:.2f} s, Simulation {sim_s:.2f} s (generate_cmb {parts['cmb']:.2f} s of it), "
          f"program {prog_s:.2f} s ({len(program.screens)} screens)", flush=True)

    pink_noise.launches = bin_map.launches = 0
    s = time.perf_counter()
    tod = sim.run()[0]
    torch.cuda.synchronize()
    run_s = time.perf_counter() - s
    k1_run = pink_noise.launches
    s = time.perf_counter()
    mapper = maria_torch.BinMapper(tod, frame="ra/dec", resolution=1 / 30)
    out = mapper.run()
    torch.cuda.synchronize()
    map_s = time.perf_counter() - s
    launches = {"pink_noise": k1_run, "bin_map": bin_map.launches, "sht_synth": ks1}
    print(f"slice (q): first run() {run_s:.3f} s, first BinMapper.run() {map_s:.3f} s; main-path launches {launches}",
          flush=True)
    ok = tod.shape == (n_det, n_t) == (9000, int(ACT_DURATION * 20)) and set(tod.fields) == {"atmosphere", "cmb", "noise"}
    ok &= all(bool(torch.isfinite(v).all()) for v in tod.data.values()) and tod.device.type == "cuda"
    ok &= k1_run >= 6 and launches["bin_map"] >= 6 and ks1 == 3 and mapper.stokes == "IQU"
    print(f"slice (q): TOD {tod.shape} {tod.fields} in {tod.units}, atmosphere mean "
          f"{float(tod.data['atmosphere'].mean()):.3f}, max |cmb| {float(tod.data['cmb'].abs().max()):.3e}, noise std "
          f"{float(tod.data['noise'].std()):.3e} K_RJ {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (q) output check")
    check_iqu_map("q", out, 6)
    k2 = check_binmapper_k2(tod, mapper, gen, card, "q")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    run_ms, run_list = warm_ms(lambda: sim.run(), reps=3)
    map_ms, map_list = warm_ms(lambda: maria_torch.BinMapper(tod, frame="ra/dec", resolution=1 / 30).run(), reps=3)

    def one():
        t = sim.run()[0]
        maria_torch.BinMapper(t, frame="ra/dec", resolution=1 / 30).run()

    wall, busy, _ = profiled(one)
    print(f"slice (q): warm run() {run_ms:.2f} ms ({run_list}), warm BinMapper.run() {map_ms:.2f} ms ({map_list}) "
          f"into {mapper.n_x} x {mapper.n_y} pixels a band; one run() + map under torch.profiler {wall:.2f} ms wall, "
          f"{busy:.2f} ms device kernel time, device busy {busy / wall:.1%}; peak device memory {peak_gb:.2f} GB "
          f"({n_det * n_t} samples; {card})", flush=True)
    if not check_noise_psd(sim, sim.run(units="pW")[0]):
        fail("slice (q) noise PSD")
    summary = {"setup_s": round(inst_s + plan_s + sim_s + prog_s, 2), "run_ms": round(run_ms, 2),
               "map_ms": round(map_ms, 2), "busy": round(busy / wall, 3), "peak_gb": round(peak_gb, 2),
               "map_pixels": [mapper.n_y, mapper.n_x]}
    return k2, launches, summary


USAGE_CENTER = (150.0, 10.0)
USAGE_MAP_KW = dict(center=USAGE_CENTER, width=0.25, resolution=6e-4, frame="ra/dec")  # docs/usage.md:94-107
USAGE_UNITS = ("uK_RJ", "uK_CMB", "Jy/pixel")


def usage_config():
    """docs/usage.md:43-63 as written: the Planner's 600 s daisy over
    (150, 10) deg at the GBT (its default 20 Hz), and the Simulating
    snippet's keywords; the device is the card, the default."""
    import maria_torch

    plans = maria_torch.Planner(target=USAGE_CENTER, site="GBT").generate_plans(
        start_time=1.75e9, horizon_days=2, total_duration=600, scan_pattern="daisy", scan_options={"radius": 0.083},
    )
    return dict(instrument="MUSTANG-2", plans=plans, site="GBT", atmosphere="2d", cmb="generate",
                map=maria_torch.map.get("cluster", center=USAGE_CENTER), noise=True, pwv=1.2, seed=0)


def tod_on_cpu(tod):
    """The same TOD (fields, pointing, detectors, metadata) with its
    fields on the CPU."""
    import maria_torch

    return maria_torch.TOD(data={k: v.cpu() for k, v in tod.data.items()}, pointing=tod.pointing, dets=tod.dets,
                           units=tod.units, metadata=tod.metadata, spectrum=tod.spectrum)


def run_usage(device, card):
    """Slice (r): docs/usage.md's Simulating snippet as written, then the
    checks of the units layer on its TOD. Returns (main-path launches,
    the pixel ids of its maps, the map's pixel count, summary)."""
    import torch

    import maria_torch
    from maria_torch.calibration import Calibration
    from maria_torch.mappers.bin_mapper import radec_pixel_ids
    from maria_torch.ops.bin_map import bin_map
    from maria_torch.ops.pink_noise import pink_noise
    from maria_torch.ops.sht import sht_synth

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sht_synth.launches = 0
    s = time.perf_counter()
    config = usage_config()
    sim = maria_torch.Simulation(**config)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - s
    obs = sim.obs_list[0]
    zenith_pwv = float(obs.atmosphere.weather.pwv)
    ks1 = sht_synth.launches
    ok = abs(zenith_pwv - 1.2) < 1e-4 and len(sim.obs_list) == 1 and ks1 == 3 and sim.device.type == "cuda"
    print(f"slice (r) docs/usage.md's scene: {obs.shape[0]} detectors x {obs.shape[1]} samples at "
          f"{obs.sample_rate:.0f} Hz (the Planner's default rate), setup {setup_s:.2f} s; the loose pwv=1.2 reaches "
          f"the weather: zenith pwv {zenith_pwv:.6f} mm; KS1 launched {ks1} times by generate_cmb "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (r) setup")

    pink_noise.launches = bin_map.launches = 0
    s = time.perf_counter()
    tod = sim.run(units="K_RJ")[0]
    torch.cuda.synchronize()
    run_s = time.perf_counter() - s
    k1_run = pink_noise.launches
    ok = tod.shape == obs.shape and tod.fields == ["atmosphere", "cmb", "map", "noise"] and tod.units == "K_RJ"
    ok &= all(bool(torch.isfinite(v).all()) for v in tod.data.values()) and tod.device.type == "cuda"
    ok &= k1_run == 2
    print(f"slice (r): first run() {run_s:.3f} s, K1 launched {k1_run} times (the band's rows and its correlated "
          f"modes); TOD {tod.shape} {tod.fields} in {tod.units}, map field max "
          f"{float(tod.data['map'].abs().max()):.3e} K_RJ {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (r) output check")

    # the same keywords through from_config: a second simulation with seed 0
    again = maria_torch.Simulation.from_config(config).run(units="K_RJ")[0]
    diffs = {k: float((again.data[k] - tod.data[k]).abs().max()) for k in tod.fields}
    scale = max(float(v.abs().max()) for v in tod.data.values())
    exact = all(d == 0.0 for d in diffs.values())
    ok = again.fields == tod.fields and (exact or max(diffs.values()) <= 1e-6 * scale)
    print(f"slice (r): Simulation.from_config(config) against the constructor, both seed 0: "
          f"{'equal to the bit' if exact else f'max|diff| by field {diffs}, limit 1e-6 of {scale:.3e}'} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (r) from_config / seed repeatability")
    del again

    # tod.to("uK_CMB") on the card against the CPU, on the same pW TOD
    tod_pw = sim.run(units="pW")[0]
    card_cmb = tod_pw.to("uK_CMB")
    cpu_tod = tod_on_cpu(tod_pw)
    cpu_cmb = cpu_tod.to("uK_CMB")
    worst = 0.0
    for k in tod_pw.fields:
        ref = cpu_cmb.data[k]
        worst = max(worst, float((card_cmb.data[k].cpu() - ref).abs().max()) / float(ref.abs().max()))
    band = tod_pw.dets.bands[0]
    card_f = Calibration("pW -> uK_CMB", band=band, **tod_pw.calibration_kwargs(band))(1.0)
    cpu_f = Calibration("pW -> uK_CMB", band=band, **cpu_tod.calibration_kwargs(band))(1.0)
    f_err = float(((card_f.cpu() - cpu_f) / cpu_f).abs().max())
    ok = worst <= 1e-5 and f_err <= 1e-5 and card_f.device.type == "cuda"
    print(f"slice (r): tod.to('uK_CMB') on the card against the CPU: worst field max|diff| {worst:.3e} of its max; "
          f"the per-sample pW -> uK_CMB factor (dP/dT_CMB through the atmosphere, {float(cpu_f.min()):.4e} to "
          f"{float(cpu_f.max()):.4e} uK_CMB/pW) {f_err:.3e} relative (limits 1e-5) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail("slice (r) TOD.to on the card")
    del cpu_tod, cpu_cmb, card_cmb, card_f, cpu_f

    # BinMapper in three units: K2 once a band and unit
    rj_map = maria_torch.BinMapper(tod, **USAGE_MAP_KW).run()
    bin_map.launches = 0
    maps, map_ms = {}, {}
    for units in USAGE_UNITS:
        s = time.perf_counter()
        maps[units] = maria_torch.BinMapper(tod, units=units, **USAGE_MAP_KW).run()
        map_ms[units] = (time.perf_counter() - s) * 1e3
    k2_maps = bin_map.launches
    # each map against the K_RJ map converted, within 1e-6 of the TOD's
    # largest sample in the map's unit: a float32 rounding of each sample
    # (and K2's atomic order) before the binning and the demeaning
    signal_max = float(tod.signal.abs().max())
    jy_ref = rj_map.to("Jy/pixel").data.numpy()
    jy_factor = float(np.nanmax(np.abs(jy_ref)) / np.nanmax(np.abs(rj_map.data.numpy())))
    jy_err = float(np.nanmax(np.abs(maps["Jy/pixel"].data.numpy() - jy_ref))) / (jy_factor * signal_max)
    uk_err = float(np.nanmax(np.abs(maps["uK_RJ"].data.numpy() - 1e6 * rj_map.data.numpy()))) / (1e6 * signal_max)
    ok = k2_maps == len(USAGE_UNITS) and jy_err <= 1e-6 and uk_err <= 1e-6
    ok &= all(m.units == u and bool(np.isfinite(m.data.numpy()).all()) for u, m in maps.items())
    print(f"slice (r): BinMapper maps in {list(USAGE_UNITS)} ({rj_map.n_y} x {rj_map.n_x}), K2 launched {k2_maps} "
          f"times; the Jy/pixel map against the K_RJ map's .to('Jy/pixel') {jy_err:.3e}, the uK_RJ map against 1e6 x "
          f"the K_RJ map {uk_err:.3e} of the TOD's largest sample in the unit (limits 1e-6) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (r) maps in other units")

    # the per-stage path of the same scene
    staged_sim = maria_torch.Simulation(fused=False, **config)
    staged = staged_sim.run(units="K_RJ")[0]
    ratios = {k: float(staged.data[k].std() / tod.data[k].std()) for k in tod.fields}
    diffs = {k: float((staged.data[k] - tod.data[k]).abs().max() / tod.data[k].abs().max()) for k in tod.fields}
    ok = staged.fields == tod.fields and all(0.5 <= r <= 2.0 for r in ratios.values()) and not staged_sim._programs
    print(f"slice (r): Simulation(fused=False) std / fused std by field "
          f"{({k: round(r, 5) for k, r in ratios.items()})} "
          f"(maria_tpu's gate 0.5-2); max|diff| of the fields from the fused run's, of its max "
          f"{({k: f'{d:.2e}' for k, d in diffs.items()})} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (r) per-stage path")

    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    run_ms, run_list = warm_ms(lambda: sim.run(units="K_RJ"))
    staged_ms, staged_list = warm_ms(lambda: staged_sim.run(units="K_RJ"))
    to_ms, to_list = warm_ms(lambda: tod_pw.to("uK_CMB"))
    warm_map = {u: warm_ms(lambda u=u: maria_torch.BinMapper(tod, units=u, **USAGE_MAP_KW).run()) for u in USAGE_UNITS}
    print(f"slice (r): warm run() {run_ms:.2f} ms ({run_list}), fused=False {staged_ms:.2f} ms ({staged_list}), "
          f"tod.to('uK_CMB') {to_ms:.2f} ms ({to_list}), BinMapper.run() by unit "
          f"{({u: round(m[0], 2) for u, m in warm_map.items()})} ms (means of {WARM_REPS}); peak device memory "
          f"{peak_gb:.2f} GB ({card})", flush=True)
    if not check_noise_psd(sim, tod_pw):
        fail("slice (r) noise PSD")
    mapper = maria_torch.BinMapper(tod, **USAGE_MAP_KW)
    ids = radec_pixel_ids(tod.pointing, mapper.center, mapper.res, mapper.n_x, mapper.n_y, device=device).contiguous()
    summary = {"setup_s": round(setup_s, 2), "run_ms": round(run_ms, 2), "staged_run_ms": round(staged_ms, 2),
               "to_uK_CMB_ms": round(to_ms, 2), "map_ms": {u: round(m[0], 2) for u, m in warm_map.items()},
               "peak_gb": round(peak_gb, 2), "shape": list(tod.shape)}
    return {"pink_noise": k1_run, "bin_map": k2_maps, "sht_synth": ks1}, ids, mapper.n_x * mapper.n_y, summary


def run_photon_noise(device, card):
    """Slice (s): slice (c)'s scene with every band's NEP_per_loading set
    so that the loading term equals the band's NEP at the band's mean
    loading, and the last band without a knee. Returns (main-path
    launches, summary)."""
    import torch

    from maria_torch import scenes
    from maria_torch.atmosphere.fourier import good_fft_size
    from maria_torch.ops.pink_noise import pink_noise
    from maria_torch.ops.shared_v import shared_v

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    s = time.perf_counter()
    sim = scenes.simulation("atlast", 60.0, device)
    bands = sim.instrument.dets.bands
    bands[-1].knee = 0.0
    plain = sim.program()  # no band carries NEP_per_loading yet
    state = sim.generator.get_state()
    signal = plain.fields(generator=sim.generator, device=device, upto="signal")
    loading = sum(signal.values())
    del signal
    sim.generator.set_state(state)
    mean_W = {}
    for band, block in zip(bands, plain.bands):
        mean_W[band.name] = 1e-12 * float(loading[torch.as_tensor(block.det_index, device=device)].double().mean())
        band.NEP_per_loading = band.NEP / mean_W[band.name]
    sim._programs.clear()
    program = sim.program()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - s
    npl = {b.name: b.NEP_per_loading for b in bands}
    print(f"slice (s) AtLAST-50k photon noise: {program.n_det} x {program.n_t}, {len(bands)} bands; NEP_per_loading = "
          f"NEP / mean loading a band, {({k: f'{v:.4e}' for k, v in npl.items()})} /√s at mean loadings "
          f"{({k: f'{1e12 * v:.3f} pW' for k, v in mean_W.items()})}; {bands[-1].name} without a knee; setup "
          f"{setup_s:.2f} s; noise matmul {program.use_noise_matmul()}", flush=True)

    fn = program.total_power_fn()
    pink_noise.launches = shared_v.launches = 0
    s = time.perf_counter()
    total = fn(generator=sim.generator, device=device)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - s
    launches = {"pink_noise": pink_noise.launches, "shared_v": shared_v.launches}
    n_knee = sum(1 for b in bands if b.knee > 0)
    ok = not program.use_noise_matmul() and launches == {"pink_noise": 2 * n_knee, "shared_v": 0}
    ok &= tuple(total.shape) == (program.n_det, program.n_t) and bool(torch.isfinite(total).all())
    print(f"slice (s): first total_power_fn() {cold_s:.3f} s, launches {launches} (K1 twice a band with a knee: its "
          f"5,556 rows at n_fft {good_fft_size(program.n_t)} and its correlated modes; K3 never) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (s) launches")

    # the total against its fields, and each band's noise against the
    # NEP_per_loading-free program's on the same draws
    sim.generator.set_state(state)
    fields, _ = program.fields(generator=sim.generator, device=device)
    gains = program.draw_gains(generator=sim.generator, device=device)
    by_sum = 0.0
    for name, v in fields.items():
        by_sum = by_sum + (v if name == "noise" else v * gains)
    total_err = float((total - by_sum).abs().max()) / float(total.abs().max())
    del by_sum, gains
    sim.generator.set_state(state)
    plain_fields, _ = plain.fields(generator=sim.generator, device=device)
    loading_W = 1e-12 * sum(v.double() for k, v in fields.items() if k != "noise")
    worst = 0.0
    for band, block in zip(bands, program.bands):
        rows = torch.as_tensor(block.det_index, device=device)
        expected = plain_fields["noise"][rows].double() * (1 + band.NEP_per_loading / band.NEP * loading_W[rows])
        err = float(((fields["noise"][rows].double() - expected).abs() / expected.abs().clamp_min(1e-30)).max())
        worst = max(worst, err)
    ok = total_err <= 1e-6 and worst <= 1e-5
    print(f"slice (s): total against the gained sum of its fields {total_err:.3e} of its max (limit 1e-6); each band's "
          f"noise against (NEP + NEP_per_loading P) / NEP x the same program's without the term on the same draws: "
          f"worst {worst:.3e} relative (limit 1e-5) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (s) photon-loading noise")
    del loading_W, fields, total

    # the knee-free band of the plain program: white noise of variance fs NEP^2
    band = bands[-1]
    rows = torch.as_tensor(plain.bands[-1].det_index, device=device)
    x = plain_fields["noise"][rows].double()
    fs, n = plain.sample_rate, plain.n_t
    var_ratio = float(x.var()) / (fs * (1e12 * band.NEP) ** 2)
    psd = (torch.fft.rfft(x - x.mean(dim=-1, keepdim=True), dim=-1).abs() ** 2).mean(dim=0).cpu().numpy()[1:] / n
    means = [float(p.mean()) for p in np.array_split(psd, 8)]
    flat = max(abs(m / np.mean(means) - 1) for m in means)
    ok = abs(var_ratio - 1) <= 0.05 and flat <= 0.10
    print(f"slice (s): {band.name} without a knee: variance / (fs NEP^2) {var_ratio:.5f} (limit 5%), PSD in eight "
          f"bands of frequency within {flat:.4f} of their mean (limit 10%) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (s) knee-free band")
    del plain_fields, x

    total_ms, total_list = warm_ms(lambda: fn(generator=sim.generator, device=device))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"slice (s): warm total_power_fn() {total_ms:.2f} ms ({total_list}; means of {WARM_REPS}), peak device "
          f"memory {peak_gb:.2f} GB ({card})", flush=True)
    summary = {"setup_s": round(setup_s, 2), "total_ms": round(total_ms, 2), "peak_gb": round(peak_gb, 2),
               "NEP_per_loading": {k: float(f"{v:.4e}") for k, v in npl.items()}}
    return launches, summary


STREAM_SECONDS = 600.0  # slices (t) and (v)
STREAM_CHECK_SECONDS = 60.0  # (t)'s equality gates, (v)'s batch comparison
ML_GATE_SECONDS = 30.0  # (v)'s gates: tests/test_streaming_ml.py's scene as written
U_SECONDS = (600.0, 3600.0)  # slice (u)
LOOP_BUFFERS = 16  # (t)'s gate: the block loop's peak above init_state, in (n_det, B) float32 buffers
KC_BLOCKS = 47  # consecutive blocks KC and its plain version are held against a float64 recurrence
KC_ROWS = 256  # rows of that recurrence, spread over the launch
# the earlier form of KC (a thread a row, no split, no ring) at the streamed
# blocks, for reference: PERF.md section 6, by chip_smoke at (t) and (u) and
# by profile_cascade --parent at (v) (NVIDIA H100 80GB HBM3, 700.00 W)
EARLIER_KC_MS = {"t": 0.2117, "u": 0.3912, "v": 0.0425}


def cascade_float64(w, state, p, a):
    """The cascade's recurrence in float64 on the host: (pink, state)."""
    x = state.astype(np.float64).copy()
    out = np.empty(w.shape)
    for t in range(w.shape[1]):
        x = p * x + w[:, t:t + 1]
        out[:, t] = (x * a).sum(axis=1)
    return out, x


def check_pink_cascade(device, gen, ex, label):
    """KC against its plain version (the Toeplitz form) at executor
    ``ex``'s block: every band's detector and mode rows in one launch, as
    the block loop makes it. Both are held against a float64 recurrence on
    KC_ROWS of the rows over KC_BLOCKS consecutive blocks, the state
    carried: KC's largest error under 1e-4 of the pink part's std, or
    under twice the Toeplitz form's. Timed beside the Toeplitz GEMM alone
    (w times the sub-chunk table, the yardstick), the byte bound and the
    latency bound of the split the launch takes."""
    import torch

    from maria_torch.ops.pink_cascade import (CHUNK, cascade_plan, lane_fmas, pink_cascade, pink_cascade_plain,
                                              toeplitz_tables)

    cr = ex._casc_rows
    t = ex._casc_tensors(device)
    rows, n, K = cr["n"], ex.B, cr["K"]
    pick = np.unique(np.linspace(0, rows - 1, KC_ROWS).astype(np.int64))
    tab_np = cr["table_np"][pick]
    p_np = t["p"].cpu().numpy().astype(np.float64)[tab_np]
    a_np = t["a"].cpu().numpy().astype(np.float64)[tab_np]
    # the stationary start of every row's cascade, as init_state draws it
    state = torch.cat([ex.noise_models[i].cascade.init_state(z - a, gen, device=device)
                       for (i, _), (a, z) in cr["spans"].items()])
    s_kc = s_plain = state
    s64 = state[pick].cpu().numpy()
    err_kc = err_plain = 0.0
    stds = []
    for _ in range(KC_BLOCKS):
        w = torch.randn((rows, n), generator=gen, device=device)
        y_kc, s_kc = pink_cascade(w, s_kc, t["p"], t["a"], t["table"])
        y_plain, s_plain = pink_cascade_plain(w, s_plain, t["p"], t["a"], t["table"])
        ref, s64 = cascade_float64(w[pick].cpu().numpy(), s64, p_np, a_np)
        err_kc = max(err_kc, float(np.abs(y_kc[pick].cpu().numpy() - ref).max()))
        err_plain = max(err_plain, float(np.abs(y_plain[pick].cpu().numpy() - ref).max()))
        stds.append(float(ref.std()))
    std = float(np.mean(stds))
    ok = err_kc <= max(1e-4 * std, 2 * err_plain) and bool(torch.isfinite(y_kc).all())
    name = f"KC pink_cascade (slice {label}'s block: {rows} rows of {len(ex._casc_bands)} band table(s) x {n}, K {K})"
    print(f"{name}: largest error against the float64 recurrence over {KC_BLOCKS} blocks, {len(pick)} rows: KC "
          f"{err_kc:.3e}, Toeplitz form {err_plain:.3e}, pink std {std:.4f} (limit max(1e-4 std, 2 x Toeplitz)) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(name)
    w = torch.randn((rows, n), generator=gen, device=device)
    chunk = min(n, CHUNK)
    LGT = toeplitz_tables(t["p"][0], t["a"][0], chunk, device)[0]
    gemm_in = w[:, :chunk].contiguous()
    ms, plain_ms, library_ms = paired_ms(lambda: pink_cascade_plain(w, state, t["p"], t["a"], t["table"]),
                                         lambda: pink_cascade(w, state, t["p"], t["a"], t["table"]),
                                         lambda: torch.matmul(gemm_in, LGT))
    library_ms *= n / chunk
    # the device's time a launch, the calls replayed from a CUDA graph:
    # back-to-back calls of a short kernel time the host
    graph = graph_ms(lambda: pink_cascade(w, state, t["p"], t["a"], t["table"]))
    library_graph = graph_ms(lambda: torch.matmul(gemm_in, LGT)) * n / chunk
    # the split's latency bound: its longest lane's FMAs, one a cycle
    G, S = cascade_plan(rows, n)
    lat = lane_fmas(n, K, G, S) / (LANE_INSTRUCTIONS_S / (132 * 4 * 32)) * 1e3
    r = {"max_abs_err": err_kc, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "shape": [rows, n, K],
         "toeplitz_err": err_plain, **bound(8.0 * rows * n + 8.0 * rows * K, 4.0 * K * rows * n), "graph_ms": graph}
    earlier = EARLIER_KC_MS[label]
    print(timing_line(f"{name} (library: the Toeplitz GEMM w @ LGT alone, TF32 off)", r)
          + f"; from a CUDA graph (the device's time) kernel {graph:.4f} ms, library {library_graph:.4f} ms, kernel "
          + f"at {r['bound_ms'] / graph:.1%} of the bound; split G {G}, S {S}: latency bound {lat:.4f} ms, kernel "
          + f"at {lat / graph:.1%} of it; the earlier one-thread-a-row kernel {earlier:.4f} ms (recorded)", flush=True)
    return r


def stream_launches() -> dict:
    from maria_torch.ops.bin_map import bin_map
    from maria_torch.ops.pink_cascade import pink_cascade

    return {"pink_cascade": pink_cascade.launches, "bin_map": bin_map.launches}


def reset_stream_launches():
    from maria_torch.ops.ar_extrude import ar_extrude
    from maria_torch.ops.bin_map import bin_map
    from maria_torch.ops.pink_cascade import pink_cascade

    pink_cascade.launches = bin_map.launches = ar_extrude.launches = 0


def stream_stage_ms(ex, state) -> dict:
    """The block loop's stages summed over every block, each its own pass
    ended by a synchronize: upsample (the atmosphere), noise (white draws,
    KC, the bands' sums), binning (pixel ids and K2)."""
    import torch

    from maria_torch.ops.bin_map import bin_map

    out = {}
    for stage in ("upsample", "noise", "binning"):
        torch.cuda.synchronize()
        s = time.perf_counter()
        st = state
        for b in range(ex.n_blocks):
            atm = ex.atmosphere_block(st, b)
            if stage == "noise":
                st = dict(st, noise=ex.noise_block(st, b, atm)[0])
            elif stage == "binning":
                bin_map(atm[None], ex.pixel_ids(b), ex.n_x * ex.n_y, count=True)
            del atm
        torch.cuda.synchronize()
        out[stage] = (time.perf_counter() - s) * 1e3
    out["noise"] -= out["upsample"]
    out["binning"] -= out["upsample"]
    return out


def run_streamed_atlast(device, card, gen):
    """Slice (t): AtLAST-50k x 600 s streamed (bench.py:844-880's scene):
    StreamingExecutor(program, obs, block_tc=128).run(group_size=8), every
    sample in the map, the block loop's peak above init_state under
    LOOP_BUFFERS (n_det, B) buffers; at 60 s with noise off the
    concatenated tod_blocks equal to total_power_fn() on the same draws
    (1e-6 relative), with noise on the streamed Welch PSD equal to the
    Welch PSD of the concatenated blocks; KC against its plain version."""
    import copy

    import torch

    from maria_torch.ops.streaming_exec import StreamingExecutor, _generator
    from maria_torch.scenes import simulation

    s = time.perf_counter()
    sim = simulation("atlast", STREAM_SECONDS, device)
    program = sim.program()
    ex = StreamingExecutor(program, sim.obs_list[0], block_tc=128, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - s
    n_samples = ex.n_det * ex.n_t
    print(f"slice (t) AtLAST-50k {STREAM_SECONDS:.0f} s streamed: host setup {setup_s:.2f} s ({ex.n_det} detectors x "
          f"{ex.n_t} samples = {n_samples:.3e}; block_tc {ex.block_tc}, B {ex.B}, {ex.n_blocks} blocks; map {ex.n_x} x "
          f"{ex.n_y}, res {np.degrees(ex.res) * 3600:.2f} arcsec; {ex._casc_rows['n']} cascade rows, K "
          f"{ex._casc_rows['K']})", flush=True)
    kc = check_pink_cascade(device, gen, ex, "t")
    k2 = check_stream_k2(device, gen, ex, "t")["count"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_stream_launches()
    s = time.perf_counter()
    state = ex.init_state(0)
    torch.cuda.synchronize()
    coarse_s = time.perf_counter() - s
    coarse_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    s = time.perf_counter()
    res = ex.run(0, group_size=8, state=state)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - s
    loop_peak = (torch.cuda.max_memory_allocated() - held) / 1e9
    launches = stream_launches()
    buffer_gb = ex.n_det * ex.B * 4 / 1e9
    hits = float(res.map_wgt.astype(np.float64).sum())
    ok = hits == n_samples and np.isfinite(res.map_sum).all()
    ok &= launches == {"pink_cascade": ex.n_blocks, "bin_map": ex.n_blocks}
    ok &= loop_peak < LOOP_BUFFERS * buffer_gb
    print(f"slice (t): first run: coarse stage (init_state) {coarse_s:.3f} s, peak {coarse_peak:.2f} GB above the "
          f"program's tables; block loop {loop_s:.3f} s, peak {loop_peak:.3f} GB above init_state's {held / 1e9:.2f} GB "
          f"(limit {LOOP_BUFFERS} x {buffer_gb:.3f} GB = {LOOP_BUFFERS * buffer_gb:.2f} GB, "
          f"{loop_peak / buffer_gb:.1f} buffers); main-path launches {launches}; hits {hits:.0f} of {n_samples} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (t) streamed run")
    del state
    warm, each = warm_ms(lambda: ex.run(0, group_size=8), reps=3)
    state = ex.init_state(0)
    stages = stream_stage_ms(ex, state)
    del state
    torch.cuda.synchronize()
    s = time.perf_counter()
    ex.init_state(0)
    torch.cuda.synchronize()
    stages = {"coarse": (time.perf_counter() - s) * 1e3, **stages}
    summary = {"setup_s": setup_s, "warm_ms": warm, "warm_each_ms": each, "samples_per_s": n_samples / (warm / 1e3),
               "coarse_peak_gb": coarse_peak, "loop_peak_gb": loop_peak, "init_state_gb": held / 1e9,
               "loop_buffers": loop_peak / buffer_gb, "launches": launches, "stage_ms": stages, "B": ex.B,
               "n_blocks": ex.n_blocks}
    print(f"slice (t): warm run() {warm:.1f} ms (mean of 3: {each}), {n_samples / (warm / 1e3):.3e} samples/s; "
          f"stages (ms, each a pass of its own over every block): {json.dumps(stages)}", flush=True)
    # the wide-array cap of block_tc="auto" (128 cells): the block loop at
    # 128 and at 256 cells, in turns, with its peak above init_state
    cap = {}
    for block_tc in (128, 256, 256, 128):
        ex_c = ex if block_tc == ex.block_tc else StreamingExecutor(program, sim.obs_list[0], block_tc=block_tc,
                                                                    device=device)
        state = ex_c.init_state(0)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        s = time.perf_counter()
        ex_c.run(0, group_size=8, state=state)
        torch.cuda.synchronize()
        cap.setdefault(block_tc, []).append(((time.perf_counter() - s) * 1e3,
                                             (torch.cuda.max_memory_allocated() - held) / 1e9))
        del state, ex_c
    summary["cap"] = {str(k): v for k, v in cap.items()}
    print(f"slice (t): the block loop (ms, peak GB above init_state) at block_tc 128 {cap[128]} and 256 {cap[256]}",
          flush=True)

    # the equality gates at 60 s
    sim60 = simulation("atlast", STREAM_CHECK_SECONDS, device)
    prog60 = copy.copy(sim60.program())
    prog60.with_noise = False
    ex60 = StreamingExecutor(prog60, sim60.obs_list[0], block_tc=128, device=device)
    key = 3
    draw_gains = torch.randn((prog60.n_det,), generator=_generator(device, key, 1), device=device)
    batch = prog60.total_power_fn()(generator=_generator(device, key, 0), draws={"gains": draw_gains}, device=device)
    stream = torch.cat([blk for _, blk in ex60.tod_blocks(key)], dim=-1)
    rel = float((stream - batch).abs().max()) / float(batch.abs().max())
    ok = stream.shape == batch.shape and rel <= 1e-6
    print(f"slice (t) at {STREAM_CHECK_SECONDS:.0f} s, noise off: streamed TOD {tuple(stream.shape)} against "
          f"total_power_fn() on the same draws, largest difference {rel:.3e} of its maximum (limit 1e-6) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    del batch, stream
    if not ok:
        fail("slice (t) streamed against batch")
    ex60n = StreamingExecutor(sim60.program(), sim60.obs_list[0], block_tc=128, device=device)
    res = ex60n.run(key, accumulate_psd=True)
    tod = torch.cat([blk for _, blk in ex60n.tod_blocks(key)], dim=-1)
    B, n_full = ex60n.B, ex60n.n_t // ex60n.B
    hann = torch.hann_window(B, periodic=True, device=device)
    worst = 0.0
    for i, band in enumerate(ex60n.program.bands):
        x = tod[torch.as_tensor(band.det_index, device=device)][:, :n_full * B].reshape(len(band.det_index), n_full, B)
        x = x - x.mean(dim=-1, keepdim=True)
        p = (torch.fft.rfft(x * hann, dim=-1).abs() ** 2).mean(dim=(0, 1)).double().cpu().numpy()
        p *= 2 / (prog60.sample_rate * float((hann**2).sum()))
        p[0] /= 2
        if B % 2 == 0:
            p[-1] /= 2
        worst = max(worst, float(np.abs(res.psds[i][1:] / p[1:] - 1).max()))
    ok = worst <= 1e-3
    print(f"slice (t) at {STREAM_CHECK_SECONDS:.0f} s, noise on: streamed Welch PSD of {len(res.psds)} bands against "
          f"the Welch PSD of the concatenated blocks, largest relative difference {worst:.3e} (limit 1e-3) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (t) streamed Welch PSD")
    return kc, k2, launches, summary


def loop_peak_run(ex, key=0, group_size=16):
    """(run seconds, whole peak GB, block loop's peak above init_state GB)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    s = time.perf_counter()
    state = ex.init_state(key)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ex.run(key, group_size=group_size, state=state)
    torch.cuda.synchronize()
    loop = torch.cuda.max_memory_allocated() - held
    return time.perf_counter() - s, max(init_peak, held - base + loop) / 1e9, loop / 1e9


def run_streamed_mustang(device, card, program_g, tmp_dir):
    """Slice (u): tools/streaming_memory_demo.py's scene (MUSTANG-2, GBT,
    daisy_5arcmin_60s at 50 Hz, 2-D atmosphere, noise; block_tc 64,
    group_size 16) at 600 s and 3,600 s: the block loop's peak above
    init_state at 3,600 s within 1.15x of 600 s; a run broken off after two
    checkpoints and resumed equal to the uninterrupted one; a wrong seed or
    geometry refused; (g)'s 3-D AR process in chunks through
    StreamingExtrusion equal to one long extrusion."""
    import torch

    import maria_torch
    from maria_torch.atmosphere.streaming import StreamingExtrusion
    from maria_torch.ops.ar_extrude import ar_extrude
    from maria_torch.ops.program import build_tod_program
    from maria_torch.ops.streaming_exec import StreamingExecutor

    out, exs, obs_by = {}, {}, {}
    for duration in U_SECONDS:
        s = time.perf_counter()
        plan = maria_torch.get_plan("daisy_5arcmin_60s", start_time=1.75e9, scan_center=(150.0, 41.0),
                                    frame="az/el", duration=duration, sample_rate=50.0)
        sim = maria_torch.Simulation(instrument="MUSTANG-2", plans=plan, site="GBT", atmosphere="2d", noise=True,
                                     seed=0, device=device)
        program = build_tod_program(sim.obs_list[0], noise_kwargs=sim.noise_kwargs, device=device)
        ex = StreamingExecutor(program, sim.obs_list[0], block_tc=64, device=device)
        setup_s = time.perf_counter() - s
        reset_stream_launches()
        cold_s, peak, loop = loop_peak_run(ex)
        launches = stream_launches()
        warm, each = warm_ms(lambda: ex.run(0, group_size=16), reps=3)
        ok = launches == {"pink_cascade": ex.n_blocks, "bin_map": ex.n_blocks}
        out[duration] = {"setup_s": setup_s, "cold_s": cold_s, "warm_ms": warm, "warm_each_ms": each,
                         "peak_gb": peak, "loop_peak_gb": loop, "n_blocks": ex.n_blocks, "launches": launches,
                         "samples_per_s": ex.n_det * ex.n_t / (warm / 1e3)}
        print(f"slice (u) MUSTANG-2 {duration:.0f} s streamed ({ex.n_det} x {ex.n_t}, B {ex.B}, {ex.n_blocks} "
              f"blocks): setup {setup_s:.2f} s, first run {cold_s:.3f} s, warm {warm:.1f} ms ({each}), whole peak "
              f"{peak:.3f} GB, block loop's peak above init_state {loop * 1e3:.2f} MB; launches {launches} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"slice (u) at {duration:.0f} s")
        exs[duration], obs_by[duration] = ex, sim.obs_list[0]
    ratio = out[U_SECONDS[1]]["loop_peak_gb"] / out[U_SECONDS[0]]["loop_peak_gb"]
    ok = ratio <= 1.15
    print(f"slice (u): the block loop's peak at {U_SECONDS[1]:.0f} s over {U_SECONDS[0]:.0f} s: {ratio:.4f} "
          f"(limit 1.15) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (u) bounded memory")

    ex = exs[U_SECONDS[0]]
    check_inference_mode_block(ex.program, obs_by[U_SECONDS[0]], device)
    path = os.path.join(tmp_dir, "stream_u.ckpt.npz")
    full = ex.run(5, group_size=2)
    state = ex.init_state(5)
    for b, state, _ in ex._blocks(state):  # groups of two blocks, broken off after the second group's checkpoint
        if b + 1 in (2, 4):
            ex._save_ckpt(path, state, b + 1, 5)
        if b + 1 == 4:
            break
    resumed = ex.run(5, group_size=2, checkpoint_path=path)
    err = float(np.abs(resumed.map_sum - full.map_sum).max()) / float(np.abs(full.map_sum).max())
    refused = []
    for bad in ((6, ex), (5, StreamingExecutor(ex.program, None, block_tc=64, n_x=64, n_y=64, device=device))):
        try:
            bad[1].run(bad[0], group_size=2, checkpoint_path=path)
            refused.append(False)
        except ValueError:
            refused.append(True)
    ok = np.array_equal(resumed.map_wgt, full.map_wgt) and err <= 1e-6 and all(refused)
    print(f"slice (u): run broken off after 2 checkpoints (block 4 of {ex.n_blocks}) and resumed: hits equal "
          f"{np.array_equal(resumed.map_wgt, full.map_wgt)}, sums within {err:.3e} of their maximum (limit 1e-6); a "
          f"wrong seed / geometry refused {refused} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (u) checkpoint and resume")

    (proc,) = program_g.ar_processes
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    chunk_rows, n_chunks = 128, 4
    stream = StreamingExtrusion(proc, chunk_rows, device=device)
    reset_stream_launches()
    state0 = stream.initial_state(gen)
    noise = torch.randn((n_chunks * chunk_rows, proc.n_cross_section), generator=gen, device=device)
    chunks, st = [], state0
    torch.cuda.synchronize()
    s = time.perf_counter()
    for c in range(n_chunks):
        st, chunk = stream.step(st, noise[c * chunk_rows:(c + 1) * chunk_rows])
        chunks.append(chunk)
    torch.cuda.synchronize()
    chunk_ms = (time.perf_counter() - s) * 1e3 / n_chunks
    ar_launches = ar_extrude.launches
    long = torch.cat([torch.zeros((n_chunks * chunk_rows, proc.n_cross_section), device=device), state0])
    (one,) = ar_extrude([proc], [long], [noise], steps=[n_chunks * chunk_rows], rows=n_chunks * chunk_rows)
    equal = bool(torch.equal(torch.cat(chunks), one.flip(0)))
    rel = float((torch.cat(chunks) - one.flip(0)).abs().max()) / float(one.std())
    ok = (equal or rel <= 1e-6) and ar_launches == n_chunks + 1
    print(f"slice (u): (g)'s 3-D AR process ({proc.n_extrusion} x {proc.n_cross_section} x {proc.n_sample}) in "
          f"{n_chunks} chunks of {chunk_rows} rows through StreamingExtrusion ({ar_launches} AR launches with the "
          f"start's; {chunk_ms:.3f} ms a chunk): equal to one long extrusion bit for bit {equal} (largest difference "
          f"{rel:.3e} of a screen's std) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (u) chunked AR extrusion")
    ar_r = check_ar_chunk(device, torch.Generator(device=device), proc, chunk_rows)
    ar_r.update({"chunk_wall_ms": chunk_ms, "launches": ar_launches})
    kc = check_pink_cascade(device, torch.Generator(device=device), ex, "u")
    return out, ar_r, kc


def streamed_ml_scene(device, duration):
    """Slice (v)'s scene: tests/test_streaming_ml.py:15-37 at ``duration``
    s (MUSTANG-2 at 20 Hz, the injected az/el blob, a mild atmosphere and
    noise) -> (executor on 48 x 48 pixels over 0.2 deg, obs, blob)."""
    import maria_torch
    from maria_torch.map import ProjectionMap
    from maria_torch.ops.program import build_tod_program
    from maria_torch.ops.streaming_exec import StreamingExecutor

    n = 48
    yy, xx = np.mgrid[:n, :n]
    blob = np.exp(-((xx - n / 2) ** 2 + (yy - n / 2) ** 2) / (2 * (n / 8) ** 2))
    input_map = ProjectionMap(data=(2e-3 * blob).astype(np.float32)[None, None, None], center=(150.0, 41.0),
                              width=0.2, frame="az/el", units="K_RJ", degrees=True)
    plan = maria_torch.get_plan("daisy_5arcmin_60s", start_time=1.75e9, scan_center=(150.0, 41.0), frame="az/el",
                                duration=duration, sample_rate=20.0)
    sim = maria_torch.Simulation(instrument="MUSTANG-2", plans=plan, site="GBT", atmosphere="2d", noise=True,
                                 seed=11, device=device)
    obs = sim.obs_list[0]
    program = build_tod_program(obs, noise_kwargs=sim.noise_kwargs, device=device)
    ex = StreamingExecutor(program, obs, block_tc=16, n_x=n, n_y=n, res=np.radians(0.2) / n, input_map=input_map,
                           device=device)
    return ex, obs, blob


def blob_recovery(m, hits, blob):
    mask = hits > np.percentile(hits[hits > 0], 60)
    a, b = m[mask] - m[mask].mean(), blob[mask] - blob[mask].mean()
    return float((a * b).sum() / np.sqrt((a**2).sum() * (b**2).sum() + 1e-30))


def run_streamed_ml(device, card):
    """Slice (v): the streamed ML mapper on tests/test_streaming_ml.py's
    scene, fit(n_epochs=2, n_cg_iters=25). At 600 s: the fit's warm time,
    a CG step, K2's launches and the recovery of the blob, recorded. At
    the reference test's own 30 s, the gates: recovery above 0.8 and no
    worse than the naive map's less 0.02, and the fit with K2 as P^T
    against the same fit with the plain P^T within 2e-3 of the map's
    maximum. (Past ~60 s this model's fit no longer recovers the blob, in
    maria_tpu as in the port: PERF.md, PR 14.) At 60 s the batch
    MaximumLikelihoodMapper on the same TOD, the weighted RMS of the two
    maps' difference recorded."""
    import torch

    from maria_torch.mappers import StreamingMLMapper
    from maria_torch.mappers.ml_mapper import MaximumLikelihoodMapper
    from maria_torch.ops.bin_map import bin_map_plain
    from maria_torch.tod import TOD, Pointing

    s = time.perf_counter()
    ex, obs, blob = streamed_ml_scene(device, STREAM_SECONDS)
    setup_s = time.perf_counter() - s
    mapper = StreamingMLMapper(ex, n_epochs=2, n_cg_iters=25)
    reset_stream_launches()
    m = mapper.fit(4)
    launches = stream_launches()
    corr, corr_naive = blob_recovery(m, mapper.hits, blob), blob_recovery(mapper.naive_map, mapper.hits, blob)
    warm, each = warm_ms(lambda: StreamingMLMapper(ex, n_epochs=2, n_cg_iters=25).fit(4), reps=3)
    A_inv = torch.ones((ex.n_det, ex.B // 2 + 1), device=device)
    x = torch.randn(ex.n_x * ex.n_y, device=device)
    step_ms = cuda_ms(lambda: mapper._apply_A(x, A_inv), reps=5)
    ok = np.isfinite(m).all() and launches["bin_map"] > 0 and launches["pink_cascade"] > 0 and mapper.resident
    print(f"slice (v) streamed ML, MUSTANG-2 {STREAM_SECONDS:.0f} s at 20 Hz ({ex.n_det} x {ex.n_t}, {ex.n_blocks} "
          f"blocks of {ex.B}) on 48 x 48 over 0.2 deg: setup {setup_s:.2f} s; fit(2 x 25) warm {warm:.1f} ms ({each}); "
          f"a CG step (P^T N^-1 P over every block) {step_ms:.3f} ms; main-path launches of the first fit "
          f"{launches}; a finite map, recovery {corr:.4f} (naive {corr_naive:.4f}; recorded) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail("slice (v) streamed ML at 600 s")
    r = check_ml_stream_pt(mapper, card)
    kc = check_pink_cascade(device, torch.Generator(device=device), ex, "v")

    ex30, _, _ = streamed_ml_scene(device, ML_GATE_SECONDS)
    m30 = StreamingMLMapper(ex30, n_epochs=2, n_cg_iters=25)
    m_k2 = m30.fit(4)
    corr30, naive30 = blob_recovery(m_k2, m30.hits, blob), blob_recovery(m30.naive_map, m30.hits, blob)
    plains = []
    for _ in range(2):  # twice: index_add_ sums with atomics too, so two plain fits differ
        plain = StreamingMLMapper(ex30, n_epochs=2, n_cg_iters=25)
        plain._project_T = lambda channels, ids, n_pix=plain.n_pix: bin_map_plain(channels.contiguous(), ids, n_pix)
        plains.append(plain.fit(4))
    # the better-covered pixels (recovery's mask): a map-edge pixel of a
    # few hits is ill-conditioned, and there the float32 sums' order alone
    # moves two identical fits by up to 14% of the map's maximum (card
    # runs of PR 14)
    well = m30.hits > np.percentile(m30.hits[m30.hits > 0], 60)
    scale = float(np.abs(plains[0][well]).max())
    diff = float(np.abs(m_k2 - plains[0])[well].max()) / scale
    spread = float(np.abs(plains[1] - plains[0])[well].max()) / scale
    diff_all = float(np.abs(m_k2 - plains[0]).max()) / float(np.abs(plains[0]).max())
    spread_all = float(np.abs(plains[1] - plains[0]).max()) / float(np.abs(plains[0]).max())
    ok = np.isfinite(m_k2).all() and corr30 > 0.8 and corr30 > naive30 - 0.02 and diff <= max(2e-3, 2 * spread)
    print(f"slice (v) at {ML_GATE_SECONDS:.0f} s (tests/test_streaming_ml.py's scene as written): recovery "
          f"{corr30:.4f} (naive {naive30:.4f}; limits 0.8 and naive - 0.02); over the better-covered pixels the fit "
          f"through K2 against the plain P^T's {diff:.3e} of the map's maximum there (limit 2e-3, or twice the "
          f"spread of two plain fits, {spread:.3e}); over every pixel {diff_all:.3e}, two plain fits {spread_all:.3e} "
          f"(printed) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (v) streamed ML gates")

    ex60, obs60, _ = streamed_ml_scene(device, STREAM_CHECK_SECONDS)
    m60 = StreamingMLMapper(ex60, n_epochs=2, n_cg_iters=25)
    m_stream = m60.fit(4)
    tod = torch.cat([blk for _, blk in ex60.tod_blocks(4)], dim=-1)
    tod_obj = TOD(data={"total": tod}, pointing=Pointing(obs60.boresight, obs60.offsets, obs60.q), units="pW",
                  dets=obs60.instrument.dets)
    center = tuple(np.degrees(ex60.center))
    batch = MaximumLikelihoodMapper([tod_obj], center=center, width=0.2, height=0.2, resolution=0.2 / 48,
                                    frame="az/el", units="pW", n_epochs=2, n_cg_iters=25).fit()
    b_map = batch.data[0, 0, 0].double().cpu().numpy()
    wrms = float("nan")
    if b_map.shape == m_stream.shape:
        covered = (m60.hits > 0) & (batch.weight[0, 0, 0].cpu().numpy() > 0)
        w = m60.hits[covered]
        b = b_map[covered] - b_map[covered].mean()
        d = (m_stream[covered] - m_stream[covered].mean()) - b
        wrms = float(np.sqrt((w * d**2).sum() / (w * b**2).sum()))
    print(f"slice (v) at {STREAM_CHECK_SECONDS:.0f} s: the streamed ML map against the batch MaximumLikelihoodMapper "
          f"on the same TOD ({tuple(tod.shape)}; maps {m_stream.shape} and {b_map.shape}): weighted RMS of the "
          f"difference over covered pixels {wrms:.4f} of the batch map's weighted RMS (recorded, not gated)", flush=True)
    return r, kc, launches, {"setup_s": setup_s, "fit_warm_ms": warm, "fit_each_ms": each, "cg_step_ms": step_ms,
                         "recovery_600s": corr, "recovery_naive_600s": corr_naive, "recovery_30s": corr30,
                         "recovery_naive_30s": naive30, "k2_vs_plain_30s": diff, "plain_spread_30s": spread,
                         "k2_vs_plain_all_30s": diff_all, "plain_spread_all_30s": spread_all,
                         "batch_wrms_60s": wrms}


def check_ml_stream_pt(mapper, card):
    """K2 as the streamed ML's P^T at one block's ids against its float64
    plain sums, timed beside index_add_ and the byte bound."""
    import torch

    from maria_torch.ops.bin_map import bin_map, bin_map_plain

    ex = mapper.ex
    ids = mapper._block_ids(0)
    v = torch.randn((1, ex.n_det, ex.B), device=ids.device)
    out = bin_map(v, ids, mapper.n_pix)[0]
    exact = plain_sums64(v[0], ids, mapper.n_pix)
    err = float((out.double() - exact).abs().max()) / float(exact.abs().max())
    keep = (ids >= 0).reshape(-1)
    ids_k, v_k = ids.reshape(-1)[keep].long(), v.reshape(1, -1)[:, keep]
    lib = torch.zeros((1, mapper.n_pix), device=ids.device)
    ms, plain_ms, library_ms = paired_ms(lambda: bin_map_plain(v, ids, mapper.n_pix),
                                         lambda: bin_map(v, ids, mapper.n_pix),
                                         lambda: lib.zero_().index_add_(1, ids_k, v_k))
    n = ids.numel()
    r = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
         "shape": [1, ex.n_det, ex.B, mapper.n_pix], **bound(8.0 * n + 4.0 * mapper.n_pix, n)}
    ok = err <= 1e-5
    print(timing_line(f"K2 as the streamed ML P^T (slice v, one block: 1 x {ex.n_det} x {ex.B} into {mapper.n_pix}; "
                      f"error {err:.2e} of the float64 sums' max, limit 1e-5)", r), flush=True)
    if not ok:
        fail("K2 as the streamed ML P^T")
    return r


def check_stream_k2(device, gen, ex, label):
    """K2 at a streaming block's ids and shape (the sums and the count) of
    executor ``ex``."""
    ids = ex.pixel_ids(min(1, ex.n_blocks - 1))
    return check_bin_map(device, gen, ids, f"slice {label} streaming block ids ({ex.n_det} x {ex.B})",
                         n_pix=ex.n_x * ex.n_y)


def check_ar_chunk(device, gen, proc, chunk_rows):
    """The AR kernel as a streamed chunk runs it (``chunk_rows`` steps on a
    buffer of chunk_rows + n_extrusion rows, one launch) against its plain
    loop on the same draws (1e-4 of the chunk's std), timed beside
    ``ar_bound`` at those steps."""
    import torch

    from maria_torch.ops.ar_extrude import ar_extrude, ar_extrude_reference, ar_plan, probe_latencies

    plan = ar_plan([proc], device, steps=[chunk_rows])
    buffer = torch.randn((chunk_rows + proc.n_extrusion, proc.n_cross_section), generator=gen, device=device)
    noise = torch.randn((chunk_rows, proc.n_cross_section), generator=gen, device=device)
    t = proc.tensors(device)

    def kernel():
        return ar_extrude([proc], [buffer], [noise], plan=plan, steps=[chunk_rows], rows=chunk_rows)[0]

    def plain():
        return ar_extrude_reference(t["A"], t["B"], buffer, t["ext_idx"], t["cross_idx"], noise)[:chunk_rows]

    out, ref = kernel(), plain()
    rel = float((out - ref).abs().max()) / float(ref.std())
    ok = rel <= 1e-4 and bool(torch.isfinite(out).all())
    name = (f"AR ar_extrude (slice u: a streamed chunk of (g)'s process, {chunk_rows} steps on {chunk_rows} + "
            f"{proc.n_extrusion} rows, clusters of {plan['groups'][0]['cluster']})")
    print(f"{name}: max|diff| {rel:.2e} of the chunk's std (limit 1e-4) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("the AR kernel's chunk disagrees with its plain loop")
    p1, k1 = cuda_ms(plain, reps=2), cuda_ms(kernel)
    k2, p2 = cuda_ms(kernel), cuda_ms(plain, reps=2)
    group = plan["groups"][0]
    lat = probe_latencies(device, cluster=group["cluster"], threads=group["threads"])
    r = {"max_abs_err": rel * float(ref.std()), "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": None,
         "shape": [proc.n_extrusion, proc.n_cross_section, proc.n_sample, chunk_rows], "steps": chunk_rows,
         **ar_bound([proc], lat, steps=[chunk_rows])}
    print(timing_line(f"{name} ({r['ms'] * 1e3 / chunk_rows:.3f} us a step; no library call)", r), flush=True)
    return r


W_START = 1.75e9  # the Planner's start: June 2025, the Sun far from (150.5, -29.5) deg
W_PREPROCESSING = {"remove_modes": {"modes_to_remove": 1},
                   "remove_spline": {"knot_spacing": 60, "remove_el_gradient": True}}  # docs/tutorials.md:117-118
W_WINDOWS = (dict(window="tukey", taper=0.1), dict(window="hann"), dict(window=False))  # docs/tutorials.md:125


def transfer_tutorial_sim(duration=360.0, atmosphere="2d", noise=True):
    """docs/tutorials.md:94-115 as written (the Planner given a start
    time): the cluster2 product fetched, loaded at 150 and 270 GHz 20
    arcmin wide and joined along nu; TolTEC's array-1 and array-3 (5,184
    detectors); the Planner at llano_de_chajnantor above 60 deg, a
    ``duration`` s daisy of 6.5 arcmin at its 20 Hz; the Simulation on
    the card, the default. Returns (maps, sim)."""
    import maria_torch as maria
    from maria_torch.instrument import Instrument, get_instrument_config

    p = maria.io.fetch("maps/cluster2.fits")
    m1 = maria.map.load(filename=p, nu=150e9, width=20 / 60)
    m2 = maria.map.load(filename=p, nu=270e9, width=20 / 60)
    maps = maria.map.concatenate([m1, m2], dim="nu")
    config = get_instrument_config("TolTEC")
    config["arrays"] = {k: config["arrays"][k] for k in ["array-1", "array-3"]}
    instrument = Instrument.from_config(config)
    plans = maria.Planner(target=maps, site="llano_de_chajnantor", constraints={"el": (60, 90)},
                          start_time=W_START).generate_plans(
        total_duration=duration, scan_options={"radius": 6.5 / 60, "miss_factor": 0.3})
    return maps, maria.Simulation(instrument, plans=plans, site="llano_de_chajnantor", map=maps,
                                  atmosphere=atmosphere, noise=noise)


def transfer_tutorial_map(tods, maps):
    """docs/tutorials.md:116-120: the BinMapper in uK_RJ, Stokes I, at the
    input maps' resolution, after one mode and a 60 s spline with the
    elevation gradient are removed."""
    import copy

    from maria_torch.mappers import BinMapper

    return BinMapper(tods=tods, units="uK_RJ", stokes="I", resolution=maps.resolution,
                     tod_preprocessing=copy.deepcopy(W_PREPROCESSING)).run()


def transfer_function_float64(d_in, d_out, w_out, y_res, x_res, window="hann", taper=0.1, n_bins=20,
                              pad_factor=1.0):
    """maria_tpu/map/transfer.py's estimator on one plane in float64 numpy
    on the host: (bin centres, tf) of the non-empty bins."""
    import scipy.signal

    window = "hann" if window is True else "boxcar" if window in (False, None) else window
    d_in, d_out = np.asarray(d_in, dtype=float), np.nan_to_num(np.asarray(d_out, dtype=float))
    ny, nx = d_in.shape
    spec = (window, taper) if window == "tukey" else window
    valid = np.asarray(w_out) > 0
    w2d = np.outer(scipy.signal.get_window(spec, ny), scipy.signal.get_window(spec, nx)) * valid
    d_in = (d_in - d_in[valid].mean() if valid.any() else d_in) * w2d
    d_out = d_out * w2d
    if pad_factor > 1:
        py, px = int(ny * (pad_factor - 1) / 2), int(nx * (pad_factor - 1) / 2)
        d_in, d_out = np.pad(d_in, ((py, py), (px, px))), np.pad(d_out, ((py, py), (px, px)))
        ny, nx = d_in.shape
    F_in, F_out = np.fft.rfft2(d_in), np.fft.rfft2(d_out)
    k = np.sqrt(np.fft.fftfreq(ny, d=y_res)[:, None] ** 2 + np.fft.rfftfreq(nx, d=x_res)[None, :] ** 2)
    cross, auto = np.real(np.conj(F_in) * F_out).ravel(), (np.abs(F_in) ** 2).ravel()
    bins = np.geomspace(k[k > 0].min(), k.max(), n_bins + 1)
    idx = np.digitize(k.ravel(), bins) - 1
    tf = np.full(n_bins, np.nan)
    for i in range(n_bins):
        denom = auto[idx == i].sum()
        if denom > 0:
            tf[i] = cross[idx == i].sum() / denom
    good = np.isfinite(tf)
    return np.sqrt(bins[:-1] * bins[1:])[good], tf[good]


def bilinear_float64(field, x, y, x_side, y_side):
    """The bilinear sample of a (ny, nx) field on the uniform grid of
    pixel centres (x_side, y_side) at the points (x, y), in float64 numpy;
    zero beyond the outermost centres (ops.interp.interp_bilinear_grid's
    contract)."""
    field, x, y = np.asarray(field, dtype=float), np.asarray(x, dtype=float), np.asarray(y, dtype=float)
    ny, nx = field.shape
    fx = (x - x_side[0]) / (x_side[1] - x_side[0])
    fy = (y - y_side[0]) / (y_side[1] - y_side[0])
    ix, iy = np.clip(np.floor(fx).astype(int), 0, nx - 2), np.clip(np.floor(fy).astype(int), 0, ny - 2)
    wx, wy = fx - ix, fy - iy
    out = (field[iy, ix] * (1 - wy) * (1 - wx) + field[iy, ix + 1] * (1 - wy) * wx
           + field[iy + 1, ix] * wy * (1 - wx) + field[iy + 1, ix + 1] * wy * wx)
    inside = (x >= x_side[0]) & (x <= x_side[-1]) & (y >= y_side[0]) & (y <= y_side[-1])
    return np.where(inside, out, 0.0)


def check_sampled_onto(maps, out_map, device):
    """maps.sampled_onto(out_map) on the card against a float64 bilinear
    gather on the host at the card's own float32 offsets (the output's
    pixel centres carried through the sphere onto the input's centre, as
    sampled_onto carries them): within 1e-5 of the map's maximum."""
    import torch

    from maria_torch.coords import offsets_to_phi_theta, phi_theta_to_offsets

    on_card = maps.sampled_onto(out_map, device=device)
    torch.cuda.synchronize()
    X, Y = np.meshgrid(out_map.x_side, out_map.y_side)
    pts = np.stack([X, Y], axis=-1)
    if not np.allclose(maps.center, out_map.center):
        pts = phi_theta_to_offsets(offsets_to_phi_theta(pts, *out_map.center), *maps.center)
    dx, dy = (np.asarray(pts[..., i], dtype=np.float32) for i in (0, 1))
    data = maps.data.cpu().numpy()
    ref = np.stack([bilinear_float64(data[0, j, 0], dx, dy, maps.x_side, maps.y_side) for j in range(maps.n_nu)])
    scale = float(np.abs(data).max())
    err = float(np.abs(on_card[0, :, 0].cpu().numpy() - ref).max())
    ok = on_card.device.type == "cuda" and tuple(on_card.shape) == (1, maps.n_nu, 1, out_map.n_y, out_map.n_x)
    ok &= err <= 1e-5 * scale
    print(f"slice (w): sampled_onto of the input maps onto the output's {out_map.n_y} x {out_map.n_x} grid on the card "
          f"against a float64 gather at its own offsets: {err / scale:.3e} of the map's maximum (limit 1e-5) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (w) sampled_onto")
    return on_card


def check_transfer_on_card(maps, output_map, device):
    """The output map and its transfer functions on the card (the
    tutorial's window=True over both channels and its three windows on
    the first): each channel's curve against transfer_function_float64 of
    the same two maps (the input sampled onto the output's grid on the
    card, in its units) on the host, the same bins and tf to 1e-6
    relative in every bin. Returns (the card's map, its warm ms)."""
    import torch

    card_out = output_map._replace(data=output_map.data.to(device), weight=output_map.weight.to(device))
    card_out._input_map, card_out._beam_fwhm = output_map._input_map, output_map._beam_fwhm
    sampled = check_sampled_onto(maps, card_out, device)
    aligned = card_out._replace(data=sampled, weight=torch.ones_like(sampled), stokes=maps.stokes, nu=maps.nu,
                                units=maps.units).to(card_out.units)
    d_in, d_out, w_out = (x.cpu().numpy() for x in (aligned.data, card_out.data, card_out.weight))
    worst, n_curves = 0.0, 0
    for kw in (dict(window=True),) + W_WINDOWS:
        slices = None if kw.get("window") is True else dict(nu=[0])
        tf = card_out.transfer_function(slices=slices, **kw)
        torch.cuda.synchronize()
        for i, j in enumerate([0, 1] if slices is None else [0]):
            k64, tf64 = transfer_function_float64(d_in[0, j, 0], d_out[0, j, 0], w_out[0, j, 0], card_out.y_res,
                                                  card_out.x_res, window=kw["window"], taper=kw.get("taper", 0.1))
            same_bins = len(k64) == len(tf.k) and np.allclose(k64, tf.k, rtol=1e-12)
            rel = float(np.abs(tf.T[i] / tf64 - 1).max()) if same_bins else np.inf
            worst, n_curves = max(worst, rel), n_curves + 1
            if not same_bins or rel > 1e-6:
                print(f"slice (w): transfer function {kw} channel {j}: bins {len(tf.k)} / {len(k64)}, worst relative "
                      f"difference {rel:.3e} FAIL", flush=True)
                fail("slice (w) transfer function on the card")
    ms, each = warm_ms(lambda: card_out.transfer_function(window=True), reps=3)
    print(f"slice (w): the transfer functions on the card (window=True on both channels, the tutorial's three windows "
          f"on the first: {n_curves} curves) against float64 numpy on the host: the same bins, worst relative "
          f"difference {worst:.3e} (limit 1e-6) ok; warm transfer_function(window=True) {ms:.2f} ms ({each})",
          flush=True)
    return card_out, ms


def run_transfer_tutorial(device, card, gen):
    """Slice (w): docs/tutorials.md:94-127 on the card. Returns (main-path
    launches, K1 and K2 records at its shapes, summary)."""
    import copy

    import torch

    import maria_torch
    from maria_torch.atmosphere.fourier import good_fft_size
    from maria_torch.mappers.bin_mapper import radec_pixel_ids
    from maria_torch.ops.bin_map import bin_map
    from maria_torch.ops.pink_noise import pink_noise

    old_cache = maria_torch.io._cache_state["base"]
    with tempfile.TemporaryDirectory() as cache:
        maria_torch.set_cache_dir(cache)
        try:
            s = time.perf_counter()
            maps, sim = transfer_tutorial_sim()
            setup_s = time.perf_counter() - s
            pink_noise.launches = bin_map.launches = 0
            torch.cuda.reset_peak_memory_stats()
            s = time.perf_counter()
            tods = sim.run()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - s
            run_peak = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            s = time.perf_counter()
            output_map = transfer_tutorial_map(tods, maps)
            torch.cuda.synchronize()
            map_s = time.perf_counter() - s
            map_peak = torch.cuda.max_memory_allocated() / 1e9
            launches = {"pink_noise": pink_noise.launches, "bin_map": bin_map.launches}
            s = time.perf_counter()
            tf = output_map.transfer_function(window=True)  # on the mapper's map, which lives on the host
            host_tf_ms = (time.perf_counter() - s) * 1e3
            windows = [output_map.transfer_function(slices=dict(nu=[0]), **kw) for kw in W_WINDOWS]
            path = os.path.join(cache, "output.fits")
            output_map.to_fits(path)
            back = maria_torch.map.load(path)
            # printed, not held: the same map without atmosphere and noise
            clean = transfer_tutorial_map(transfer_tutorial_sim(atmosphere=None, noise=False)[1].run(), maps)
        finally:
            maria_torch.set_cache_dir(old_cache)

    tod = tods[0]
    n_t = 360 * 20  # the tutorial's 360 s at the Planner's 20 Hz
    ok = len(tods) == 1 and tod.shape == (5184, n_t) and tod.device.type == "cuda"
    ok &= set(tod.fields) == {"atmosphere", "map", "noise"} and all(bool(torch.isfinite(v).all()) for v in tod.data.values())
    ok &= launches["pink_noise"] > 0 and launches["bin_map"] > 0
    ok &= tuple(output_map.data.shape[:3]) == (1, 2, 1) and bool(torch.isfinite(output_map.data).all())
    ok &= float(output_map.weight.sum()) > 0 and output_map.units == "uK_RJ"
    ok &= tf.T.shape[0] == 2 and bool(np.isfinite(tf.T).all()) and all(w.T.shape[0] == 1 for w in windows)
    print(f"slice (w), the transfer-function tutorial: TolTEC {tod.shape} ({', '.join(tod.dets.bands.names)}) "
          f"{tod.fields}, setup {setup_s:.2f} s, first run() {run_s:.3f} s, first BinMapper.run() {map_s:.3f} s, "
          f"output map {tuple(output_map.data.shape)} at {output_map.resolution.arcsec:.2f} arcsec; main-path "
          f"launches {launches} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (w) output check")
    same = bool(torch.equal(back.data, output_map.data)) and np.array_equal(back.nu, output_map.nu)
    print(f"slice (w): output_map.to_fits and map.load: equal element for element {same} "
          f"{'ok' if same else 'FAIL'}", flush=True)
    if not same:
        fail("slice (w) FITS round trip")

    card_out, card_tf_ms = check_transfer_on_card(maps, output_map, device)

    # what is printed, not held: the curves between the beams and the map's width, beside the run without
    # atmosphere and noise
    tf_clean = clean.transfer_function(window=True)
    width = float(output_map.width.rad)
    for name, curve in (("atmosphere and noise", tf), ("no atmosphere, no noise", tf_clean)):
        sel = (1 / curve.k > min(curve.beam_fwhm)) & (1 / curve.k < width)
        print(f"slice (w), transfer function ({name}) at angular scales 1/k between the beams "
              f"{np.round(np.degrees(curve.beam_fwhm) * 3600, 2).tolist()} arcsec and the map's width "
              f"{np.degrees(width) * 60:.2f} arcmin: scales {np.round(np.degrees(1 / curve.k[sel]) * 60, 3).tolist()} "
              f"arcmin, T {np.round(curve.T[:, sel], 4).tolist()}", flush=True)

    run_ms, run_each = warm_ms(lambda: sim.run(), reps=3)
    map_ms, map_each = warm_ms(lambda: transfer_tutorial_map(tods, maps), reps=3)
    ops_ms = {op: warm_ms(lambda op=op: tod.process(**copy.deepcopy({op: W_PREPROCESSING[op]})), reps=3)[0]
              for op in W_PREPROCESSING}
    bands = tod.dets.bands
    rows = [np.where(tod.dets.band_name == b.name)[0] for b in bands]
    big = int(np.argmax([len(r) for r in rows]))
    k1 = check_pink_noise(device, gen, len(rows[big]), n_t, good_fft_size(n_t))
    mapper_res = card_out.x_res
    ids = radec_pixel_ids(tod.pointing, card_out.center, mapper_res, card_out.n_x, card_out.n_y, device=device)
    ids = ids[torch.as_tensor(rows[big], device=device)].contiguous()
    k2 = check_bin_map(device, gen, ids, f"slice w ra/dec ids, band {bands[big].name}",
                       n_pix=card_out.n_x * card_out.n_y)["stacked"]
    summary = {"shape": list(tod.shape), "setup_s": setup_s, "run_ms": run_ms, "run_each_ms": run_each,
               "map_ms": map_ms, "map_each_ms": map_each, "preprocessing_ms": ops_ms, "tf_card_ms": card_tf_ms,
               "tf_host_ms": host_tf_ms,
               "run_peak_gb": run_peak, "map_peak_gb": map_peak, "launches": launches,
               "map_shape": list(output_map.data.shape), "k1_shape": k1["shape"], "k2_shape": k2["shape"]}
    print(f"slice (w): warm run() {run_ms:.2f} ms ({run_each}), warm BinMapper.run() {map_ms:.2f} ms ({map_each}; "
          f"its preprocessing alone, an op at a time on the TOD: {({k: round(v, 2) for k, v in ops_ms.items()})} ms), "
          f"transfer_function on the card {card_tf_ms:.2f} ms and on the host's map {host_tf_ms:.2f} ms; peak device "
          f"memory run() {run_peak:.2f} GB, BinMapper {map_peak:.2f} GB ({card})", flush=True)
    return launches, k1, k2, summary


def run_mustang_fits(device, card, tod):
    """Slice (x): slice (a)'s TOD through a MUSTANG-2 FITS file and back,
    then BinMapper(frame="ra/dec") on the reloaded TOD. Returns (main-path
    launches, summary)."""
    import torch

    import maria_torch
    from maria_torch.io.fits import read_fits
    from maria_torch.ops.bin_map import bin_map

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "slice_a.fits")
        torch.cuda.synchronize()
        s = time.perf_counter()
        tod.to_fits(path, format="MUSTANG-2")
        write_s = time.perf_counter() - s
        s = time.perf_counter()
        back = maria_torch.tod.load(path)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - s
        size_mb = os.path.getsize(path) / 1e6
        _, table = read_fits(path)[1]
    n_det, n_t = tod.shape
    fnu_equal = back.device.type == "cuda" and bool(torch.equal(back.signal, tod.to("K_RJ").signal))
    ra, dec = tod.pointing.det_radec(device=device)
    dx_err = max(float(np.abs(table[c].reshape(n_det, n_t) - x.cpu().numpy()).max()) for c, x in (("DX", ra), ("DY", dec)))
    ok = fnu_equal and dx_err <= 2e-6 and back.shape == tod.shape
    print(f"slice (x): slice (a)'s TOD {tod.shape} to MUSTANG-2 FITS ({size_mb:.1f} MB) in {write_s:.3f} s, read back "
          f"by maria_torch.tod.load in {read_s:.3f} s: FNU equal to the K_RJ signal bit for bit {fnu_equal}; DX/DY "
          f"against det_radec in float32 {dx_err:.3e} rad (limit 2e-6) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (x) FITS round trip")

    center = tuple(np.degrees(tod.boresight.center(frame="ra/dec")))
    kw = dict(center=center, width=0.5, resolution=MAP_WIDTH_DEG / N_MAP, frame="ra/dec",
              map_postprocessing={"keep_mean": True})
    original = maria_torch.BinMapper(tod, **kw).run()
    bin_map.launches = 0
    reloaded = maria_torch.BinMapper(back, **kw).run()
    launches = {"bin_map": bin_map.launches}
    hits = [float(m.weight.double().sum()) for m in (original, reloaded)]
    sums = [float((m.data.double() * m.weight.double()).sum()) for m in (original, reloaded)]
    scale = float((original.data.double() * original.weight.double()).abs().sum())
    both = (original.weight > 0) & (reloaded.weight > 0)
    corr = float(np.corrcoef(original.data[both].numpy(), reloaded.data[both].numpy())[0, 1])
    ok = launches["bin_map"] > 0 and hits[0] == hits[1] == n_det * n_t and abs(sums[0] - sums[1]) <= 1e-5 * scale
    print(f"slice (x): BinMapper(frame='ra/dec') on the reloaded TOD ({tuple(reloaded.data.shape)}): total hits "
          f"{hits[1]:.0f} against the in-memory TOD's {hits[0]:.0f} (n_det x n_t {n_det * n_t}), summed signal "
          f"{sums[1]:.6e} against {sums[0]:.6e} ({abs(sums[0] - sums[1]) / scale:.2e} of the summed |signal|, limit "
          f"1e-5); the maps' correlation over {int(both.sum())} pixels hit in both {corr:.5f} (printed: maria_tpu's "
          f"reader rebuilds the offsets from the first sample, so pixels may move); main-path launches {launches} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (x) map of the reloaded TOD")
    return launches, {"write_s": write_s, "read_s": read_s, "file_mb": size_mb, "shape": list(tod.shape),
                      "correlation": corr, "launches": launches}


def check_inference_mode_block(program, obs, device):
    """F1 on the card: slice (u)'s block 1 with a fresh executor and no
    cached split tables, inside torch.inference_mode and outside: KC
    launched; the TOD and every state entry equal bit for bit but the
    map's sums, which K2's float atomics add in any order (within 1e-6
    of their maximum)."""
    import torch

    from maria_torch.ops import pink_cascade as kc
    from maria_torch.ops.streaming_exec import StreamingExecutor

    def block():
        kc._SPLIT_TABLES.clear()
        ex = StreamingExecutor(program, obs, block_tc=64, device=device)
        return ex.block(ex.init_state(3), 1), kc.cascade_plan(ex._casc_rows["n"], ex.B)

    (state_out, tod_out), plan = block()
    with torch.inference_mode():
        before = kc.pink_cascade.launches
        (state_in, tod_in), _ = block()
        launched = kc.pink_cascade.launches - before
    entries = {"tod": (tod_out, tod_in), **{k: (state_out[k], state_in[k]) for k in state_out if k != "map_sum"}}
    unequal = []
    for name, (a, b) in entries.items():
        flat_a, flat_b = (torch.utils._pytree.tree_flatten(x)[0] for x in (a, b))
        if len(flat_a) != len(flat_b) or not all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                                                 for x, y in zip(flat_a, flat_b)):
            unequal.append(name)
    map_err = float((state_out["map_sum"] - state_in["map_sum"]).abs().max() / state_out["map_sum"].abs().max())
    ok = not unequal and map_err <= 1e-6 and launched == 1
    print(f"slice (u): block 1 inside torch.inference_mode (a fresh executor, KC's split G {plan[0]}, S {plan[1]}, no "
          f"cached tables): KC launched {launched}; the TOD and the state's {sorted(k for k in entries if k != 'tod')} "
          f"equal to the block outside bit for bit {not unequal}{f' (not: {unequal})' if unequal else ''}, the map's "
          f"sums within {map_err:.2e} of their maximum (limit 1e-6: K2's atomics) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("slice (u) under inference_mode")


# -- phase (y): the (det, time) mesh on torch.distributed --------------------------------------------------------

MESH_WORLD = 2  # ranks of the gloo world that shares the one card
MESH_SEED = 17
MESH_JOIN_S = 600.0  # the world's join timeout, past which its ranks are killed
MESH_CHUNK_ROWS = 128  # (y5)'s AR chunk, as (u)'s
MESH_STREAM_SECONDS = 600.0  # (y4): (u)'s scene at 600 s
MESH_REPS = 3  # warm repetitions a timing


def seeded(device, seed=MESH_SEED):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def tod_arrays(tod) -> dict:
    """The arguments of maria_torch.convert.tod_from_arrays that rebuild
    ``tod`` in another process (numpy, band names, the signal alone)."""
    from maria_torch.convert import ARRAY_COLUMNS

    b = tod.pointing.boresight
    loc = b.earth_location
    return dict(data={"signal": tod.signal.cpu().numpy()}, weight=tod.weight.cpu().numpy(), phi=b._phi,
                theta=b._theta, t=b.t, offsets=tod.pointing.offsets, q=tod.pointing.q,
                columns={k: tod.dets.dets[k] for k in ARRAY_COLUMNS}, bands=[band.name for band in tod.dets.bands],
                frame=b.frame.name, earth_location=(loc.lat_deg, loc.lon_deg, loc.height_m), units=tod.units)


def mesh_stream_executor(device, duration=MESH_STREAM_SECONDS):
    """(u)'s streamed scene: MUSTANG-2 at the GBT, daisy_5arcmin_60s at 50 Hz,
    the 2-D atmosphere and noise, block_tc 64."""
    import maria_torch
    from maria_torch.ops.program import build_tod_program
    from maria_torch.ops.streaming_exec import StreamingExecutor

    plan = maria_torch.get_plan("daisy_5arcmin_60s", start_time=1.75e9, scan_center=(150.0, 41.0), frame="az/el",
                                duration=duration, sample_rate=50.0)
    sim = maria_torch.Simulation(instrument="MUSTANG-2", plans=plan, site="GBT", atmosphere="2d", noise=True, seed=0,
                                 device=device)
    program = build_tod_program(sim.obs_list[0], noise_kwargs=sim.noise_kwargs, device=device)
    return StreamingExecutor(program, sim.obs_list[0], block_tc=64, device=device)


def mesh_launches() -> dict:
    from maria_torch.ops.ar_extrude import ar_extrude
    from maria_torch.ops.bin_map import bin_map
    from maria_torch.ops.pink_cascade import pink_cascade
    from maria_torch.ops.pink_noise import pink_noise
    from maria_torch.ops.shared_v import shared_v

    return {"bin_map": bin_map.launches, "shared_v": shared_v.launches, "pink_cascade": pink_cascade.launches,
            "ar_extrude": ar_extrude.launches, "pink_noise": pink_noise.launches}


def reset_mesh_launches():
    from maria_torch.ops.ar_extrude import ar_extrude
    from maria_torch.ops.bin_map import bin_map
    from maria_torch.ops.pink_cascade import pink_cascade
    from maria_torch.ops.pink_noise import pink_noise
    from maria_torch.ops.shared_v import shared_v

    bin_map.launches = shared_v.launches = pink_cascade.launches = ar_extrude.launches = pink_noise.launches = 0


def device_sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mesh_warm_ms(mesh, fn, reps: int = MESH_REPS) -> tuple:
    """(mean ms, list of ms) of ``reps`` calls of ``fn`` on every rank, each
    started together (a barrier) and ended by a synchronize."""
    ms = []
    for _ in range(reps):
        mesh.barrier()
        device_sync(mesh.device)
        s = time.perf_counter()
        fn()
        device_sync(mesh.device)
        ms.append((time.perf_counter() - s) * 1e3)
    return float(np.mean(ms)), [round(x, 2) for x in ms]


def collective_ms(mesh, fn, reps: int = 10) -> float:
    """The median ms of ``reps`` calls of the collective ``fn``, timed as
    ``mesh_warm_ms`` times them."""
    return float(np.median(mesh_warm_ms(mesh, fn, reps)[1]))


def mesh_rank(rank, world, tmp, device):
    """One rank of (y)'s gloo world on ``device`` (the card): (y1)-(y5),
    their numbers to rank<i>.json. Any error ends the rank, and the run,
    non-zero."""
    sys.path.insert(0, HERE)
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    import maria_torch
    from maria_torch.ops import kernels

    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
        torch.cuda.set_device(device)
        kernels.load()
    maria_torch.set_cache_dir(os.path.join(tmp, f"cache{rank}"))
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank, world_size=world,
                            timeout=timedelta(seconds=300))
    try:
        out = mesh_rank_phases(device, tmp)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def mesh_rank_phases(device, tmp) -> dict:
    import pickle

    import torch

    from maria_torch.atmosphere.streaming import extrude_time_sharded
    from maria_torch.convert import ar_process_from_arrays, tod_from_arrays
    from maria_torch.mappers.ml_mapper import MaximumLikelihoodMapper
    from maria_torch.parallel import create_mesh
    from maria_torch.parallel.binning import bin_sharded
    from maria_torch.parallel.multihost import host_local_shard, process_detector_range
    from maria_torch.scenes import simulation

    det = create_mesh(axis_names=("det",), device=device)
    grid = create_mesh(device=device)
    ring = create_mesh(axis_names=("time",), device=device)
    out = {"rank": det.rank, "coords": list(grid.coords)}

    # (y1) the AtLAST-50k total, each rank its detector range
    s = time.perf_counter()
    sim = simulation("atlast", 60.0, device)
    program = sim.program()
    fn = program.total_power_fn()
    n_det, n_t = program.n_det, program.n_t
    start, stop = process_detector_range(n_det, det)
    ids = torch.as_tensor(np.array(np.load(os.path.join(tmp, "y1_ids.npy"), mmap_mode="r")[start:stop]), device=device)
    n_pix = N_MAP * N_MAP
    device_sync(device)
    setup_s = time.perf_counter() - s

    def y1():
        total = host_local_shard(det, (n_det, n_t), lambda index: fn(
            generator=seeded(device), device=device, rows=(index[0].start, index[0].stop)))
        return total, bin_sharded(total, ids, n_pix, det, count=True)

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    reset_mesh_launches()
    total, binned = y1()
    device_sync(device)
    launches = mesh_launches()
    peak = torch.cuda.max_memory_allocated(device) / 1e9 if cuda else float("nan")
    rows = np.load(os.path.join(tmp, "y1_total.npy"), mmap_mode="r")[start:stop]
    tod_err = float(np.abs(total.cpu().numpy() - rows).max() / rows.std())
    sums64 = np.load(os.path.join(tmp, "y1_sums64.npy"))
    hits_exact = bool(np.array_equal(binned[1].cpu().numpy(), np.load(os.path.join(tmp, "y1_hits.npy"))))
    sums_err = float(np.abs(binned[0].cpu().numpy().astype(np.float64) - sums64).max() / np.abs(sums64).max())
    del total, binned
    warm, each = mesh_warm_ms(det, y1)
    x = torch.zeros((2, n_pix), dtype=torch.float32, device=device)
    out["y1"] = {"rows": [start, stop], "setup_s": setup_s, "launches": launches, "peak_gb": peak,
                 "tod_err_std": tod_err, "hits_exact": hits_exact, "sums_err": sums_err, "warm_ms": warm,
                 "warm_each_ms": each, "all_reduce_ms": collective_ms(det, lambda: det.all_reduce(x)),
                 "all_reduce_bytes": x.numel() * 4, "n_local": stop - start}
    del sim, program, fn, ids

    # (y2) MUSTANG-2 (a): BinMapper.run(mesh) on the (det, time) grid
    with open(os.path.join(tmp, "y2_tod.pkl"), "rb") as f:
        tod = tod_from_arrays(**pickle.load(f), device=device)
    reset_mesh_launches()
    out_map = map_tod(tod, mesh=grid)
    device_sync(device)
    launches = mesh_launches()
    ref = np.load(os.path.join(tmp, "y2_map.npy"))
    data = out_map.data.cpu().numpy().astype(np.float64)
    # tests/test_mappers.py:144-148's tolerance: atol 1e-5 of the map's max, rtol 1e-4
    out["y2"] = {"launches": launches, "map_err": float(np.abs(data - ref).max() / np.abs(ref).max()),
                 "map_close": bool(np.allclose(data, ref, atol=1e-5 * np.abs(ref).max(), rtol=1e-4)),
                 "weight_err": float(np.abs(out_map.weight.cpu().numpy() - np.load(os.path.join(tmp, "y2_weight.npy"))).max()),
                 "warm_ms": mesh_warm_ms(grid, lambda: map_tod(tod, mesh=grid))[0]}

    # (y3) (n)'s scene: a k=3 ML fit, each rank its detector rows
    with open(os.path.join(tmp, "y3_tod.pkl"), "rb") as f:
        tod = tod_from_arrays(**pickle.load(f), device=device)
    reset_mesh_launches()
    mapper = MaximumLikelihoodMapper(tod, mesh=det, n_epochs=ML_EPOCHS, n_cg_iters=ML_CG_ITERS, k=ML_K, **ML_KW)
    fit = mapper.fit()
    device_sync(device)
    launches = mesh_launches()
    ref = np.load(os.path.join(tmp, "y3_map.npy"))
    v = torch.zeros(mapper.n_m, dtype=torch.float32, device=device)
    out["y3"] = {"launches": launches, "rows": [mapper.blocks[0]["row0"], mapper.blocks[0]["n_real"],
                                                mapper.blocks[0]["data"].shape[0]],
                 "map_err": float(np.abs(fit.data.cpu().numpy() - ref).max() / np.abs(ref).max()),
                 "warm_ms": mesh_warm_ms(det, mapper.fit)[0],
                 "all_reduce_ms": collective_ms(det, lambda: det.all_reduce(v)), "all_reduce_bytes": v.numel() * 4}
    del mapper, fit, tod

    # (y4) (u)'s MUSTANG-2 at 600 s, streamed over the det ranks
    ex = mesh_stream_executor(device)
    reset_mesh_launches()
    res = ex.run(MESH_SEED, group_size=16, mesh=det)
    device_sync(device)
    launches = mesh_launches()
    ref = np.load(os.path.join(tmp, "y4.npz"))
    out["y4"] = {"launches": launches, "n_blocks": ex.n_blocks,
                 "hits_exact": bool(np.array_equal(res.map_wgt, ref["map_wgt"])),
                 "hits": float(res.map_wgt.astype(np.float64).sum()), "n_real_samples": ex.n_real_det * ex.n_t,
                 "sums_close": bool(np.allclose(res.map_sum, ref["map_sum"], rtol=1e-5, atol=1e-3)),
                 "sums_err": float(np.abs(res.map_sum - ref["map_sum"]).max() / np.abs(ref["map_sum"]).max()),
                 "warm_ms": mesh_warm_ms(det, lambda: ex.run(MESH_SEED, group_size=16, mesh=det))[0]}
    del ex

    # (y5) (g)'s AR process, extruded a chunk a rank around the halo ring
    with open(os.path.join(tmp, "y5_process.pkl"), "rb") as f:
        proc = ar_process_from_arrays(*pickle.load(f))
    reset_mesh_launches()
    stream = extrude_time_sharded(proc, MESH_SEED, MESH_CHUNK_ROWS, ring)
    device_sync(device)
    launches = mesh_launches()
    ref = np.load(os.path.join(tmp, "y5_chunks.npy"))
    buf = torch.zeros((proc.n_extrusion, proc.n_cross_section), dtype=torch.float32, device=device)

    def ping():  # one halo hand-over each way
        if ring.axis_index("time") == 0:
            ring.send(buf, ring.neighbour("time", 1))
            ring.recv(buf, ring.neighbour("time", 1))
        else:
            ring.recv(buf, ring.neighbour("time", -1))
            ring.send(buf, ring.neighbour("time", -1))

    out["y5"] = {"launches": launches, "shape": list(stream.shape),
                 "bit_equal": bool(np.array_equal(stream.cpu().numpy(), ref)),
                 "largest_diff_std": float(np.abs(stream.cpu().numpy() - ref).max() / ref.std()),
                 "send_recv_ms": collective_ms(ring, ping) / 2, "send_recv_bytes": buf.numel() * 4}
    del stream, proc, buf

    # (y6) slice (a)'s MUSTANG-2 program: each rank's rows of every field, the noise through K1
    program = simulation("mustang2", 60.0, device).program()
    start, stop = process_detector_range(program.n_det, det)

    def y6():
        return program.fields(generator=seeded(device), device=device, rows=(start, stop))[0]

    reset_mesh_launches()
    fields = y6()
    device_sync(device)
    launches = mesh_launches()
    ref = np.load(os.path.join(tmp, "y6_fields.npz"))
    err = {}
    for name, v in fields.items():
        rows = ref[name][start:stop]
        err[name] = float(np.abs(v.cpu().numpy() - rows).max() / rows.std())
    out["y6"] = {"rows": [start, stop], "launches": launches, "err_std": err, "fields": sorted(fields),
                 "warm_ms": mesh_warm_ms(det, y6)[0]}
    return out


def run_mesh(device, card, tod_a, sim_h, program_g):
    """Phase (y): the (det, time) mesh over a gloo world of two ranks on the
    one card, each holding its rows, held against this process's
    one-process runs (module docstring), and a one-rank NCCL world."""
    import pickle

    import torch
    import torch.distributed as dist

    from maria_torch.atmosphere.streaming import StreamingExtrusion
    from maria_torch.convert import tod_from_arrays
    from maria_torch.mappers.bin_mapper import bin_total, field_pixel_ids
    from maria_torch.mappers.ml_mapper import MaximumLikelihoodMapper
    from maria_torch.parallel import block_range, create_mesh
    from maria_torch.scenes import simulation

    # K3 at (y1)'s second rank: rows 25,002.. of the AtLAST-50k draw; K1 at (y6)'s first rank's rows
    k3_row0 = check_shared_v(device, seeded(device), 5556 * ATLAST_BANDS // 2, 1537, row0=5556 * ATLAST_BANDS // 2)
    k1_rows = check_pink_noise(device, seeded(device), int(np.diff(block_range(217, MESH_WORLD, 0))[0]), 3000, 3072)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
        # the one-process runs the ranks are held against
        sim = simulation("atlast", 60.0, device)
        program = sim.program()
        fn = program.total_power_fn()
        obs = sim.obs_list[0]
        ids, n_pix = field_pixel_ids(obs.boresight, obs.offsets, N_MAP, N_MAP, device=device)
        np.save(os.path.join(tmp, "y1_ids.npy"), ids.cpu().numpy())
        torch.cuda.reset_peak_memory_stats()
        total = fn(generator=seeded(device), device=device)
        sums, hits = bin_total(total, ids, n_pix)
        torch.cuda.synchronize()
        one_peak = torch.cuda.max_memory_allocated() / 1e9
        np.save(os.path.join(tmp, "y1_total.npy"), total.cpu().numpy())
        np.save(os.path.join(tmp, "y1_hits.npy"), hits.cpu().numpy())
        np.save(os.path.join(tmp, "y1_sums64.npy"), plain_sums64(total, ids, n_pix).cpu().numpy())
        del total, sums, hits
        one_warm = warm_ms(lambda: bin_total(fn(generator=seeded(device), device=device), ids, n_pix),
                           reps=MESH_REPS)[0]
        del sim, program, fn, ids

        args_a = tod_arrays(tod_a)
        with open(os.path.join(tmp, "y2_tod.pkl"), "wb") as f:
            pickle.dump(args_a, f)
        tod_y2 = tod_from_arrays(**args_a, device=device)
        map_y2 = map_tod(tod_y2)
        np.save(os.path.join(tmp, "y2_map.npy"), map_y2.data.cpu().numpy().astype(np.float64))
        np.save(os.path.join(tmp, "y2_weight.npy"), map_y2.weight.cpu().numpy())
        y2_one_ms = warm_ms(lambda: map_tod(tod_y2), reps=MESH_REPS)[0]

        args_n = tod_arrays(sim_h.run()[0].process(**TUTORIAL_CHAIN))
        with open(os.path.join(tmp, "y3_tod.pkl"), "wb") as f:
            pickle.dump(args_n, f)
        tod = tod_from_arrays(**args_n, device=device)
        mapper = MaximumLikelihoodMapper(tod, n_epochs=ML_EPOCHS, n_cg_iters=ML_CG_ITERS, k=ML_K, **ML_KW)
        np.save(os.path.join(tmp, "y3_map.npy"), mapper.fit().data.cpu().numpy())
        y3_one_ms = warm_ms(mapper.fit, reps=MESH_REPS)[0]
        del mapper, tod, args_n

        ex = mesh_stream_executor(device)
        res = ex.run(MESH_SEED, group_size=16)
        np.savez(os.path.join(tmp, "y4.npz"), map_sum=res.map_sum, map_wgt=res.map_wgt)
        y4_one_ms = warm_ms(lambda: ex.run(MESH_SEED, group_size=16), reps=MESH_REPS)[0]
        del ex

        (proc,) = program_g.ar_processes
        with open(os.path.join(tmp, "y5_process.pkl"), "wb") as f:
            pickle.dump((proc.A, proc.B, proc.extrusion_sample_index, proc.cross_section_sample_index), f)
        chunks = StreamingExtrusion(proc, MESH_CHUNK_ROWS, device=device).run_chunks(MESH_WORLD, seeded(device))
        np.save(os.path.join(tmp, "y5_chunks.npy"), torch.cat(chunks).cpu().numpy())

        program_a = simulation("mustang2", 60.0, device).program()
        reset_mesh_launches()
        fields_a = program_a.fields(generator=seeded(device), device=device)[0]
        torch.cuda.synchronize()
        y6_one_k1 = mesh_launches()["pink_noise"]
        np.savez(os.path.join(tmp, "y6_fields.npz"), **{k: v.cpu().numpy() for k, v in fields_a.items()})
        y6_one_ms = warm_ms(lambda: program_a.fields(generator=seeded(device), device=device), reps=MESH_REPS)[0]
        del program_a, fields_a
        torch.cuda.synchronize()

        # the world: two gloo ranks sharing the card (NCCL refuses two ranks on one device)
        import torch.multiprocessing as mp
        from torch.multiprocessing.spawn import ProcessException

        s = time.perf_counter()
        ctx = mp.start_processes(mesh_rank, args=(MESH_WORLD, tmp, str(device)), nprocs=MESH_WORLD, join=False,
                                 start_method="spawn")
        try:
            while not ctx.join(timeout=max(s + MESH_JOIN_S - time.perf_counter(), 0.1)):
                if time.perf_counter() - s >= MESH_JOIN_S:
                    for p in ctx.processes:
                        p.kill()
                        p.join()
                    fail(f"phase (y): the {MESH_WORLD}-rank world did not end within {MESH_JOIN_S:.0f} s")
        except ProcessException as e:
            fail(f"phase (y): a rank failed: {e}")
        world_s = time.perf_counter() - s
        ranks = []
        for r in range(MESH_WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))

        # a one-rank NCCL world in this process: (y2)'s map. K2's float
        # atomics add a pixel's samples in any order, so two one-process
        # maps may differ in their last bits: the NCCL map is held as the
        # two-rank one is, and its bit-equality printed beside theirs
        again = map_tod(tod_y2)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl", rank=0, world_size=1)
        try:
            mesh = create_mesh(device=device)
            nccl_map = map_tod(tod_y2, mesh=mesh)
            torch.cuda.synchronize()
            x = torch.zeros((2, N_MAP * N_MAP), dtype=torch.float32, device=device)
            nccl_ms = collective_ms(mesh, lambda: dist.all_reduce(x))
        finally:
            dist.destroy_process_group()
        ref = map_y2.data.double()
        nccl = {"close": bool(torch.allclose(nccl_map.data.double(), ref, atol=1e-5 * float(ref.abs().max()), rtol=1e-4)),
                "err": float((nccl_map.data.double() - ref).abs().max() / ref.abs().max()),
                "bit_equal": bool(torch.equal(nccl_map.data, map_y2.data)),
                "one_process_bit_equal": bool(torch.equal(again.data, map_y2.data)),
                "weights_equal": bool(torch.equal(nccl_map.weight, map_y2.weight))}

    gates = []
    y = {k: [r[k] for r in ranks] for k in ("y1", "y2", "y3", "y4", "y5", "y6")}
    for r, y1 in zip(ranks, y["y1"]):
        ok = y1["launches"]["shared_v"] == 1 and y1["launches"]["bin_map"] == 1 and y1["launches"]["pink_noise"] == 0
        ok &= y1["hits_exact"] and y1["sums_err"] <= 1e-5 and y1["tod_err_std"] <= 1e-5
        gates.append(ok)
        print(f"phase (y1) rank {r['rank']}: AtLAST-50k x 60 s rows {y1['rows']} ({y1['n_local']} detectors; setup "
              f"{y1['setup_s']:.2f} s): total_power_fn(rows=) with K3 at row0 {y1['rows'][0]}, K2 on its rows and one "
              f"all_reduce; launches {y1['launches']}; its TOD rows within {y1['tod_err_std']:.2e} of the rows' std of "
              f"the one-process run (limit 1e-5), hits exact {y1['hits_exact']}, sums within {y1['sums_err']:.2e} of "
              f"the float64 sums' max (limit 1e-5); peak {y1['peak_gb']:.2f} GB (one process {one_peak:.2f} GB), warm "
              f"{y1['warm_ms']:.2f} ms ({y1['warm_each_ms']}; one process {one_warm:.2f} ms) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
    for r, y2 in zip(ranks, y["y2"]):
        ok = y2["map_close"] and y2["launches"]["bin_map"] >= 1
        gates.append(ok)
        print(f"phase (y2) rank {r['rank']}: slice (a)'s TOD, BinMapper.run(mesh) on the {r['coords']} cell of the "
              f"(det {MESH_WORLD}, time 1) grid: map within atol 1e-5 of its max and rtol 1e-4 {y2['map_close']} "
              f"(max |diff| {y2['map_err']:.2e} of its max), weights within "
              f"{y2['weight_err']:.2e}, K2 launches {y2['launches']['bin_map']}; warm {y2['warm_ms']:.2f} ms (one "
              f"process {y2_one_ms:.2f} ms) {'ok' if ok else 'FAIL'}", flush=True)
    gates.append(nccl["close"])
    print(f"phase (y2) one-rank NCCL world: the map within atol 1e-5 of its max and rtol 1e-4 of the one-process map "
          f"{nccl['close']} (max |diff| {nccl['err']:.2e} of its max; bit for bit {nccl['bit_equal']}, weights "
          f"{nccl['weights_equal']}; two one-process maps bit for bit {nccl['one_process_bit_equal']}: K2's atomics) "
          f"{'ok' if nccl['close'] else 'FAIL'}", flush=True)
    expected_ml = ml_launches(1, "conjugate_gradient", ML_EPOCHS, ML_CG_ITERS) + 2
    for r, y3 in zip(ranks, y["y3"]):
        ok = y3["map_err"] <= 1e-3 and y3["launches"]["bin_map"] == expected_ml
        gates.append(ok)
        print(f"phase (y3) rank {r['rank']}: (n)'s TOD after the tutorial's chain, MaximumLikelihoodMapper(mesh=, "
              f"k={ML_K}).fit() on rows {y3['rows'][0]}..+{y3['rows'][1]} (padded to {y3['rows'][2]}): within "
              f"{y3['map_err']:.2e} of the one-process fit's max (limit 1e-3), K2 launches {y3['launches']['bin_map']} "
              f"(expected {expected_ml}); warm fit {y3['warm_ms']:.2f} ms (one process {y3_one_ms:.2f} ms) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
    for r, y4 in zip(ranks, y["y4"]):
        ok = y4["hits_exact"] and y4["sums_close"] and y4["hits"] == y4["n_real_samples"]
        ok &= y4["launches"]["pink_cascade"] == y4["n_blocks"] and y4["launches"]["bin_map"] == y4["n_blocks"]
        gates.append(ok)
        print(f"phase (y4) rank {r['rank']}: (u)'s MUSTANG-2 {MESH_STREAM_SECONDS:.0f} s streamed with run(mesh=): "
              f"hits exact {y4['hits_exact']}, {y4['hits']:.0f} = n_real_det x n_t {y4['n_real_samples']}, sums within "
              f"rtol 1e-5 / atol 1e-3 {y4['sums_close']} (max |diff| {y4['sums_err']:.2e} of max), launches "
              f"{y4['launches']} ({y4['n_blocks']} blocks); warm {y4['warm_ms']:.2f} ms (one process {y4_one_ms:.2f} "
              f"ms) {'ok' if ok else 'FAIL'}", flush=True)
    for r, y5 in zip(ranks, y["y5"]):
        ok = y5["bit_equal"] and y5["launches"]["ar_extrude"] == (2 if r["coords"][0] == 0 else 1)
        gates.append(ok)
        print(f"phase (y5) rank {r['rank']}: (g)'s AR process through extrude_time_sharded ({MESH_WORLD} chunks of "
              f"{MESH_CHUNK_ROWS} rows, the halo by send/recv): {y5['shape']} equal to StreamingExtrusion's chunks bit "
              f"for bit {y5['bit_equal']} (largest difference {y5['largest_diff_std']:.3e} of the screen's std), AR "
              f"launches {y5['launches']['ar_extrude']} {'ok' if ok else 'FAIL'}", flush=True)
    for r, y6 in zip(ranks, y["y6"]):
        ok = y6["launches"]["pink_noise"] == y6_one_k1 > 0 and "noise" in y6["err_std"]
        ok &= all(e <= (2e-4 if name == "noise" else 1e-5) for name, e in y6["err_std"].items())
        gates.append(ok)
        print(f"phase (y6) rank {r['rank']}: slice (a)'s MUSTANG-2 60 s program, fields(rows=) on rows {y6['rows']}: "
              f"each field's rows within {json.dumps(y6['err_std'])} of the rows' std of the one-process fields "
              f"(limits: noise 2e-4, K1's gate; the others 1e-5), K1 launches {y6['launches']['pink_noise']} (one "
              f"process {y6_one_k1}); warm {y6['warm_ms']:.2f} ms (one process {y6_one_ms:.2f} ms) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
    times = {"all_reduce_ms": {f"{y['y1'][0]['all_reduce_bytes']} B (y1 map)": [x["all_reduce_ms"] for x in y["y1"]],
                               f"{y['y3'][0]['all_reduce_bytes']} B (y3 P^T)": [x["all_reduce_ms"] for x in y["y3"]]},
             "send_recv_ms": {f"{y['y5'][0]['send_recv_bytes']} B (y5 halo)": [x["send_recv_ms"] for x in y["y5"]]},
             "nccl_one_rank_all_reduce_ms": nccl_ms, "world_s": world_s}
    print(f"phase (y) collectives, gloo between two ranks on one card (host-staged; not NCCL across cards): "
          f"{json.dumps(times)} ({card})", flush=True)
    if not all(gates):
        fail("phase (y): a sharded run disagrees with its one-process run")
    launches = {name: sum(r[p]["launches"][name] for r in ranks for p in ("y1", "y2", "y3", "y4", "y5", "y6"))
                for name in ("bin_map", "shared_v", "pink_cascade", "ar_extrude", "pink_noise")}
    summary = {"y1": {"peak_gb": [x["peak_gb"] for x in y["y1"]], "one_process_peak_gb": one_peak,
                      "warm_ms": [x["warm_ms"] for x in y["y1"]], "one_process_warm_ms": one_warm},
               "y2_warm_ms": [x["warm_ms"] for x in y["y2"]], "y2_one_process_ms": y2_one_ms,
               "y3_warm_ms": [x["warm_ms"] for x in y["y3"]], "y3_one_process_ms": y3_one_ms,
               "y4_warm_ms": [x["warm_ms"] for x in y["y4"]], "y4_one_process_ms": y4_one_ms,
               "y6_warm_ms": [x["warm_ms"] for x in y["y6"]], "y6_one_process_ms": y6_one_ms, **times}
    return launches, k3_row0, k1_rows, summary


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
                            (217, 180000, 196608), (5556, 3000, 3072)):
        k1[(n_det, n, n_fft)] = check_pink_noise(device, gen, n_det, n, n_fft)
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
    sim_i_noise, _, _, launches_i_noise = run_sky_slice("i, noise on", device, None, True, card)
    k2_ml = run_ml_slice(device, card, sim_h, gen)
    run_ml_recovery(device, card, sim_i, sim_i_noise)
    del sim_i_noise
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
    k2_p, launches_p, summary_p = run_cmb_patch(device, card, gen)
    k2_q, launches_q, summary_q = run_act(device, card, gen)
    launches_r, ids_r, n_pix_r, summary_r = run_usage(device, card)
    launches_s, summary_s = run_photon_noise(device, card)
    kc_t, k2_t, launches_t, summary_t = run_streamed_atlast(device, card, gen)
    with tempfile.TemporaryDirectory() as tmp:
        summary_u, ar_u, kc_u = run_streamed_mustang(device, card, program_g, tmp)
    k2_v, kc_v, launches_v, summary_v = run_streamed_ml(device, card)

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
    ids_h = radec_pixel_ids(tod_h.pointing, sky.center, sky.x_res, sky.n_x, sky.n_y, device=device).contiguous()
    k2["h"] = check_bin_map(device, gen, ids_h, "slice h ra/dec ids, 512 x 512", n_pix=sky.n_x * sky.n_y)
    k2["r"] = check_bin_map(device, gen, ids_r, "slice r ra/dec ids, the three maps' shape", n_pix=n_pix_r)
    del ids_r
    for key, r in k2.items():
        for form, x in r.items():
            print(f"K2 summary {key} {form}: {x['ms']:.4f} ms, library {x['library_ms']:.4f} ms, bound "
                  f"{x['bound_ms']:.4f} ms ({x['bound_ms'] / x['ms']:.1%}), plain {x['plain_ms']:.4f} ms", flush=True)

    launches_w, k1_w, k2_w, summary_w = run_transfer_tutorial(device, card, gen)
    launches_x, summary_x = run_mustang_fits(device, card, results["a"][0])
    launches_y, k3_y, k1_y, summary_y = run_mesh(device, card, results["a"][0], sim_h, program_g)
    print(f"not driven on the card: HDF5 files and plotting (held by the CPU tests); on this machine h5py "
          f"{'found' if importlib.util.find_spec('h5py') else 'not found'}, matplotlib "
          f"{'found' if importlib.util.find_spec('matplotlib') else 'not found'}", flush=True)

    launches_b = results["b"][2]
    by_slice = {**{label: r[2] for label, r in results.items()}, "c": launches_c, "g": launches_g, "h": launches_h,
                "i": launches_i, "i, noise on": launches_i_noise, "j": launches_j, "CMB spectra": launches_spectra,
                "k": launches_k, "l": launches_l, "m": launches_m, "p": launches_p, "q": launches_q, "r": launches_r,
                "s": launches_s, "t": launches_t, "u 600 s": summary_u[U_SECONDS[0]]["launches"],
                "u 3600 s": summary_u[U_SECONDS[1]]["launches"], "u chunks": {"ar_extrude": ar_u["launches"]},
                "v": launches_v, "w": launches_w, "x": launches_x, "y (both ranks)": launches_y}
    for name in ("pink_noise", "bin_map", "shared_v", "ar_extrude", "sht_synth", "sht_anal", "pink_cascade"):
        print(f"main-path launches of {name} by slice: {({k: v[name] for k, v in by_slice.items() if name in v})}",
              flush=True)
    kernels_line = {"kernels": [
        {"name": "pink_noise", "route": "cuda", "source": "maria_torch/csrc/pink_noise.cu",
         "replaces": "maria_tpu/ops/pallas_noise.py:269",
         "launches": launches_b["pink_noise"] + launches_r["pink_noise"] + launches_s["pink_noise"]
         + launches_w["pink_noise"] + launches_y["pink_noise"],
         **k1[(217, 30000, 32768)]},
        {"name": "bin_map", "route": "cuda", "source": "maria_torch/csrc/bin_map.cu",
         "replaces": "maria_tpu/ops/pallas_binning.py:119",
         "launches": launches_b["bin_map"] + launches_p["bin_map"] + launches_q["bin_map"] + launches_r["bin_map"]
         + launches_t["bin_map"] + launches_v["bin_map"] + launches_w["bin_map"] + launches_x["bin_map"]
         + launches_y["bin_map"],
         **k2["b"]["stacked"]},
        {"name": "shared_v", "route": "cuda", "source": "maria_torch/csrc/shared_v.cu",
         "replaces": "maria_tpu/ops/pallas_noise.py:427", "launches": launches_c["shared_v"] + launches_y["shared_v"],
         **k3[5556 * ATLAST_BANDS]},
        {"name": "ar_extrude", "route": "cuda", "source": "maria_torch/csrc/ar_extrude.cu",
         "replaces": "maria_tpu/atmosphere/process.py:34",
         "launches": results["f"][2]["ar_extrude"] + ar_u["launches"] + launches_y["ar_extrude"], **ar["f"]},
        {"name": "sht_synth", "route": "cuda", "source": "maria_torch/csrc/sht.cu",
         "replaces": "maria_tpu/healpix/sht.py:480", "launches": launches_k["sht_synth"], **ks["synth"]},
        {"name": "sht_anal", "route": "cuda", "source": "maria_torch/csrc/sht.cu",
         "replaces": "maria_tpu/healpix/sht.py:523", "launches": launches_spectra["sht_anal"], **ks["anal"]},
        {"name": "pink_cascade", "route": "cuda", "source": "maria_torch/csrc/pink_cascade.cu",
         "replaces": "maria_tpu/noise/streaming.py:168",
         "launches": launches_t["pink_cascade"] + launches_y["pink_cascade"], **kc_t},
    ]}
    print(f"K2 summary ML P^T (slice n): {k2_ml['ms']:.4f} ms, library {k2_ml['library_ms']:.4f} ms, bound "
          f"{k2_ml['bound_ms']:.4f} ms ({k2_ml['bound_ms'] / k2_ml['ms']:.1%}), plain {k2_ml['plain_ms']:.4f} ms; "
          f"{ml_launches(1, 'conjugate_gradient', ML_EPOCHS, ML_CG_ITERS)} launches a fit", flush=True)
    for key, r in (("IQU ML P^T (slice p)", k2_p), ("IQU BinMapper band (slice q)", k2_q)):
        print(f"K2 summary {key}: {r['ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_ms'] / r['ms']:.1%}), plain {r['plain_ms']:.4f} ms, shape {r['shape']}", flush=True)
    print(f"slice (p) summary, the CMB patch (1052 x 12000, IQU ML fit; {card}): {json.dumps(summary_p)}", flush=True)
    print(f"slice (q) summary, the ACT camera (9000 x 12000, IQU BinMapper; {card}): {json.dumps(summary_q)}",
          flush=True)
    print(f"slice (r) summary, docs/usage.md's scene ({summary_r['shape'][0]} x {summary_r['shape'][1]}; {card}): "
          f"{json.dumps(summary_r)}", flush=True)
    print(f"slice (s) summary, AtLAST-50k photon noise (50004 x 3000; {card}): {json.dumps(summary_s)}", flush=True)
    print(f"slice (t) summary, AtLAST-50k x {STREAM_SECONDS:.0f} s streamed ({card}): {json.dumps(summary_t)}",
          flush=True)
    print(f"slice (u) summary, MUSTANG-2 streamed at {U_SECONDS} s ({card}): "
          f"{json.dumps({f'{k:.0f} s': v for k, v in summary_u.items()})}; AR chunk {json.dumps(ar_u)}", flush=True)
    print(f"slice (v) summary, the streamed ML mapper ({card}): {json.dumps(summary_v)}", flush=True)
    print(f"slice (w) summary, the transfer-function tutorial ({card}): {json.dumps(summary_w)}", flush=True)
    print(f"slice (x) summary, a MUSTANG-2 TOD through a FITS file ({card}): {json.dumps(summary_x)}", flush=True)
    print(f"phase (y) summary, the mesh over two gloo ranks sharing the card ({card}): {json.dumps(summary_y)}",
          flush=True)
    for key, r in (("K1 at slice (w)'s band", k1_w), ("K2 at slice (w)'s band", k2_w), ("K1 at (y6)'s rows", k1_y)):
        print(f"{key} summary: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bound_ms'] / r['ms']:.1%}), shape {r['shape']}",
              flush=True)
    for key, r in (("KC (t)", kc_t), ("KC (u)", kc_u), ("KC (v)", kc_v), ("K3 at row0 25002 (y1)", k3_y),
                   ("K2 streaming block (t)", k2_t),
                   ("K2 streamed ML P^T (v)", k2_v), ("AR chunk (u)", ar_u)):
        print(f"{key} summary: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{'none' if r['library_ms'] is None else format(r['library_ms'], '.4f') + ' ms'}, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bound_ms'] / r['ms']:.1%}), shape {r['shape']}",
              flush=True)
    print(f"K2's launches in the kernels line: slice (b) {launches_b['bin_map']} + slice (p) {launches_p['bin_map']} + "
          f"slice (q) {launches_q['bin_map']} + slice (r) {launches_r['bin_map']} + slice (t) {launches_t['bin_map']} "
          f"+ slice (v) {launches_v['bin_map']} + slice (w) {launches_w['bin_map']} + slice (x) "
          f"{launches_x['bin_map']} + phase (y) {launches_y['bin_map']}; K3's: slice (c) {launches_c['shared_v']} + "
          f"phase (y) {launches_y['shared_v']}; the AR kernel's: slice (f) {results['f'][2]['ar_extrude']} + slice "
          f"(u)'s chunks {ar_u['launches']} + phase (y) {launches_y['ar_extrude']}; KC's: slice (t) "
          f"{launches_t['pink_cascade']} + phase (y) {launches_y['pink_cascade']} (besides: (u) at 3,600 s "
          f"{summary_u[U_SECONDS[1]]['launches']['pink_cascade']}, (v)'s first fit {launches_v['pink_cascade']}); "
          f"K1's: slice (b) "
          f"{launches_b['pink_noise']} + slice (r) {launches_r['pink_noise']} + slice (s) {launches_s['pink_noise']} "
          f"+ slice (w) {launches_w['pink_noise']} + phase (y) {launches_y['pink_noise']}",
          flush=True)
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
