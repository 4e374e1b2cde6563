"""The port's kernels K1 pink_noise and K2 bin_map, and K3 shared_v's
store map.

On the CPU the wrappers run their plain torch versions; those are held
against the JAX package's Pallas kernels run in interpret mode, and
against the scatter references. The kernels' algorithms are emulated in
numpy and held against the plain versions here; the kernels themselves
are held against the plain versions on a card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from maria_torch.noise import band_half_spectrum  # noqa: E402
from maria_torch.ops import kernels  # noqa: E402
from maria_torch.ops.bin_map import MAX_SLOTS, SMEM_MAX, STEP, bin_map, bin_map_plain, bin_plan  # noqa: E402
from maria_torch.ops.pink_noise import (  # noqa: E402
    fft_smem_bytes,
    odd_part,
    pink_consts,
    pink_noise,
    pink_noise_plain,
    pink_plan,
)
from maria_tpu.noise import _pink_weights_np, _spectral_white_scale_np  # noqa: E402
from maria_tpu.ops import pallas_noise  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def private_caches(tmp_path_factory):
    """Private data caches for both packages (the shared default cache
    can hold a corrupt green_bank spectrum), restored afterwards."""
    import maria_torch
    import maria_tpu
    from maria_tpu.io import caching

    old_tpu, old_torch = caching.get_cache_dir(), maria_torch.io._cache_state["base"]
    maria_tpu.set_cache_dir(str(tmp_path_factory.mktemp("maria_tpu_cache")))
    maria_torch.set_cache_dir(str(tmp_path_factory.mktemp("maria_torch_cache")))
    yield
    maria_tpu.set_cache_dir(old_tpu)
    maria_torch.set_cache_dir(old_torch)


def _weights(n_fft, sample_rate=50.0, knee=1.0, beta=1.0):
    w = _pink_weights_np(n_fft, sample_rate, knee, beta)
    return np.sqrt(sample_rate + w**2) * _spectral_white_scale_np(n_fft)


def _kernel_layout_to_spectrum(z, m):
    """The Pallas kernel's draw z ((D, 2, n2, n1) or (D, 2, m)) as the
    port's spectrum draw (D, m+1, 2), slot for slot as
    pink_time_reference maps it."""
    z = np.asarray(z)
    D = z.shape[0]
    if z.ndim == 4:  # split layout (k2, k1) -> linear k = k2 + n2*k1
        zre = np.swapaxes(z[:, 0], 1, 2).reshape(D, m)
        zim = np.swapaxes(z[:, 1], 1, 2).reshape(D, m)
    else:
        zre, zim = z[:, 0], z[:, 1]
    S = np.zeros((D, m + 1, 2), np.float32)
    S[:, :m, 0], S[:, :m, 1] = zre, zim
    S[:, m, 0] = zim[:, 0]  # the k=0 slot's imaginary part is the Nyquist normal
    S[:, 0, 1] = 0.0
    return S


@pytest.mark.parametrize(
    "n,n_fft",
    [
        (3000, 3072),  # split path (m=1536 = 48*32), truncated
        (500, 512),  # single path (m=256), truncated
        (3072, 3072),  # split, full length
    ],
)
def test_pink_noise_plain_matches_pallas_interpret(n, n_fft):
    """K1's plain version equals pink_noise_pallas(draw="input") for the
    same normals, to 2e-4 x std (the Pallas kernel test's bound)."""
    key = jax.random.key(7)
    n_det = 5
    c = _weights(n_fft)
    x = np.asarray(pallas_noise.pink_noise_pallas(key, n_det, n, c, n_fft=n_fft, interpret=True, draw="input"))
    consts = pallas_noise.pink_consts(n_fft, tuple(np.asarray(c, dtype=np.float32).tolist()))
    Dp = -(-n_det // pallas_noise._TILE_D) * pallas_noise._TILE_D
    m = n_fft // 2
    if consts["mode"] == "split":
        z = jax.random.normal(key, (Dp, 2, consts["n2"], consts["n1"]), dtype=jnp.float32)
    else:
        z = jax.random.normal(key, (Dp, 2, m), dtype=jnp.float32)
    S = torch.as_tensor(_kernel_layout_to_spectrum(z, m)[:n_det])
    y = pink_noise(c, S, n, n_fft).numpy()  # CPU tensor -> plain version
    assert y.shape == (n_det, n)
    np.testing.assert_allclose(y, x, atol=2e-4 * float(np.std(x)))


@pytest.mark.parametrize("n_fft", [512, 3072, 32768])
def test_pink_consts_match_pallas(n_fft):
    """The port's host constants (m, alpha, gamma) are the Pallas
    kernel's."""
    c = _weights(n_fft).astype(np.float32)
    ours = pink_consts(n_fft, c)
    ref = pallas_noise.pink_consts(n_fft, tuple(c.tolist()))
    m = n_fft // 2
    assert ours["m"] == m
    if ref["mode"] == "split":

        def unperm(planes):  # (re/im, n2, n1) -> linear k = k2 + n2*k1
            return (planes[0] + 1j * planes[1]).T.reshape(m)
    else:

        def unperm(planes):
            return planes[0] + 1j * planes[1]
    np.testing.assert_allclose(ours["alpha"], unperm(ref["ag"][0]), rtol=1e-6, atol=1e-6 * np.abs(c).max())
    np.testing.assert_allclose(ours["gamma"], unperm(ref["ag"][1]), rtol=1e-6, atol=1e-6 * np.abs(c).max())


def _stockham(buf, L, T, ld, tw):
    """csrc/pink_noise.cu's fft_batch on flat shared-memory buffers (rows,
    L * ld): the direct r-point stage, then radix-4 stages and a last
    radix-2, each butterfly (p, q) reading x[q + s (p + j L/R)] and writing
    y[q + s (R p + k)] times w_L^{p k s}, element j of sequence b at
    [j * ld + b]."""
    r = odd_part(L)
    radices = ([r] if r > 1 else []) + [4] * (int(np.log2(L // r)) // 2) + [2] * (int(np.log2(L // r)) % 2)
    assert np.prod(radices) == L
    s = 1
    for R in radices:
        nR = L // R
        item = np.arange(nR * T)
        i, b = item // T, item % T
        p, q = i // s, i % s
        a = [buf[:, (i + j * nR) * ld + b] for j in range(R)]
        out = np.zeros_like(buf)
        for k in range(R):
            v = sum(a[j] * tw[((j * k) % R) * nR] for j in range(R))
            out[:, (q + s * (R * p + k)) * ld + b] = v * tw[p * k * s]
        buf, s = out, s * R
    return buf


def _twiddles(L):
    return np.exp(2j * np.pi * np.arange(L) / L).astype(np.complex64)


def _kernel_emulation(c, S, n, n_fft):
    """numpy emulation of csrc/pink_noise.cu as pink_plan lays it out, in
    complex64: pass 1 (or the only pass) loads tiles of T columns k2 with
    the fold u_k = alpha_k z_k + conj(gamma_{m-k} z_{m-k}), runs n1-point
    FFTs, and writes x (one pass) or B[k2, a] twiddled by exp(2 pi i k2 a
    / m) / m; pass 2 loads tiles of T values a, runs n2-point FFTs and
    writes x[2t], x[2t+1] for t = a + n1 s."""
    plan = pink_plan(n_fft)
    k = pink_consts(n_fft, c)
    m, n1, n2, rows = plan["m"], plan["n1"], plan["n2"], S.shape[0]
    assert fft_smem_bytes(n1, plan["batch"][0]) == plan["smem"][0]
    alpha, gamma = k["alpha"].astype(np.complex64), k["gamma"].astype(np.complex64)
    z = (S[:, :m, 0] + 1j * S[:, :m, 1]).astype(np.complex64)
    z[:, 0] = S[:, 0, 0] + 1j * S[:, m, 0]

    T = plan["batch"][0]
    ld = T + (T > 1)
    tile = np.arange(n2 // T)  # tiles of columns k2 = c0 + c, as extra rows of the batch
    k1, cc = np.divmod(np.arange(n1 * T), T)
    kk = (tile[:, None] * T + cc[None]) + n2 * k1[None]  # (tiles, n1 T)
    kr = (m - kk) % m
    u = alpha[kk] * z[:, kk] + np.conj(gamma[kr] * z[:, kr])  # (rows, tiles, n1 T)
    buf = np.zeros((rows * len(tile), n1 * ld), np.complex64)
    buf[:, k1 * ld + cc] = u.reshape(rows * len(tile), n1 * T)
    res = _stockham(buf, n1, T, ld, _twiddles(n1)).reshape(rows, len(tile), n1 * ld)
    if plan["passes"] == 1:
        y = res[:, 0, :m] / np.float32(m)
    else:
        cc, a = np.divmod(np.arange(n1 * T), n1)
        k2 = tile[:, None] * T + cc[None]
        tw = np.exp(2j * np.pi * ((k2 * a[None]) % m) / m).astype(np.complex64) / np.float32(m)
        B = np.zeros((rows, n2, n1), np.complex64)
        B[:, k2, a[None]] = res[:, :, a * ld + cc] * tw
        T = plan["batch"][1]
        ld = T + (T > 1)
        tile = np.arange(n1 // T)
        k2, cc = np.divmod(np.arange(n2 * T), T)
        buf = np.zeros((rows * len(tile), n2 * ld), np.complex64)
        buf[:, k2 * ld + cc] = B[:, k2[None], tile[:, None] * T + cc[None]].reshape(rows * len(tile), n2 * T)
        res = _stockham(buf, n2, T, ld, _twiddles(n2)).reshape(rows, len(tile), n2 * ld)
        s, cc = np.divmod(np.arange(n2 * T), T)
        t = tile[:, None] * T + cc[None] + n1 * s[None]
        y = np.zeros((rows, m), np.complex64)
        y[:, t] = res[:, :, s * ld + cc]
    return np.stack([y.real, y.imag], -1).reshape(rows, -1)[:, :n]


@pytest.mark.parametrize(
    "n,n_fft",
    [
        (3000, 3072),  # one pass, odd part 3
        (500, 512),  # one pass
        (30000, 32768),  # two passes, 128 x 128
        (1100, 1152),  # one pass, odd part 9
        (2400, 2560),  # one pass, odd part 5
        (4700, 5120),  # one pass, odd part 5
        (9000, 9216),  # one pass, odd part 9
        (20000, 20480),  # two passes, 128 x 80: odd part 5
        (36000, 36864),  # two passes, 144 x 128: odd part 9
        (65536, 65536),  # two passes, full length
        (180000, 196608),  # two passes, 384 x 256: odd part 3
    ],
)
def test_pink_kernel_algorithm_matches_plain(n, n_fft):
    """The CUDA kernel's radix-FFT algorithm, emulated in numpy in
    complex64 as pink_plan lays it out, equals the plain version at one-
    and two-pass lengths with each odd part."""
    rng = np.random.default_rng(3)
    c = band_half_spectrum(50.0, 5.0, 1.0, n_fft, corr_prop=0.5).astype(np.float32)
    S = rng.standard_normal((2, n_fft // 2 + 1, 2)).astype(np.float32)
    ref = pink_noise_plain(c, torch.as_tensor(S), n, n_fft).numpy()
    np.testing.assert_allclose(_kernel_emulation(c, S, n, n_fft), ref, atol=2e-4 * ref.std())


def test_pink_plan_covers_every_scan_length():
    """Every n_fft that good_fft_size gives a scan of up to 4 h at 200 Hz
    (2.88M samples) has a plan: n1 n2 = m, both factors' odd parts in
    {1, 3, 5, 9}, every pass's shared memory within the card's 232,448
    bytes (the port's first kernel needed 281,600 at n_fft 65,536), and
    a two-pass block within 48 KB."""
    from maria_torch.atmosphere.fourier import good_fft_size

    top = good_fft_size(2_880_000)
    sizes = sorted({r << k for r in (1, 3, 5, 9) for k in range(30) if 16 <= r << k <= top})
    sizes = [v for v in sizes if good_fft_size(v) == v]
    assert len(sizes) > 60 and sizes[-1] == top and 65536 in sizes and 196608 in sizes
    for n_fft in sizes:
        plan = pink_plan(n_fft)
        m, n1, n2 = plan["m"], plan["n1"], plan["n2"]
        assert n1 * n2 == m and odd_part(n1) in (1, 3, 5, 9) and odd_part(n2) in (1, 3, 5, 9)
        assert len(plan["smem"]) == len(plan["batch"]) == plan["passes"]
        assert max(plan["smem"]) <= 232_448
        if plan["passes"] == 1:
            assert m <= 9216 and plan["batch"] == (1,)
        else:
            assert max(plan["smem"]) <= 48 * 1024 and n1 >= n2 and n1 <= 4 * n2
            assert n2 % plan["batch"][0] == 0 and n1 % plan["batch"][1] == 0
            assert plan["smem"] == (fft_smem_bytes(n1, plan["batch"][0]), fft_smem_bytes(n2, plan["batch"][1]))


def test_pink_noise_plain_matches_jax_reference_at_65536():
    """At the length past the port's old limit (a 1,200 s scan at 50 Hz,
    n_fft 65,536), the plain version equals maria_tpu's
    pink_time_reference for the same draw."""
    n_fft, n, D = 65536, 60000, 2
    m = n_fft // 2
    c = _weights(n_fft)
    z = np.random.default_rng(5).standard_normal((D, 2, m)).astype(np.float32)
    ref = np.asarray(pallas_noise.pink_time_reference(jnp.asarray(z), c, n))
    ours = pink_noise_plain(c, torch.as_tensor(_kernel_layout_to_spectrum(z, m)), n, n_fft).numpy()
    assert ours.shape == ref.shape == (D, n)
    np.testing.assert_allclose(ours, ref, atol=2e-4 * float(np.std(ref)))


def _pallas_binning_cases():
    from maria_tpu.ops.binning import make_blocked_bin_plan

    rng = np.random.default_rng(0)
    n_det, n_t, n_map = 130, 300, 64
    det_y = rng.uniform(5, 58, n_det)
    det_x = rng.uniform(5, 58, n_det)
    t = np.arange(n_t) / 50
    iy = np.clip((det_y[:, None] + 4 * np.sin(t)[None]).astype(np.int32), 0, n_map - 1)
    ix = np.clip((det_x[:, None] + 4 * np.cos(t)[None]).astype(np.int32), 0, n_map - 1)
    iy[3, 5:9] = -1
    ix[3, 5:9] = -1
    yield iy, ix, n_map, make_blocked_bin_plan(iy, ix, n_map, n_map, chunk=64, det_block=32), rng

    rng = np.random.default_rng(31)
    n_det, n_t, n_map = 40, 128, 64
    det_y = rng.uniform(10, 50, n_det)
    det_x = rng.uniform(10, 50, n_det)
    iy = np.clip((det_y[:, None] + np.zeros(n_t)).astype(np.int32), 0, n_map - 1)
    ix = np.clip((det_x[:, None] + np.zeros(n_t)).astype(np.int32), 0, n_map - 1)
    yield iy, ix, n_map, make_blocked_bin_plan(iy, ix, n_map, n_map, chunk=128, det_block=64), rng


@pytest.mark.parametrize("case", [0, 1])
def test_bin_map_plain_matches_references(case):
    """K2's plain version equals bin_blocked_pallas (interpret mode),
    bin_scatter and np.add.at on the Pallas binning tests' cases: hit
    counts exactly, sums to 1e-5 of the map's maximum."""
    from maria_tpu.ops.binning import bin_scatter
    from maria_tpu.ops.pallas_binning import bin_blocked_pallas

    from maria_torch.convert import pixel_ids_from_tables

    iy, ix, n_map, plan, rng = list(_pallas_binning_cases())[case]
    data = rng.standard_normal(iy.shape).astype(np.float32)
    ids = pixel_ids_from_tables(iy, ix, n_map, n_map)
    channels = torch.as_tensor(np.stack([data, np.ones_like(data)]))
    ours = bin_map(channels, ids, n_map * n_map).numpy()  # CPU tensor -> plain version

    good = (iy.ravel() >= 0) & (ix.ravel() >= 0)
    flat = (iy.astype(np.int64) * n_map + ix).ravel()
    ref_sum = np.zeros(n_map * n_map)
    np.add.at(ref_sum, flat[good], data.ravel()[good])
    ref_hits = np.bincount(flat[good], minlength=n_map * n_map)
    np.testing.assert_array_equal(ours[1], ref_hits)
    scale = max(1.0, np.abs(ref_sum).max())
    np.testing.assert_allclose(ours[0], ref_sum, atol=1e-5 * scale)

    pallas = np.asarray(bin_blocked_pallas(jnp.asarray(data), plan, interpret=True)).ravel()
    np.testing.assert_allclose(ours[0], pallas, atol=1e-5 * scale)
    pix = np.where(good, flat, 0).astype(np.int32)
    scatter = np.asarray(bin_scatter(jnp.asarray(np.where(good.reshape(iy.shape), data, 0.0)),
                                     jnp.asarray(pix), n_map * n_map))
    np.testing.assert_allclose(ours[0], scatter, atol=1e-5 * scale)


def test_bin_map_skips_out_of_range_ids():
    ids = torch.tensor([[0, -1, 3, 4, 2]], dtype=torch.int32)
    data = torch.arange(5, dtype=torch.float32)[None, None].expand(1, 1, 5).contiguous()
    out = bin_map_plain(data, ids, 4)
    np.testing.assert_array_equal(out.numpy(), [[0.0, 0.0, 4.0, 2.0]])


def _bin_emulation(channels, ids, n_pix, count, n_sm=132):
    """numpy emulation of csrc/bin_map.cu as bin_plan lays it out: group y
    takes slots [y per, y per + per); the full groups' launch gives block
    x samples [x full_span, (x + 1) full_span), the last group's launch
    [x span, (x + 1) span); in 32-lane steps a lane starts a segment where
    its id differs from the previous lane's, a segmented inclusive sum in
    shuffle steps (float32; all five here, the kernel stops after the
    warp's longest segment, which leaves every segment's last lane the
    same) leaves each segment's total in its last lane, which adds it (and
    the segment's length as its hit count) when its id is in [0, n_pix); a
    shared-memory block adds into its private map, then adds the nonzero
    pixels to the output."""
    n_channels, n = channels.shape
    plan = bin_plan(n_pix, n_channels, n, count, n_sm=n_sm)
    assert plan["smem"] <= SMEM_MAX and plan["blocks"] * plan["span"] >= n
    lane = np.arange(32)
    out = np.zeros((plan["slots"], n_pix), np.float32)
    private = plan["form"] != "global"
    for gy in range(plan["groups"]):
        last = gy == plan["groups"] - 1
        blocks, span = (plan["blocks"], plan["span"]) if last else (plan["full_blocks"], plan["full_span"])
        assert blocks * span >= n
        slots = range(gy * plan["per"], min((gy + 1) * plan["per"], plan["slots"]))
        for bx in range(blocks):
            lo, hi = bx * span, min((bx + 1) * span, n)
            n_steps = -(-(hi - lo) // 32)
            step_ids = np.full(n_steps * 32, -1, np.int64)
            step_ids[: hi - lo] = ids[lo:hi]
            step_ids = step_ids.reshape(n_steps, 32)
            heads = np.ones(step_ids.shape, bool)
            heads[:, 1:] = step_ids[:, 1:] != step_ids[:, :-1]
            start = np.maximum.accumulate(np.where(heads, lane, 0), axis=1)
            tail = np.ones(step_ids.shape, bool)
            tail[:, :-1] = heads[:, 1:]
            tail &= (step_ids >= 0) & (step_ids < n_pix)
            maps = np.zeros((len(slots), n_pix), np.float32) if private else out[slots.start: slots.stop]
            for j, s in enumerate(slots):
                if s < n_channels:
                    x = np.zeros(n_steps * 32, np.float32)
                    x[: hi - lo] = channels[s, lo:hi]
                    x = x.reshape(n_steps, 32)
                    for d in (1, 2, 4, 8, 16):
                        y = np.zeros_like(x)
                        y[:, d:] = x[:, :-d]
                        x = np.where(lane - d >= start, x + y, x)
                    np.add.at(maps[j], step_ids[tail], x[tail])
                else:
                    hits = np.zeros(n_pix, np.uint32)
                    np.add.at(hits, step_ids[tail], (lane - start + 1)[tail].astype(np.uint32))
                    maps[j] += hits.astype(np.float32)
            if private:
                out[slots.start: slots.stop] += maps
    return plan, out


def _bin_cases():
    """(name, channels (C, n_det, n_t) float32, ids (n_det, n_t) int32,
    n_pix): both Pallas binning cases with (data, 1) channels, -1 runs
    across warp and row boundaries with n_samples % 4 != 0, six channels
    on a 128 x 128 map (split over blocks), a 512 x 512 map (global), and
    six channels planned for 4 SMs, where the full groups' launch and the
    last group's take different blocks and spans."""
    from maria_torch.convert import pixel_ids_from_tables

    for i, (iy, ix, n_map, _, rng) in enumerate(_pallas_binning_cases()):
        data = rng.standard_normal(iy.shape).astype(np.float32)
        yield f"pallas{i}", np.stack([data, np.ones_like(data)]), pixel_ids_from_tables(iy, ix, n_map, n_map).numpy(), n_map**2

    rng = np.random.default_rng(11)
    n_det, n_t, n_pix = 7, 203, 64  # 1421 samples: several blocks of 256 samples a block
    runs = rng.integers(-1, n_pix + 3, size=(n_det * n_t) // 5 + 1)  # ids of -1 and >= n_pix included
    ids = np.repeat(runs, 5)[: n_det * n_t]
    ids[28:37] = -1  # a -1 run across lanes 31 | 0 of two steps
    ids[n_t - 3: n_t + 4] = -1  # and across the boundary of rows 0 and 1
    ids[2 * n_t - 2: 2 * n_t + 2] = 17  # a pixel run across rows 1 and 2
    yield "minus1_runs", rng.standard_normal((3, n_det, n_t)).astype(np.float32), ids.reshape(n_det, n_t), n_pix

    rng = np.random.default_rng(12)
    walk = np.cumsum(rng.integers(0, 2, size=(16, 500)), axis=1) // 3 + rng.integers(0, 16000, size=(16, 1))
    yield "six_channels", rng.standard_normal((6, 16, 500)).astype(np.float32), walk.astype(np.int32), 128 * 128

    walk = np.cumsum(rng.integers(0, 2, size=(8, 999)), axis=1) // 2 + rng.integers(-100, 262000, size=(8, 1))
    yield "map512", rng.standard_normal((2, 8, 999)).astype(np.float32), walk.astype(np.int32), 512 * 512

    walk = np.cumsum(rng.integers(0, 2, size=(32, 2100)), axis=1) // 3 + rng.integers(0, 16000, size=(32, 1))
    yield "six_channels_4_sms", rng.standard_normal((6, 32, 2100)).astype(np.float32), walk.astype(np.int32), 128 * 128


@pytest.mark.parametrize("count", [False, True])
@pytest.mark.parametrize("case", ["pallas0", "pallas1", "minus1_runs", "six_channels", "map512", "six_channels_4_sms"])
def test_bin_kernel_algorithm_matches_plain(case, count):
    """K2's algorithm, emulated in numpy as bin_plan lays it out, equals
    the plain version: hit counts exactly, sums to 1e-5 of the map's
    maximum, on each plan form (private, split, global)."""
    name, channels, ids, n_pix = next(c for c in _bin_cases() if c[0] == case)
    flat = channels.reshape(channels.shape[0], -1)
    n_sm = 4 if case == "six_channels_4_sms" else 132
    plan, ours = _bin_emulation(flat, ids.ravel(), n_pix, count, n_sm=n_sm)
    assert plan["form"] == {"six_channels": "split", "map512": "global", "six_channels_4_sms": "split"}.get(case, "private")
    if case == "six_channels_4_sms" and count:
        assert (plan["full_blocks"], plan["blocks"]) == (2, 4) and plan["full_span"] != plan["span"]
    ref = bin_map_plain(torch.as_tensor(channels), torch.as_tensor(ids, dtype=torch.int32), n_pix, count=count).numpy()
    assert ours.shape == ref.shape == (channels.shape[0] + count, n_pix)
    if count:
        np.testing.assert_array_equal(ours[-1], ref[-1])
        good = ids[(ids >= 0) & (ids < n_pix)]
        np.testing.assert_array_equal(ref[-1], np.bincount(good, minlength=n_pix))
    for s in range(channels.shape[0]):
        scale = max(1.0, float(np.abs(ref[s]).max()))
        np.testing.assert_allclose(ours[s], ref[s], atol=1e-5 * scale)


def test_bin_plan_fits_shared_memory():
    """Every bin_plan for maps up to 1024 x 1024 and up to six channels,
    with and without the count: a block's shared memory within the card's
    232,448 bytes, at most MAX_SLOTS slots a block, every slot in one
    group, every sample in one block's range of each launch, each launch
    of shared-memory blocks within one block an SM for the groups it
    holds, and the global form exactly where one slot's map does not
    fit."""
    sides = (1, 2, 8, 64, 100, 128, 129, 200, 240, 241, 256, 300, 512, 1024)
    for n_pix in sorted({a * b for a in sides for b in sides}):
        for n_channels in range(7):
            for count in (False, True):
                if n_channels + count == 0:
                    continue
                for n_samples in (1, 4097, 651_000, 150_012_000):
                    plan = bin_plan(n_pix, n_channels, n_samples, count)
                    groups = plan["groups"]
                    assert plan["smem"] <= SMEM_MAX
                    assert 1 <= plan["per"] <= MAX_SLOTS and plan["slots"] == n_channels + count
                    assert (groups - 1) * plan["per"] < plan["slots"] <= groups * plan["per"]
                    launches = [(1, plan["blocks"], plan["span"])]
                    if groups > 1:
                        launches.append((groups - 1, plan["full_blocks"], plan["full_span"]))
                    else:
                        assert plan["full_blocks"] == plan["full_span"] == 0
                    for n_groups, blocks, span in launches:
                        assert span % STEP == 0 and blocks * span >= n_samples
                        assert (blocks - 1) * span < n_samples
                        if plan["form"] != "global":
                            assert blocks * n_groups <= 132
                    assert (plan["form"] == "global") == (4 * n_pix > SMEM_MAX)
                    if plan["form"] != "global":
                        assert plan["smem"] == 4 * plan["per"] * n_pix
                        assert plan["form"] == ("private" if groups == 1 else "split")


def test_bin_total_count_form_equals_stacked():
    """bin_total's count form (one channel and the in-kernel count) equals
    the stacked (total, 1) form on the CPU, bit for bit."""
    from maria_torch.mappers.bin_mapper import bin_total

    rng = np.random.default_rng(4)
    total = torch.as_tensor(rng.standard_normal((40, 301)).astype(np.float32) + 3)
    ids = torch.as_tensor(rng.integers(-1, 4096, size=(40, 301)).astype(np.int32))
    sums, hits = bin_total(total, ids, 4096)
    ref = bin_map_plain(torch.stack([total, torch.ones_like(total)]), ids, 4096)
    assert torch.equal(sums, ref[0]) and torch.equal(hits, ref[1])


def _store_plane_emulation(buf, writes, off, m1):
    """csrc/shared_v.cu's store_plane over one plane of m1 bins at element
    offset ``off`` of a 4-byte-aligned buffer: 32-lane steps over the bin
    pairs; 4-byte stores of columns (2p, 2p + 1) where the plane starts on
    an even element, else of (2p - 1, 2p) with bin 2p - 1 from the previous
    lane (or the previous step's lane 31), the first and last bins alone.
    Writes the bin index k at column k, counting writes."""
    n_pairs = (m1 + 1) // 2

    def store(e, v):
        buf[e] = v
        writes[e] += 1

    carry = None
    for p0 in range(0, n_pairs, 32):
        p = p0 + np.arange(32)
        live = p < n_pairs
        v1 = np.where(live & (2 * p + 1 < m1), 2 * p + 1, -1)  # bin 2p + 1 (the kernel's 0.0 where none)
        if off % 2 == 0:
            for q in p[live]:
                if 2 * q + 1 < m1:
                    assert (off + 2 * q) % 2 == 0
                    store(off + 2 * q, 2 * q)
                    store(off + 2 * q + 1, 2 * q + 1)
                else:
                    store(off + 2 * q, 2 * q)
        else:
            before = np.concatenate([[carry], v1[:-1]])
            carry = v1[31]
            for lane in np.nonzero(live)[0]:
                q = p[lane]
                if q == 0:
                    store(off, 0)
                else:
                    assert (off + 2 * q - 1) % 2 == 0
                    store(off + 2 * q - 1, before[lane])
                    store(off + 2 * q, 2 * q)
                if 2 * q + 2 == m1:
                    store(off + m1 - 1, v1[lane])


@pytest.mark.parametrize("m1", [1537, 1536, 33, 34, 1, 2])
def test_shared_v_store_map(m1):
    """K3's store map, emulated: for an odd and an even m1 and row strides
    ld = 2 m1 + {0, 1, 2, 7}, on buffers that start on an even and an odd
    element, each of a row's 2 m1 columns is written exactly once with its
    own bin, every 4-byte store is aligned, and no column >= 2 m1 is
    written."""
    for gap in (0, 1, 2, 7):
        ld = 2 * m1 + gap
        for base in (0, 1):
            n_rows = 3
            buf = np.full(base + n_rows * ld, -7, np.int64)
            writes = np.zeros_like(buf)
            for rb in range(n_rows):
                _store_plane_emulation(buf, writes, base + rb * ld, m1)
                _store_plane_emulation(buf, writes, base + rb * ld + m1, m1)
                buf[base + rb * ld + m1: base + rb * ld + 2 * m1] += m1  # the im plane's bins are columns m1 + k
            rows = buf[base:].reshape(n_rows, ld)
            counts = writes[base:].reshape(n_rows, ld)
            assert writes[:base].sum() == 0
            np.testing.assert_array_equal(counts[:, : 2 * m1], 1)
            np.testing.assert_array_equal(counts[:, 2 * m1:], 0)
            np.testing.assert_array_equal(rows[:, : 2 * m1], np.broadcast_to(np.arange(2 * m1), (n_rows, 2 * m1)))


# K3's least loop body (chip_smoke.py's K3_LEAST_BODY; PERF.md section 6
# counts its instructions): float32 coefficients, minimax in relative error
_LEAST_LOG = (0.2609253227710724, 0.0883302241563797)  # -2 log1p(f) = g + g^2 (q0 + q1 g), g = -2 f
_LEAST_SIN = (-0.16241997480392456,)  # sin x = x + s1 x^3 on [-pi/4, pi/4]
_LEAST_COS = (-0.49975958466529846, 0.04045603424310684)  # cos x = 1 + x^2 (c1 + c2 x^2)


def _fma32(a, b, c):
    """float32 a * b + c with one rounding (the product is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def _horner32(coeffs, x):
    p = np.full(x.shape, coeffs[-1], np.float32)
    for q in coeffs[-2::-1]:
        p = _fma32(p, x, np.float32(q))
    return p


def _least_body_bin(c, a, b, log=_LEAST_LOG, sin=_LEAST_SIN, cos=_LEAST_COS):
    """One bin's (c Re z, c Im z) in float32 from the Philox words a, b
    (uint32), as K3's least loop body computes it, one instruction a line
    (ALU: IADD3, LOP3, SHF, FSEL; XU: I2F, MUFU.SQRT; the rest FMA-pipe
    FFMA, FMUL, FADD). Per bin: ALU 10, FMA pipe 18, XU 2; per uniform one
    SHF, I2F and FFMA."""
    f32 = np.float32
    u1 = _fma32((a >> 8).astype(f32), f32(2**-24), f32(2**-25))  # SHF, I2F, FFMA
    u2 = _fma32((b >> 8).astype(f32), f32(2**-24), f32(2**-25))
    # -2 log u1 = -2 (e ln 2 + log1p(f)), the mantissa m = 1 + f in [2/3, 4/3)
    bits = u1.view(np.int32)
    e = (bits - np.int32(0x3F2AAAAB)) & np.int32(-(1 << 23))  # IADD3, LOP3
    g = _fma32((bits - e).view(f32), f32(-2), f32(2))  # IADD3, FFMA: g = -2 f, exact
    s = _fma32(g * g, _horner32(log, g), g)  # FFMA (Horner), FMUL, FFMA
    l = _fma32(e.astype(f32), f32(-2 * np.log(2) * 2**-23), s)  # I2F, FFMA
    r = np.sqrt(l)  # MUFU.SQRT
    theta = f32(2 * np.pi) * u2  # FMUL
    # theta - j pi/2 in two steps; j rounded by the 1.5 * 2^23 shift
    jm = _fma32(theta, f32(2 / np.pi), f32(12582912))  # FFMA
    j = jm - f32(12582912)  # FADD
    c1 = f32(np.pi / 2)
    x = _fma32(j, -c1, theta)  # FFMA
    x = _fma32(j, -f32(np.pi / 2 - np.float64(c1)), x)  # FFMA
    x2 = x * x  # FMUL
    sin_x = _fma32(x * x2, _horner32(sin, x2), x) if sin else x  # FMUL, FFMA
    cos_x = _fma32(_horner32(cos, x2), x2, f32(1))  # FFMA (Horner), FFMA
    q = jm.view(np.int32) & 3  # the quadrant, in jm's low bits
    odd = (q & 1) == 1  # LOP3
    sa, cb = np.where(odd, cos_x, sin_x), np.where(odd, sin_x, cos_x)  # FSEL, FSEL
    t = q.astype(np.uint32) << np.uint32(30)  # SHF
    sin_v = (sa.view(np.uint32) ^ (t & np.uint32(1 << 31))).view(f32)  # LOP3
    cos_v = (cb.view(np.uint32) ^ ((t + np.uint32(1 << 30)) & np.uint32(1 << 31))).view(f32)  # IADD3, LOP3
    cr = c * r  # FMUL
    return cr * cos_v, cr * sin_v  # FMUL, FMUL


def _least_body_worst_ulps(**variant):
    """The largest |difference| in bf16 ulps between bf16 of the least
    body's bins and shared_v_plain's Box-Muller on the same words: random
    words, u1 over its top 2^14 values (where log u1 -> 0), and theta
    within 4096 steps of each multiple of pi/2; c over six decades."""
    from maria_torch.ops.shared_v import _box_muller

    rng = np.random.default_rng(5)
    a = rng.integers(0, 1 << 32, 1 << 18, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, 1 << 18, dtype=np.uint64).astype(np.uint32)
    top = ((np.uint32((1 << 24) - 1) - np.arange(1 << 14, dtype=np.uint32)) << np.uint32(8)) | np.uint32(0x5A)
    edges = np.concatenate([np.clip(round(2**24 * k / 4) + np.arange(-4096, 4096), 0, 2**24 - 1) for k in range(5)])
    a = np.concatenate([a, top, a[: edges.size]])
    b = np.concatenate([b, b[: top.size], edges.astype(np.uint32) << np.uint32(8)])
    c = (10 ** rng.uniform(-3, 3, a.size)).astype(np.float32)
    re, im = _box_muller(torch.as_tensor(a.astype(np.int64)), torch.as_tensor(b.astype(np.int64)))

    def bf16(x):
        return torch.as_tensor(x).to(torch.bfloat16).float().numpy()

    worst = 0.0
    for ours, plain in zip(_least_body_bin(c, a, b, **variant), (re.numpy(), im.numpy())):
        ours, plain = bf16(ours), bf16(c * plain)
        _, e = np.frexp(np.maximum(np.maximum(np.abs(ours), np.abs(plain)), 1e-30))
        worst = max(worst, float(np.max(np.abs(ours - plain) / np.ldexp(1.0, e - 8))))
    return worst


def test_k3_least_body_meets_contract():
    """K3's least loop body, the yardstick of K3's instruction bound, meets
    K3's contract: every element within one bf16 ulp of the plain
    version."""
    assert _least_body_worst_ulps() <= 1.0


def test_k3_least_body_error_budget():
    """The least body's polynomials over their whole ranges (g in [-2/3,
    2/3], |x| <= pi/4 and the reduction's slack): worst relative errors
    under 2^-8.5 (-2 log1p), 2^-10.7 (sin) and 2^-15.9 (cos), which add,
    the log's halved by the sqrt, to under one bf16 ulp (2^-8)."""
    g = np.linspace(-2 / 3 - 1e-6, 2 / 3 + 1e-6, 200_001)
    g = g[g != 0]
    exact = -2 * np.log1p(-g / 2)
    log_err = np.max(np.abs(g + g * g * (_LEAST_LOG[0] + _LEAST_LOG[1] * g) - exact) / np.abs(exact))
    x = np.linspace(-np.pi / 4 * 1.001, np.pi / 4 * 1.001, 200_001)
    x = x[x != 0]
    sin_err = np.max(np.abs(x + _LEAST_SIN[0] * x**3 - np.sin(x)) / np.abs(np.sin(x)))
    cos_err = np.max(np.abs(1 + x * x * (_LEAST_COS[0] + _LEAST_COS[1] * x * x) - np.cos(x)) / np.cos(x))
    assert log_err < 2**-8.5 and sin_err < 2**-10.7 and cos_err < 2**-15.9
    assert log_err / 2 + max(sin_err, cos_err) < 2**-8


@pytest.mark.parametrize("variant", ["log", "sin", "cos"])
def test_k3_least_body_polynomials_are_least(variant):
    """With one coefficient fewer in any of its three polynomials (each
    refitted), K3's least body breaks the contract somewhere."""
    fewer = {"log": {"log": (0.2548876702785492,)}, "sin": {"sin": ()}, "cos": {"cos": (-0.47847121953964233,)}}
    assert _least_body_worst_ulps(**fewer[variant]) > 1.0


def test_kernel_library_name_tracks_sources():
    """The build is keyed by the sources: a cached library of another
    source version is never loaded."""
    path = kernels.library_path()
    assert path.endswith(".so") and "libmaria_torch_kernels_" in path
    assert kernels.library_path() == path


# -- KS1 and KS2: the Wigner-d recursion of the spherical harmonic transforms --------------------


def _rescale_np(lam, lam_prev, k):
    """csrc/sht.cu ``rescale`` on float32 lanes: returns the contribution."""
    a = np.abs(lam)
    big = a > np.float32(2.0**30)
    small = (a < np.float32(2.0**-30)) & (k > 0)
    scale = np.where(big, np.float32(2.0**-60), np.where(small, np.float32(2.0**60), np.float32(1))).astype(np.float32)
    lam *= scale
    lam_prev *= scale
    k += np.where(big, -1, np.where(small, 1, 0)).astype(np.int32)
    return np.where(k == 0, lam, np.float32(0))


def _fma(a, b, c):
    """float32 fma(a, b, c), through float64 (exact products of float32)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def _emulate_lanes(t, m, fma=False):
    """One m's lanes, every ring at once, in the kernels' loop order:
    seeded at l0 = seed_step[m] (the triangle start), rescaled there, then
    one recursion step a l. Yields (l, contribution (nh,)). Every product
    and sum is rounded on its own, as the kernels and the plain version
    round them; with ``fma`` the recursion contracts as a compiler would
    ((a z + b) lam - g lam_prev as fma(fma(a, z, b), lam, -(g lam_prev)))."""
    L = t["seed_step"].shape[0]
    a_, b_, g_ = (t[k][m].numpy() for k in ("alpha", "beta", "gamma"))  # [m][l] rows
    z = t["z"].numpy()
    l0 = int(t["seed_step"][m])
    lam = t["seed_val"][m].numpy().copy()
    lam_prev = np.zeros_like(lam)
    k = t["seed_exp"][m].numpy().copy()
    yield l0, _rescale_np(lam, lam_prev, k)
    for l in range(l0 + 1, L):
        a, b, g = a_[l], b_[l], g_[l]
        if fma:
            rec = _fma(_fma(a, z, b), lam, -(g * lam_prev))
        else:
            rec = (a * z + b) * lam - g * lam_prev
        lam_prev, lam = lam, rec.astype(np.float32)
        yield l, _rescale_np(lam, lam_prev, k)


def _emulate_synth(t, rows):
    """KS1's per-lane loop: acc[s, m, r] summed from l0(m) on."""
    S, L = rows.shape[:2]
    acc = np.zeros((S, L, t["z"].shape[0]), np.float32)
    rows = rows.numpy()
    for m in range(L):
        for l, c in _emulate_lanes(t, m):
            for s in range(S):
                acc[s, m] = acc[s, m] + rows[s, l, m] * c
    return acc


def _emulate_anal(t, h, threads=256):
    """KS2's reduction order: a thread's lanes (rings tid, tid + 256, ...)
    summed in order by FMAs, the 32 threads of a warp by the butterfly,
    then the 8 warps in order."""
    S, L, nh = h.shape
    R = -(-nh // threads)
    hp = np.zeros((S, L, R * threads), np.float32)
    hp[..., :nh] = h.numpy()
    ys = np.zeros((S, L, L), np.float32)
    for m in range(L):
        for l, c in _emulate_lanes(t, m):
            cp = np.zeros(R * threads, np.float32)
            cp[:nh] = c
            for s in range(S):
                p = np.zeros(threads, np.float32)
                for j in range(R):
                    p = _fma(cp[j * threads:(j + 1) * threads], hp[s, m, j * threads:(j + 1) * threads], p)
                w = p.reshape(threads // 32, 32)
                for off in (16, 8, 4, 2, 1):
                    w = w + w[:, np.arange(32) ^ off]
                total = np.float32(0)
                for x in w[:, 0]:
                    total = np.float32(total + x)
                ys[s, l, m] = total
    return ys


@pytest.mark.parametrize("nside,lmax,spin", [(8, 30, 0), (8, 40, 2), (16, 60, -2), (16, 120, 0)])
def test_sht_synth_kernel_algorithm_matches_plain(nside, lmax, spin):
    """KS1's loop order (the triangle start at seed_step, the rescale of
    each lane with its own exponent), rounded as the kernel and the plain
    version round, gives the plain version's acc bit for bit."""
    from maria_torch.healpix.sht import lane_tables
    from maria_torch.ops.sht import sht_synth_plain

    t = lane_tables(lmax, nside, spin, "cpu")
    rows = torch.as_tensor(np.random.default_rng(lmax).standard_normal((3, lmax + 1, lmax + 1)).astype(np.float32))
    ref = sht_synth_plain(t, rows).numpy()
    np.testing.assert_array_equal(_emulate_synth(t, rows), ref)


@pytest.mark.parametrize("nside,lmax,spin", [(8, 30, 0), (33, 40, -2), (160, 20, 2)])
def test_sht_anal_kernel_algorithm_matches_plain(nside, lmax, spin):
    """KS2's reduction order (lanes a thread, warp butterfly, warps in
    order; 2 lanes a thread at nside 160) within 1e-5 of each plane's
    maximum of the plain version's sums, and zero below the seed steps."""
    from maria_torch.healpix.sht import lane_tables
    from maria_torch.ops.sht import sht_anal_plain

    t = lane_tables(lmax, nside, spin, "cpu")
    h = torch.as_tensor(np.random.default_rng(nside).standard_normal((2, lmax + 1, 2 * nside)).astype(np.float32))
    ref = sht_anal_plain(t, h).numpy()
    ours = _emulate_anal(t, h)
    for s in range(2):
        assert np.abs(ours[s] - ref[s]).max() <= 1e-5 * np.abs(ref[s]).max()
    below = np.arange(lmax + 1)[:, None] < t["seed_step"].numpy()[None, :]
    assert np.all(ref[:, below] == 0) and np.all(ours[:, below] == 0)


def test_sht_recursion_needs_the_plain_rounding():
    """Why the kernels round every product and sum on its own: at nside
    1024 and lmax 2500 (chip_smoke.py's shapes) the m = 0 lanes near the
    pole, FMA-contracted, drift from the separately rounded ones by more
    than 1e-4 of their largest value (so a contracted kernel could not be
    held to the plain version at 1e-5), while at m = 700 the two stay
    within 1e-5."""
    from maria_torch.healpix.sht import lane_tables

    t = lane_tables(2500, 1024, 0, "cpu")
    rings = np.array([0, 5, 200, 1023, 2047])
    sub = {k: t[k] for k in ("alpha", "beta", "gamma", "seed_step")}
    sub.update({"z": t["z"][rings], "seed_val": t["seed_val"][:, rings], "seed_exp": t["seed_exp"][:, rings]})
    drift = {}
    for m in (0, 700):
        plain = np.array([c for _, c in _emulate_lanes(sub, m)])
        fused = np.array([c for _, c in _emulate_lanes(sub, m, fma=True)])
        drift[m] = np.abs(fused - plain).max() / np.abs(plain).max()
    assert drift[0] > 1e-4 and drift[700] < 1e-5, drift
