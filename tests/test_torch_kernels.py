"""The port's two kernels, K1 pink_noise and K2 bin_map.

On the CPU the wrappers run their plain torch versions; those are held
against the JAX package's Pallas kernels run in interpret mode, and
against the scatter references. The kernels themselves are held against
the plain versions on a card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from maria_torch.noise import band_half_spectrum  # noqa: E402
from maria_torch.ops import kernels  # noqa: E402
from maria_torch.ops.bin_map import bin_map, bin_map_plain  # noqa: E402
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


def test_kernel_library_name_tracks_sources():
    """The build is keyed by the sources: a cached library of another
    source version is never loaded."""
    path = kernels.library_path()
    assert path.endswith(".so") and "libmaria_torch_kernels_" in path
    assert kernels.library_path() == path
