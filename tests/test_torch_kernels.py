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
from maria_torch.ops.pink_noise import pink_consts, pink_noise, pink_noise_plain  # noqa: E402
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
    """The port's host constants (alpha, gamma and the split) are the
    Pallas kernel's."""
    c = _weights(n_fft).astype(np.float32)
    ours = pink_consts(n_fft, c)
    ref = pallas_noise.pink_consts(n_fft, tuple(c.tolist()))
    m = n_fft // 2
    if ref["mode"] == "split":
        assert (ours["n1"], ours["n2"]) == (ref["n1"], ref["n2"])

        def unperm(planes):  # (re/im, n2, n1) -> linear k = k2 + n2*k1
            return (planes[0] + 1j * planes[1]).T.reshape(m)
    else:
        assert (ours["n1"], ours["n2"]) == (m, 1)

        def unperm(planes):
            return planes[0] + 1j * planes[1]
    np.testing.assert_allclose(ours["alpha"], unperm(ref["ag"][0]), rtol=1e-6, atol=1e-6 * np.abs(c).max())
    np.testing.assert_allclose(ours["gamma"], unperm(ref["ag"][1]), rtol=1e-6, atol=1e-6 * np.abs(c).max())


def _split_emulation(c, S, n, n_fft):
    """numpy emulation of csrc/pink_noise.cu's algorithm: fold the draw
    into one m-point DFT input, n1-point DFTs, twiddle, n2-point DFTs."""
    k = pink_consts(n_fft, c)
    m, n1, n2 = k["m"], k["n1"], k["n2"]
    out = np.zeros((S.shape[0], n))
    kk = np.arange(m)
    kr = (m - kk) % m
    a, k2 = np.arange(n1), np.arange(n2)
    for r in range(S.shape[0]):
        z = S[r, :m, 0] + 1j * S[r, :m, 1]
        z[0] = S[r, 0, 0] + 1j * S[r, m, 0]
        u = k["alpha"] * z + np.conj(k["gamma"][kr] * z[kr])
        A = np.exp(2j * np.pi * np.outer(a, a) / n1).T @ u.reshape(n1, n2)
        B = A * np.exp(2j * np.pi * np.outer(a, k2) / m) / m
        y = (B @ np.exp(2j * np.pi * np.outer(k2, k2) / n2)).T.reshape(-1)
        out[r] = np.stack([y.real, y.imag], -1).reshape(-1)[:n]
    return out


@pytest.mark.parametrize("n,n_fft", [(3000, 3072), (500, 512), (30000, 32768)])
def test_pink_kernel_algorithm_matches_plain(n, n_fft):
    """The CUDA kernel's split-DFT algorithm, emulated in numpy, equals
    the plain version at the slice's lengths."""
    rng = np.random.default_rng(3)
    c = band_half_spectrum(50.0, 5.0, 1.0, n_fft, corr_prop=0.5).astype(np.float32)
    S = rng.standard_normal((2, n_fft // 2 + 1, 2)).astype(np.float32)
    ref = pink_noise_plain(c, torch.as_tensor(S), n, n_fft).numpy()
    np.testing.assert_allclose(_split_emulation(c, S, n, n_fft), ref, atol=2e-4 * ref.std())


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
