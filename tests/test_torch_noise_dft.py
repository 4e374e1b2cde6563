"""The port's matrix-product noise (maria_torch/noise/dft.py) and the
plain version of kernel K3 (maria_torch/ops/shared_v.py), on CPU:

- the cosine/sine basis and ``noise_total_matmul`` against maria_tpu's
  with the same draws (maria_tpu's threefry branch, reproduced with
  jax.random and injected into the port);
- draw-exactness against numpy's irfft in float32;
- the plain K3 Philox against an independent Python-integer
  Philox4x32-10, its [re | im] layout and bf16 rounding, and the
  distribution of V / c.

Each comparison states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from maria_tpu.noise import dft as ref_dft  # noqa: E402

from maria_torch.noise import dft  # noqa: E402
from maria_torch.ops.shared_v import draw_key, philox4x32_10, shared_v, shared_v_plain  # noqa: E402

SR = 50.0
N, N_FFT = 500, 512
M1 = N_FFT // 2 + 1
BANDS = ((0, 20, 1.5e-17, 0.5), (20, 33, 2.0e-17, 0.5), (33, 57, 2.5e-17, 0.5))  # rows, NEP, knee


def test_cos_sin_basis_equals_jax():
    for n_fft, n in ((96, 90), (N_FFT, N), (3072, 3000)):
        C, S = dft.irfft_cos_sin_basis(n_fft, n)
        rC, rS = ref_dft.irfft_cos_sin_basis(n_fft, n)
        np.testing.assert_array_equal(C, rC)
        np.testing.assert_array_equal(S, rS)


def _problem(shared: bool, seed: int = 0):
    """Specs of three contiguous bands (correlated modes on the first and
    last) as maria_tpu's program builds them, for both packages."""
    rng = np.random.default_rng(seed)
    cp = 0.5
    n_det = BANDS[-1][1]
    knees = [b[3] if shared else 0.25 * (i + 1) for i, b in enumerate(BANDS)]
    ref_specs, specs, blocks = [], [], []
    k_total = 0
    for i, ((start, stop, nep, _), knee) in enumerate(zip(BANDS, knees)):
        shape = dft.band_half_spectrum(SR, knee, 1.0, N_FFT, corr_prop=cp)
        k = 5 if i != 1 else 0
        mode_c = dft.band_half_spectrum(SR, knee, 1.0, N_FFT, pink_only=True) if k else None
        kw = dict(start=start, stop=stop, c=1e12 * nep * shape, k_modes=k, mode_c=mode_c, key_index=i)
        ref_specs.append(ref_dft.NoiseBandSpec(**kw))
        specs.append(dft.NoiseBandSpec(**kw))
        if k:
            blocks.append((start, stop, k_total, nep, np.sqrt(cp) * rng.standard_normal((stop - start, k))))
            k_total += k
    corr_cols = np.zeros((n_det, k_total), np.float32)
    for start, stop, col0, nep, block in blocks:
        corr_cols[start:stop, col0:col0 + block.shape[1]] = (1.0 if shared else 1e12 * nep) * block
    extra = {}
    if shared:
        extra["shared_c"] = dft.band_half_spectrum(SR, knees[0], 1.0, N_FFT, corr_prop=cp)
        row_scale = np.zeros((n_det, 1), np.float32)
        for start, stop, nep, _ in BANDS:
            row_scale[start:stop] = 1e12 * nep
        extra["row_scale"] = row_scale
    # a signal of the noise's own scale (~2e-4 pW), so float32 rounding
    # of the sum stays far below the tolerances
    A = (2e-4 * rng.standard_normal((n_det, N))).astype(np.float32)
    return ref_specs, specs, corr_cols, extra, A


def _jax_draws(key, specs, shared: bool, n_det: int):
    """maria_tpu noise_total_matmul's threefry draws (noise/dft.py:155-185)."""
    mode_z = {}
    for sp in specs:
        if sp.k_modes:
            key_modes = jax.random.split(jax.random.fold_in(key, sp.key_index), 3)[2]
            mode_z[sp.key_index] = torch.as_tensor(
                np.array(jax.random.normal(key_modes, (sp.k_modes, 2, M1), dtype=jnp.float32)))
    if shared:
        z = np.array(jax.random.normal(key, (n_det, 2, M1), dtype=jnp.float32))
    else:
        z = np.concatenate([
            np.asarray(jax.random.normal(jax.random.split(jax.random.fold_in(key, sp.key_index), 3)[1],
                                         (sp.stop - sp.start, 2, M1), dtype=jnp.float32))
            for sp in specs
        ])
    return torch.as_tensor(z), mode_z


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_noise_total_matmul_matches_jax(shared, dtype):
    """The port's total equals maria_tpu's given the same draws: to 1e-5
    of the noise std with float32 operands (the product's summation order
    differs). In bfloat16 the operands are rounded alike on both sides;
    the float32 mode time series, rounded to bf16 in B, can flip one
    rounding where the two float32 products differ in the last bit, so
    99.9% of the samples hold 1e-5 of the std and every one 1e-2."""
    ref_specs, specs, corr_cols, extra, A = _problem(shared)
    key = jax.random.key(3)
    n_det = specs[-1].stop
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = np.asarray(ref_dft.noise_total_matmul(
        key, jnp.asarray(A), ref_specs, n=N, n_fft=N_FFT, corr_cols=corr_cols, basis_dtype=jdt, **extra))
    z, mode_z = _jax_draws(key, specs, shared, n_det)
    ours = dft.noise_total_matmul(
        torch.as_tensor(A), specs, n=N, n_fft=N_FFT, corr_cols=corr_cols, z=z, mode_z=mode_z,
        basis_dtype=getattr(torch, dtype), **extra).numpy()
    std = float((ref - A).std())
    err = np.abs(ours - ref)
    if dtype == "float32":
        assert err.max() <= 1e-5 * std, err.max() / std
    else:
        assert np.mean(err <= 1e-5 * std) >= 0.999, np.mean(err <= 1e-5 * std)
        assert err.max() <= 1e-2 * std, err.max() / std


def test_noise_total_matmul_is_draw_exact():
    """Float32 operands: the total is A plus numpy's irfft of the same
    draws, to 2e-4 of the largest value (as tests/test_noise_dft.py)."""
    ref_specs, specs, corr_cols, extra, A = _problem(shared=False, seed=1)
    specs = [dft.NoiseBandSpec(sp.start, sp.stop, sp.c, key_index=sp.key_index) for sp in specs]
    z = torch.as_tensor(np.random.default_rng(4).standard_normal((specs[-1].stop, 2, M1)).astype(np.float32))
    total = dft.noise_total_matmul(torch.as_tensor(A), specs, n=N, n_fft=N_FFT, z=z,
                                   basis_dtype=torch.float32).numpy()
    zn = z.numpy()
    rows = [np.fft.irfft(np.asarray(sp.c) * (zn[sp.start:sp.stop, 0] + 1j * zn[sp.start:sp.stop, 1]),
                         n=N_FFT, axis=-1)[:, :N] for sp in specs]
    ref = A + np.concatenate(rows)
    np.testing.assert_allclose(total, ref, rtol=0, atol=2e-4 * np.abs(ref).max())


def _philox_int(ctr, key):
    """Philox4x32-10 on Python integers (Salmon et al. 2011)."""
    M = 0xFFFFFFFF
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0) & M, p1 & M, ((p0 >> 32) ^ c3 ^ k1) & M, p0 & M
        k0, k1 = (k0 + 0x9E3779B9) & M, (k1 + 0xBB67AE85) & M
    return c0, c1, c2, c3


def test_philox_matches_python_integers():
    """The int64-torch Philox equals a Python-integer one bit for bit, on
    random counters and keys and on the published known-answer vector
    (counter and key all zero)."""
    assert _philox_int((0, 0, 0, 0), (0, 0)) == (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)
    rng = np.random.default_rng(0)
    ctr = rng.integers(0, 1 << 32, (4, 257), dtype=np.int64)
    for key in ((0, 0), (0xFFFFFFFF, 0xFFFFFFFF), tuple(int(k) for k in rng.integers(0, 1 << 32, 2))):
        ours = philox4x32_10(tuple(torch.as_tensor(c) for c in ctr), key)
        for j in range(ctr.shape[1]):
            assert tuple(int(o[j]) for o in ours) == _philox_int(tuple(int(c[j]) for c in ctr), key)


def test_plain_shared_v_layout_and_draw():
    """shared_v_plain's V against its documented layout computed here
    from the Python Philox: row r, bin k = 2p + q of realization b takes
    counter (p, r, b, 0) and words (2q, 2q + 1); V[b, r, k] is
    bf16(c_k r cos t), V[b, r, m1 + k] is bf16(c_k r sin t). Box-Muller
    here runs in numpy float32, whose log and cos may differ from
    torch's in the last float32 bit: every value within one bf16 ulp,
    nearly all bit-identical."""
    m1, n_det, batch = 7, 3, 2
    c = np.linspace(0.5, 3.0, m1).astype(np.float32)
    key = torch.tensor([0x12345678, 0x9ABCDEF0], dtype=torch.int64)
    V = shared_v_plain(key, c, n_det, batch=batch).float().numpy()
    assert V.shape == (batch, n_det, 2 * m1)
    want = np.zeros_like(V)
    for b in range(batch):
        for r in range(n_det):
            for k in range(m1):
                x = _philox_int((k // 2, r, b, 0), (0x12345678, 0x9ABCDEF0))
                a, bb = x[2 * (k % 2)], x[2 * (k % 2) + 1]
                u1 = (np.float32(a >> 8) + np.float32(0.5)) * np.float32(2.0**-24)
                u2 = (np.float32(bb >> 8) + np.float32(0.5)) * np.float32(2.0**-24)
                rad = np.sqrt(np.float32(-2.0) * np.log(u1))
                theta = np.float32(2 * np.pi) * u2
                want[b, r, k] = c[k] * (rad * np.cos(theta))
                want[b, r, m1 + k] = c[k] * (rad * np.sin(theta))
    want = torch.as_tensor(want).to(torch.bfloat16).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(V - want) <= ulp)
    assert np.mean(V == want) >= 0.9


def test_injected_v_layout_and_rounding():
    """With an injected draw z (n_det, 2, m+1), V is bf16(c * z) rounded
    to nearest even, columns [re | im], exactly as maria_tpu forms it."""
    rng = np.random.default_rng(5)
    z = rng.standard_normal((4, 2, 9)).astype(np.float32)
    c = rng.uniform(0.5, 2.0, 9).astype(np.float32)
    V = shared_v_plain(c=c, z=torch.as_tensor(z))[0]
    ref = np.asarray((jnp.asarray(z) * jnp.asarray(c)).reshape(4, 18).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(V.float().numpy(), ref)
    np.testing.assert_array_equal(V[:, :9].float().numpy(), torch.as_tensor(z[:, 0] * c).to(torch.bfloat16).float())
    np.testing.assert_array_equal(V[:, 9:].float().numpy(), torch.as_tensor(z[:, 1] * c).to(torch.bfloat16).float())


def test_shared_v_distribution_and_seeding():
    """V / c over 4096 rows: every column's mean and variance within 5
    sigma of N(0, 1) (sigma 1/64 and sqrt(2/4096)). The same generator
    state gives the same V; the next draw differs."""
    m1, n_det = 129, 4096
    c = np.linspace(0.5, 4.0, m1).astype(np.float32)
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    V = shared_v(draw_key(gen), c, n_det)[0]
    x = V.double().numpy() / np.concatenate([c, c])
    assert np.all(np.abs(x.mean(axis=0)) <= 5 / np.sqrt(n_det))
    assert np.all(np.abs(x.var(axis=0) - 1) <= 5 * np.sqrt(2 / n_det))
    gen.set_state(state)
    assert torch.equal(shared_v(draw_key(gen), c, n_det)[0], V)
    assert not torch.equal(shared_v(draw_key(gen), c, n_det)[0], V)


def test_shared_v_writes_into_a_wider_buffer():
    """With ``out`` of row stride ld > 2(m+1), K3 fills the first 2(m+1)
    columns and leaves the rest (the matmul's basis columns) untouched."""
    c = np.ones(5, np.float32)
    key = torch.tensor([1, 2], dtype=torch.int64)
    out = torch.full((1, 3, 13), 7.0, dtype=torch.bfloat16)
    V = shared_v(key, c, 3, out=out)
    assert torch.equal(V, shared_v_plain(key, c, 3))
    assert torch.all(out[..., 10:] == 7.0)


def test_noise_total_matmul_needs_a_device_without_a_card():
    """Given neither a device nor a tensor A, noise_total_matmul computes
    on the card and raises where there is none; it never falls back to
    the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, specs, corr_cols, extra, _ = _problem(shared=True)
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        dft.noise_total_matmul(0.0, specs, n=N, n_fft=N_FFT, corr_cols=corr_cols, **extra)


def test_noise_total_matmul_on_the_cpu_when_asked():
    """device="cpu" (with a scalar A) computes on the CPU, the same total
    as a CPU tensor A gives from the same draws."""
    _, specs, corr_cols, extra, _ = _problem(shared=True)
    n_det = specs[-1].stop
    g = torch.Generator().manual_seed(5)
    z = torch.randn((n_det, 2, M1), generator=g)
    mode_z = [torch.randn((sp.k_modes, 2, M1), generator=g) if sp.k_modes else None for sp in specs]
    kw = dict(n=N, n_fft=N_FFT, corr_cols=corr_cols, z=z, mode_z=mode_z, basis_dtype=torch.float32, **extra)
    ours = dft.noise_total_matmul(0.0, specs, device="cpu", **kw)
    assert ours.device.type == "cpu" and ours.shape == (n_det, N)
    np.testing.assert_array_equal(ours.numpy(), dft.noise_total_matmul(torch.zeros((n_det, N)), specs, **kw).numpy())
