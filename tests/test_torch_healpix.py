"""The port's HEALPix pixelization and spherical harmonic transforms
against maria_tpu's, on the CPU, where maria_tpu runs its transforms on
its native C++ recursion and the port its plain torch versions of
kernels KS1 and KS2 (``maria_torch/ops/sht.py``). Inputs are made with
numpy from a seed and handed to both; each comparison states its
tolerance. Sizes stay small: nside <= 64, lmax <= 128.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import maria_tpu.healpix.core as ref_core  # noqa: E402
import maria_tpu.healpix.sht as ref_sht  # noqa: E402

import maria_torch.healpix.core as core  # noqa: E402
import maria_torch.healpix.sht as sht  # noqa: E402

NSIDES = [1, 4, 8, 33, 64]


def _close(ours, ref, rel=1e-5):
    """Max |ours - ref| within ``rel`` of max |ref|."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0 and np.abs(ours - ref).max() <= rel * scale, np.abs(ours - ref).max() / scale


# -- pixelization -------------------------------------------------------------------------


@pytest.mark.parametrize("nside", NSIDES)
def test_ring_tables_and_pix2ang_are_exact(nside):
    ours, ref = core.ring_info(nside), ref_core.ring_info(nside)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    pix = np.arange(core.nside2npix(nside))
    for a, b in zip(core.pix2ang_ring(nside, pix), ref_core.pix2ang_ring(nside, pix)):
        np.testing.assert_array_equal(a, b)
    assert core.npix2nside(12 * nside**2) == nside
    with pytest.raises(ValueError, match="not a valid HEALPix"):
        core.npix2nside(12 * nside**2 + 1)


@pytest.mark.parametrize("nside", [1, 2, 16, 64])
def test_nest2ring_ring2nest_and_reorder_are_exact(nside):
    pix = np.arange(core.nside2npix(nside))
    np.testing.assert_array_equal(core.nest2ring(nside, pix), ref_core.nest2ring(nside, pix))
    np.testing.assert_array_equal(core.ring2nest(nside, pix), ref_core.ring2nest(nside, pix))
    m = np.random.default_rng(nside).standard_normal((2, len(pix)))
    for kw in ({"n2r": True}, {"r2n": True}):
        np.testing.assert_array_equal(core.reorder(m, **kw), ref_core.reorder(m, **kw))
    with pytest.raises(ValueError, match="power-of-2"):
        core.nest2ring(3, [0])


@pytest.mark.parametrize("nside", [8, 33, 64, 1024])
def test_ang2pix_ring_on_float32_angles(nside):
    """Both packages' float32 evaluation of the same float32 angles: the
    same pixel except where the two round a coordinate to opposite sides
    of a pixel edge, which happens for at most 1 sample in 10^4 here; and
    each of those lands in a neighbour of the other's pixel."""
    rng = np.random.default_rng(nside)
    n = 200_000
    theta = np.arccos(rng.uniform(-1, 1, n)).astype(np.float32)
    phi = rng.uniform(-np.pi, 3 * np.pi, n).astype(np.float32)
    ref = np.asarray(ref_core.ang2pix_ring(nside, theta, phi))
    ours = core.ang2pix_ring(nside, torch.as_tensor(theta), torch.as_tensor(phi))
    assert ours.dtype == torch.int32
    ours = ours.numpy()
    differ = ours != ref
    assert differ.mean() <= 1e-4, differ.sum()
    if differ.any():
        t_o, p_o = ref_core.pix2ang_ring(nside, ours[differ])
        t_r, p_r = ref_core.pix2ang_ring(nside, ref[differ])
        cos_sep = np.cos(t_o) * np.cos(t_r) + np.sin(t_o) * np.sin(t_r) * np.cos(p_o - p_r)
        assert np.arccos(np.clip(cos_sep, -1, 1)).max() < 3 * np.sqrt(4 * np.pi / core.nside2npix(nside))
    # pixel centres map to themselves
    pix = np.arange(core.nside2npix(min(nside, 64)))
    t, p = core.pix2ang_ring(min(nside, 64), pix)
    back = core.ang2pix_ring(min(nside, 64), torch.as_tensor(t, dtype=torch.float64), torch.as_tensor(p))
    np.testing.assert_array_equal(back.numpy(), pix)


# -- host tables -------------------------------------------------------------------------


@pytest.mark.parametrize("spin", [0, 2, -2])
@pytest.mark.parametrize("lmax,nside", [(40, 16), (128, 64), (200, 33)])
def test_recursion_seed_and_sign_tables_are_bit_equal(lmax, nside, spin):
    for ours, ref in zip(sht._recursion_tables(lmax, spin), ref_sht._recursion_tables(lmax, spin)):
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours, ref)
    for ours, ref in zip(sht._seed_tables(lmax, nside, spin), ref_sht._seed_tables(lmax, nside, spin)):
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
    for ours, ref in zip(sht._sign_tables_np(lmax), ref_sht._sign_tables_np(lmax)):
        np.testing.assert_array_equal(ours, ref)
    ours, ref = sht._host_tables(lmax, nside, spin), ref_sht._host_tables(lmax, nside, spin)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    bt, ref_bt = sht._belt_tables(nside, lmax), ref_sht._belt_tables(nside, lmax)
    assert {k: v for k, v in bt.items() if k != "phase"} == {k: v for k, v in ref_bt.items() if k != "phase"}
    np.testing.assert_array_equal(bt["phase"], ref_bt["phase"])


def test_lane_tables_hold_the_kernels_layout():
    """alpha, beta, gamma transposed to [m, l]; the seeds as they are, the
    exponents and seed steps int32."""
    t = sht.lane_tables(30, 8, 2, "cpu")
    a, b, g = sht._recursion_tables(30, 2)
    for k, ref in (("alpha", a), ("beta", b), ("gamma", g)):
        assert t[k].is_contiguous() and t[k].dtype == torch.float32
        np.testing.assert_array_equal(t[k].numpy(), ref.T)
    assert t["seed_exp"].dtype == t["seed_step"].dtype == torch.int32
    assert sht.lane_tables(30, 8, 2, "cpu") is t


def test_check_lmax():
    with pytest.raises(ValueError, match="alias"):
        sht.alm2map(np.zeros((65, 65), np.complex64), 16, device="cpu")


# -- random a_lm -------------------------------------------------------------------------------


def test_synalm_and_synalm_cmb_are_bit_equal():
    from maria_tpu.cmb import get_cmb_spectrum

    cl = 1.0 / (np.arange(101) + 1.0) ** 2
    np.testing.assert_array_equal(sht.synalm(cl, seed=5), ref_sht.synalm(cl, seed=5))
    np.testing.assert_array_equal(sht.synalm(cl, lmax=140, seed=6), ref_sht.synalm(cl, lmax=140, seed=6))
    spectra = get_cmb_spectrum(lmax=120)
    for ours, ref in zip(sht.synalm_cmb(spectra, 120, seed=9), ref_sht.synalm_cmb(spectra, 120, seed=9)):
        np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(sht.alm_index(7)[0], ref_sht.alm_index(7)[0])


def test_synalm_cmb_device_carries_the_spectra():
    """The torch draw: m = 0 real, zero above the diagonal, and by
    distribution over l in [50, 250) the TT, EE and BB power within 3% of
    the input and the TE correlation within 0.05 of it (~40,000 modes a
    spectrum: a few tenths of a percent of sampling error)."""
    lmax = 256
    ells = np.arange(lmax + 1, dtype=float)
    TT, EE, TE, BB = (np.zeros(lmax + 1) for _ in range(4))
    TT[2:], EE[2:], TE[2:], BB[2:] = 1.0 / ells[2:] ** 2, 0.3 / ells[2:] ** 2, 0.4 / ells[2:] ** 2, 0.05 / ells[2:] ** 2
    gen = torch.Generator().manual_seed(3)
    aT, aE, aB = sht.synalm_cmb_device({"TT": TT, "EE": EE, "TE": TE, "BB": BB}, lmax, generator=gen)
    assert aT.dtype == torch.complex64 and aT.device.type == "cpu"
    for a in (aT, aE, aB):
        assert float(a[:, 0].imag.abs().max()) == 0.0
        assert float(torch.triu(a.abs(), diagonal=1).max()) == 0.0
    sl = slice(50, 250)
    w = np.ones(lmax + 1)
    w[0] = 0.5  # m = 0 counted once

    def power(x, y):
        return float((torch.as_tensor(w) * (x[sl] * y[sl].conj()).real.double()).sum() * 2)

    n_modes = float((2 * ells[sl] + 1).sum())
    for a, cl in ((aT, TT), (aE, EE), (aB, BB)):
        assert abs(power(a, a) / float((cl[sl] * (2 * ells[sl] + 1)).sum()) - 1) < 0.03
    r = power(aT, aE) / np.sqrt(power(aT, aT) * power(aE, aE))
    assert abs(r - 0.4 / np.sqrt(0.3)) < 0.05 and n_modes > 40000
    assert abs(power(aT, aB)) / np.sqrt(power(aT, aT) * power(aB, aB)) < 0.05


# -- the transforms against maria_tpu ----------------------------------------------------------


@pytest.fixture(scope="module")
def alms():
    lmax = 128
    cl = 1.0 / (np.arange(lmax + 1) + 1.0) ** 2
    return {"a": ref_sht.synalm(cl, seed=1), "e": ref_sht.synalm(cl, seed=2),
            "b": ref_sht.synalm(0.3 * cl, seed=3), "lmax": lmax}


@pytest.mark.parametrize("nside", [33, 64])
def test_alm2map_and_map2alm_match(alms, nside):
    """The scalar transforms through plain KS1/KS2 against maria_tpu's
    native recursion: 1e-5 of each output's maximum."""
    a, lmax = alms["a"], min(alms["lmax"], 4 * nside - 1)
    a = a[: lmax + 1, : lmax + 1]
    ref = np.array(ref_sht.alm2map(a, nside))
    ours = sht.alm2map(a, nside, device="cpu")
    assert ours.dtype == torch.float32 and ours.shape == (core.nside2npix(nside),)
    _close(ours, ref)
    _close(sht.map2alm(torch.as_tensor(ref), lmax), ref_sht.map2alm(ref, lmax))


@pytest.mark.parametrize("nside", [33, 64])
def test_alm2map_spin_and_map2alm_spin_match(alms, nside):
    e, b, lmax = alms["e"], alms["b"], min(alms["lmax"], 4 * nside - 1)
    e, b = e[: lmax + 1, : lmax + 1], b[: lmax + 1, : lmax + 1]
    ref = [np.array(x) for x in ref_sht.alm2map_spin(e, b, nside)]
    ours = sht.alm2map_spin(e, b, nside, device="cpu")
    for x, y in zip(ours, ref):
        _close(x, y)
    ref_eb = ref_sht.map2alm_spin(*ref, lmax)
    for x, y in zip(sht.map2alm_spin(*(torch.as_tensor(r) for r in ref), lmax), ref_eb):
        assert x.dtype == torch.complex64
        _close(x, np.asarray(y))


def test_batched_forms_match_the_loop(alms):
    """A leading batch dimension gives what one call per item gives, bit
    for bit (the same steps)."""
    nside, lmax = 16, 40
    a = np.stack([alms[k][: lmax + 1, : lmax + 1] for k in ("a", "e", "b")])
    maps = sht.alm2map(a, nside, device="cpu")
    assert maps.shape == (3, core.nside2npix(nside))
    for i in range(3):
        np.testing.assert_array_equal(maps[i].numpy(), sht.alm2map(a[i], nside, device="cpu").numpy())
    back = sht.map2alm(maps, lmax)
    for i in range(3):
        np.testing.assert_array_equal(back[i].numpy(), sht.map2alm(maps[i], lmax).numpy())
    Q, U = sht.alm2map_spin(a[:2], a[1:], nside, device="cpu")
    E, B = sht.map2alm_spin(Q, U, lmax)
    for i in range(2):
        q, u = sht.alm2map_spin(a[i], a[i + 1], nside, device="cpu")
        np.testing.assert_array_equal(Q[i].numpy(), q.numpy())
        np.testing.assert_array_equal(U[i].numpy(), u.numpy())
        e, b = sht.map2alm_spin(q, u, lmax)
        np.testing.assert_array_equal(E[i].numpy(), e.numpy())
        np.testing.assert_array_equal(B[i].numpy(), b.numpy())


def test_scalar_synthesis_against_scipy():
    """The scipy sph_harm_y oracle (tests/test_sht_spin.py): 1e-4 of the
    map's std."""
    from scipy.special import sph_harm_y

    lmax, nside = 8, 16
    alm = sht.synalm(np.ones(lmax + 1), seed=3)
    theta, phi = core.pix2ang_ring(nside, np.arange(core.nside2npix(nside)))
    T = np.zeros(len(theta))
    for l in range(lmax + 1):
        T += (alm[l, 0] * sph_harm_y(l, 0, theta, phi)).real
        for m in range(1, l + 1):
            T += 2 * (alm[l, m] * sph_harm_y(l, m, theta, phi)).real
    ours = sht.alm2map(alm, nside, device="cpu").numpy()
    assert np.abs(ours - T).max() / T.std() < 1e-4


def test_spin2_round_trip_keeps_e_and_b_apart():
    lmax, nside = 24, 32
    aE, aB = sht.synalm(np.ones(lmax + 1) * 1e-2, seed=5), sht.synalm(np.ones(lmax + 1) * 3e-3, seed=6)
    aE[:2] = aB[:2] = 0
    E, B = (x.numpy() for x in sht.map2alm_spin(*sht.alm2map_spin(aE, aB, nside, device="cpu"), lmax))
    for x, y in ((aE, E), (aB, B)):
        np.testing.assert_allclose((np.abs(x) ** 2)[2:16].sum(1), (np.abs(y) ** 2)[2:16].sum(1), rtol=0.05)
    assert (np.abs(B - aB) ** 2)[2:16].sum() / (np.abs(aE) ** 2)[2:16].sum() < 1e-3


def test_transforms_need_a_device_without_tensors():
    """numpy inputs go to the card unless told otherwise: without a card
    that raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        sht.alm2map(np.zeros((9, 9), np.complex64), 4)
