"""The port's covariance kernels, generic math and utilities against
maria_tpu on the CPU (maria_tpu/functions, utils/__init__.py,
utils/linalg.py, utils/rotations.py, noise.generate_2d_fourier_noise,
ops/interp.py's RegularGridInterpolator and interp_1d).

Seeded numpy inputs go through both packages. Host numpy names are held
exact, or at 1e-12 in float64; device functions at 1e-6 relative in
float32; the 2-D Fourier noise by its distribution (torch's generator
and jax's draw different normals).
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import maria_tpu.functions as tpu_functions  # noqa: E402
import maria_tpu.utils as tpu_utils  # noqa: E402
import maria_tpu.utils.linalg as tpu_linalg  # noqa: E402
import maria_tpu.utils.rotations as tpu_rotations  # noqa: E402

import maria_torch.functions as functions  # noqa: E402
import maria_torch.utils as utils  # noqa: E402
import maria_torch.utils.linalg as linalg  # noqa: E402
import maria_torch.utils.rotations as rotations  # noqa: E402


def rng(seed=0):
    return np.random.default_rng(seed)


def assert_rel(ours, ref, rtol, floor=0.0):
    """|ours - ref| <= rtol * max(|ref|, floor), elementwise."""
    ours, ref = np.asarray(ours, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref) / np.maximum(np.abs(ref), floor)
    assert err.max() <= rtol, f"worst relative error {err.max():.3e}"


# -- functions ---------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["sigmoid", "inverse_sigmoid", "matern_three_halves", "matern_five_halves"])
def test_scalar_kernels(name):
    x = rng().uniform(0.01, 0.99, 257) if name == "inverse_sigmoid" else rng().uniform(-3, 5, 257)
    if name.startswith("matern"):
        x = np.abs(x)
    np.testing.assert_allclose(getattr(functions, name)(x), getattr(tpu_functions, name)(x), rtol=1e-12, atol=0)


@pytest.mark.parametrize("nu", [1 / 3, 5 / 6, 1.5])
def test_matern_family(nu):
    r = np.geomspace(1e-4, 50, 300)
    np.testing.assert_allclose(functions.matern(r, 2.0, nu), tpu_functions.matern(r, 2.0, nu), rtol=1e-12)
    np.testing.assert_allclose(functions.normalized_matern(r, nu), tpu_functions.normalized_matern(r, nu),
                               rtol=1e-12)
    np.testing.assert_allclose(functions.approximate_normalized_matern(r, nu=nu, r0=3.0),
                               tpu_functions.approximate_normalized_matern(r, nu=nu, r0=3.0), rtol=1e-12, atol=1e-300)
    k = np.geomspace(1e-3, 10, 50)
    np.testing.assert_allclose(functions.matern_spectral_density(k, nu, 2.0, 3),
                               tpu_functions.matern_spectral_density(k, nu, 2.0, 3), rtol=1e-12)


def test_radiometry_is_one_module():
    """maria_torch.radiometry (the earlier path) and functions.radiometry
    hold the same objects, and the spectra equal maria_tpu's."""
    import maria_torch.radiometry as old
    from maria_torch.functions import radiometry

    for name in ("planck_spectrum", "inverse_planck_spectrum", "rayleigh_jeans_spectrum",
                 "inverse_rayleigh_jeans_spectrum"):
        assert getattr(old, name) is getattr(radiometry, name) is getattr(functions, name)
    nu = np.geomspace(30e9, 1e12, 64)
    np.testing.assert_allclose(functions.planck_spectrum(2.7, nu), tpu_functions.planck_spectrum(2.7, nu), rtol=1e-12)
    T = functions.inverse_planck_spectrum(functions.planck_spectrum(10.0, nu), nu)
    np.testing.assert_allclose(T, 10.0, rtol=1e-10)


@pytest.mark.parametrize("nu, r0", [(5 / 6, 300.0), (1 / 3, 1.0), (1.5, 40.0)])
def test_matern_interpolator(nu, r0):
    """On a tensor's device in float32: within 1e-6 of maria_tpu's
    (float32 jnp) and within maria_tpu's own 1e-5 of the host float64
    (tests/test_functions.py::test_matern_interpolator_matches_host)."""
    from maria_tpu.functions import MaternInterpolator as TpuInterp

    r = np.concatenate([np.geomspace(1e-3, 30, 256) * r0 / 300, rng().uniform(0, 3 * r0, 512), [0.0, 2e3 * r0]])
    ours = functions.MaternInterpolator(nu=nu, r0=r0)(torch.as_tensor(r, dtype=torch.float32))
    assert ours.dtype == torch.float32 and ours.device.type == "cpu"
    np.testing.assert_array_equal(functions.MaternInterpolator(nu=nu, r0=r0)(r, device="cpu").numpy(), ours.numpy())
    ref = np.asarray(TpuInterp(nu=nu, r0=r0)(r.astype(np.float32)))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6)
    host = functions.approximate_normalized_matern(r, nu=nu, r0=r0)
    assert np.abs(ours.numpy() - host).max() < 1e-5


# -- utils -------------------------------------------------------------------------------------


def test_utils_names_are_one_object():
    """The Matérn helpers, rotations and linear algebra under utils are
    the same objects as in their modules."""
    assert utils.matern_five_halves is functions.matern_five_halves
    assert utils.approximate_normalized_matern is functions.approximate_normalized_matern
    assert utils.rotation_matrix_2d is rotations.rotation_matrix_2d
    assert utils.principal_angle_2d is rotations.principal_angle_2d
    assert utils.fast_psd_inverse is linalg.fast_psd_inverse
    assert utils.pointing_indices_and_weights is linalg.pointing_indices_and_weights
    assert linalg.compute_pointing_matrix_ingredients is linalg.pointing_indices_and_weights


@pytest.mark.parametrize("n, lazy, max_sample", [(500, False, 10000), (500, True, 100), (30000, False, 10000),
                                                 (3000, False, 1000)])
def test_compute_diameter(n, lazy, max_sample):
    points = rng(n).normal(size=(n, 2))
    assert utils.compute_diameter(points, lazy=lazy, MAX_SAMPLE_SIZE=max_sample) == tpu_utils.compute_diameter(
        points, lazy=lazy, MAX_SAMPLE_SIZE=max_sample)


def test_time_and_number_helpers():
    for s in (2e-4, 0.5, 42.0, 3725.0, 90000.0):
        assert utils.humanize_time(s) == tpu_utils.humanize_time(s)
    assert utils.grouper(range(7), 3) == tpu_utils.grouper(range(7), 3) == [[0, 1, 2], [3, 4, 5], [6]]
    for t in (1.75e9, 1.0e9, 1.7e9 + 12345.6):
        assert utils.get_utc_year(t) == tpu_utils.get_utc_year(t)
        assert utils.get_utc_day_hour(t) == tpu_utils.get_utc_day_hour(t)
        assert utils.utc_year_day(t) == tpu_utils.utc_year_day(t)
    x = np.array([0.0, 0.001, 0.25, 1234.5678])
    assert utils.compute_resolution_precision(x) == tpu_utils.compute_resolution_precision(x)
    np.testing.assert_array_equal(utils.round_sig_figs(x, 3), tpu_utils.round_sig_figs(x, 3))
    for val in (1.0, "2.5", "abc", [1, 2], None):
        assert utils.is_numeric(val) == tpu_utils.is_numeric(val)
    np.testing.assert_array_equal(utils.is_integer([1.0, 1.5, 2]), tpu_utils.is_integer([1.0, 1.5, 2]))
    for key, nd in ((Ellipsis, 3), ((0, Ellipsis), 4), (slice(1, 2), 2), ((1, 2), 3)):
        assert utils.unpack_implicit_slice(key, nd) == tpu_utils.unpack_implicit_slice(key, nd)
    bins = np.linspace(0, 10, 11)
    xs = rng().uniform(-2, 12, 100)
    np.testing.assert_array_equal(utils.regular_digitization(xs, bins), tpu_utils.regular_digitization(xs, bins))


def test_angle_helpers():
    for args in ((10, 30, 15.5), (-5, 0, 0), (0, 59, 59.9)):
        assert utils.dms_to_rad(*args) == tpu_utils.dms_to_rad(*args)
        assert utils.hms_to_rad(*args) == tpu_utils.hms_to_rad(*args)
        assert utils.dms_to_deg(*args) == tpu_utils.dms_to_deg(*args)
    for x in (123.456789, -0.5, 359.99999):
        assert utils.deg_to_signed_dms(x) == tpu_utils.deg_to_signed_dms(x)
        assert utils.deg_to_signed_hms(x) == tpu_utils.deg_to_signed_hms(x)
    p = rng().uniform(0, 2 * np.pi, (4, 10))
    t = rng(1).uniform(-1.5, 1.5, (4, 10))
    np.testing.assert_allclose(utils.great_circle_distance(p[0], t[0], p[1], t[1]),
                               tpu_utils.great_circle_distance(p[0], t[0], p[1], t[1]), rtol=1e-12)
    np.testing.assert_array_equal(utils.hav(p), tpu_utils.hav(p))


def test_timer(caplog):
    logger = logging.getLogger("maria_torch")
    logger.setLevel(logging.DEBUG)
    try:
        with caplog.at_level(logging.DEBUG, logger="maria_torch"), utils.Timer(logger, "a step") as timer:
            pass
    finally:
        logger.setLevel(logging.WARNING)
    assert timer.duration >= 0 and "a step in" in caplog.text


def test_rotations():
    a = rng().uniform(-np.pi, np.pi, 5)
    np.testing.assert_array_equal(rotations.rotation_matrix_2d(a), tpu_rotations.rotation_matrix_2d(a))
    np.testing.assert_array_equal(rotations.get_rotation_matrix_2d(a), tpu_rotations.get_rotation_matrix_2d(a))
    np.testing.assert_array_equal(rotations.rotation_matrix_3d(z=0.3, x=0.2),
                                  tpu_rotations.rotation_matrix_3d(z=0.3, x=0.2))
    np.testing.assert_array_equal(rotations.get_rotation_matrix_3d(z=a, y=0.4),
                                  tpu_rotations.get_rotation_matrix_3d(z=a, y=0.4))
    np.testing.assert_allclose(rotations.get_orthogonal_transform([True, True, False], [0.7]),
                               tpu_rotations.get_orthogonal_transform([True, True, False], [0.7]), rtol=1e-12)
    with pytest.raises(ValueError):
        rotations.get_orthogonal_transform([True, True, True], [0.1])
    pts = rng().normal(size=(200, 3)) * [3.0, 1.0, 0.5]
    assert rotations.principal_angle_2d(pts[:, :2]) == tpu_rotations.principal_angle_2d(pts[:, :2])
    np.testing.assert_array_equal(rotations.compute_aligning_transform(pts),
                                  tpu_rotations.compute_aligning_transform(pts))


def test_linalg_host():
    M = rng().normal(size=(6, 6))
    M = M @ M.T + 6 * np.eye(6)
    np.testing.assert_allclose(linalg.fast_psd_inverse(M), tpu_linalg.fast_psd_inverse(M), rtol=1e-12)
    offsets = rng().normal(size=(40, 2))
    np.testing.assert_allclose(linalg.generate_spatial_basis(offsets, k=3),
                               tpu_linalg.generate_spatial_basis(offsets, k=3), rtol=1e-12, atol=1e-14)


# -- the pointing matrix's ingredients ---------------------------------------------------------------


@pytest.mark.parametrize("dims, bilinear", [(1, True), (2, True), (2, False), (3, [True, False, True]),
                                            (2, [False, True])], ids=["1d", "bilinear", "nearest", "3d-mixed",
                                                                      "2d-mixed"])
def test_pointing_indices_and_weights(dims, bilinear):
    """Flat ids exact and weights within 1e-6 of maria_tpu's, on samples
    on and off the grids (log and uniform pixel centres, one axis of a
    single pixel skipped)."""
    sides = [np.linspace(-1.0, 1.0, 17), np.geomspace(0.1, 5.0, 11), np.linspace(0.0, 3.0, 7)][:dims]
    if dims == 1:
        sides = sides + [np.array([0.5])]
    r = rng(dims)
    xs = [r.uniform(s.min() - 0.2 * np.ptp(s), s.max() + 0.2 * np.ptp(s), (13, 29)).astype(np.float32)
          for s in sides]
    ref_p, ref_w, ref_n = tpu_linalg.pointing_indices_and_weights(xs, sides, bilinear=bilinear)
    p, w, n = linalg.pointing_indices_and_weights([torch.as_tensor(x) for x in xs], sides, bilinear=bilinear)
    assert n == ref_n and p.dtype == torch.int64 and w.dtype == torch.float32
    np.testing.assert_array_equal(p.numpy(), np.asarray(ref_p))
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), rtol=0, atol=1e-6)
    if bilinear is True:
        total = w.sum(0).numpy()
        assert np.all((np.abs(total - 1) < 1e-6) | (total == 0))


def test_compute_pointing_matrix_sparse_indices():
    bins = [np.linspace(-1, 1, 9), np.linspace(0, 2, 5)]
    xs = [rng().uniform(-1.5, 1.5, 300), rng(1).uniform(-0.5, 2.5, 300)]
    for a, b in zip(linalg.compute_pointing_matrix_sparse_indices(xs, bins),
                    tpu_linalg.compute_pointing_matrix_sparse_indices(xs, bins)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        linalg.compute_pointing_matrix_sparse_indices(xs, [bins[0][::-1], bins[1]])


# -- the 2-D Fourier noise ---------------------------------------------------------------------


def psd_slope(F, k0: float):
    """The log-log slope of the azimuthally averaged power spectrum of a
    2-D field against sqrt(k0^2 + k^2), over integer wavenumbers from 8 to
    0.8 x the smaller Nyquist: -(beta + 1) for the field's spectrum."""
    ny, nx = F.shape
    P = np.abs(np.fft.fft2(F)) ** 2
    k = np.hypot(*np.meshgrid(np.fft.fftfreq(nx, 1 / nx), np.fft.fftfreq(ny, 1 / ny), indexing="xy"))
    kb = np.rint(k).astype(int)
    kmax = int(0.8 * min(nx, ny) / 2)
    ks = np.arange(8, kmax)
    psd = np.bincount(kb.ravel(), P.ravel(), minlength=kmax)[ks] / np.bincount(kb.ravel(), minlength=kmax)[ks]
    return np.polyfit(np.log(np.sqrt(k0**2 + ks.astype(float) ** 2)), np.log(psd), 1)[0]


@pytest.mark.parametrize("beta", [8 / 3, 2.0])
def test_generate_2d_fourier_noise(beta):
    import jax

    from maria_tpu.noise import generate_2d_fourier_noise as tpu_noise

    from maria_torch.noise import generate_2d_fourier_noise

    g = torch.Generator()
    g.manual_seed(0)
    F = generate_2d_fourier_noise(nx=512, ny=384, beta=beta, generator=g)
    assert F.shape == (384, 512) and F.dtype == torch.float32 and F.device.type == "cpu"
    F = F.double().numpy()
    assert abs(F.mean()) < 1e-5 and abs(F.std() - 1) < 1e-5
    ref = np.asarray(tpu_noise(jax.random.key(0), nx=512, ny=384, beta=beta), dtype=np.float64)
    for field in (F, ref):
        assert abs(psd_slope(field, 5.0) + (beta + 1)) < 0.05 * (beta + 1)


def test_generate_2d_fourier_noise_needs_a_device():
    from maria_torch.noise import generate_2d_fourier_noise

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            generate_2d_fourier_noise(nx=8, ny=8)
    assert generate_2d_fourier_noise(nx=16, ny=8, device="cpu").shape == (8, 16)


# -- interpolation -----------------------------------------------------------------------------


def test_regular_grid_interpolator():
    """4-D multilinear interpolation (uniform, log and general axes, a
    trailing value dim) within 1e-6 of maria_tpu's, relative to the
    values' scale (torch's and XLA's float32 log differ by an ulp at
    some samples), clipped off the grid; arrays computed on the device
    asked for give what their tensors give, on that device."""
    from maria_tpu.ops.interp import RegularGridInterpolator as TpuRGI

    from maria_torch.ops.interp import RegularGridInterpolator

    points = (np.linspace(260, 300, 5), np.geomspace(0.05, 100, 24), np.linspace(0.1, 1.57, 14),
              np.sort(rng().uniform(1e9, 1e12, 9)))
    values = rng().uniform(1.0, 5.0, (5, 24, 14, 9, 2)).astype(np.float32)
    r = rng(3)
    xi = (r.uniform(250, 310, 500), np.exp(r.uniform(np.log(0.03), np.log(150), 500)), r.uniform(0, 1.8, 500),
          r.uniform(5e8, 1.1e12, 500))
    xi = tuple(x.astype(np.float32) for x in xi)
    ref = np.asarray(TpuRGI(points, values)(xi))
    ours = RegularGridInterpolator(points, values)
    out = ours(xi, device="cpu")
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32 and out.shape == ref.shape
    assert_rel(out.numpy(), ref, 1e-6, floor=np.abs(ref).max())
    t = ours(tuple(torch.as_tensor(x) for x in xi))
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), out.numpy())
    # no trailing value dim: the grid's values, one a sample
    scalar = RegularGridInterpolator(points, values[..., 0])(xi, device="cpu")
    np.testing.assert_array_equal(scalar.numpy(), out[:, 0].numpy())


def test_interp_1d():
    from maria_tpu.ops.interp import interp_1d as tpu_interp_1d

    from maria_torch.ops.interp import interp_1d

    side = np.sort(rng().uniform(0, 10, 12))
    values = rng(1).normal(size=(3, 12, 2)).astype(np.float32)
    x = rng(2).uniform(-1, 11, (4, 5)).astype(np.float32)
    ours = interp_1d(torch.as_tensor(x), side, values, axis=1)
    ref = np.asarray(tpu_interp_1d(x, side, values, axis=1))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(interp_1d(x, side, values, axis=1, device="cpu").numpy(), ours.numpy())


def test_one_interp():
    """ops.interp.interp is np.interp on tensors, the one the TOD's
    non-linear conversions and MaternInterpolator read; with further axes
    of fp, each column is the 1-D interpolation."""
    from maria_torch.ops.interp import interp
    from maria_torch.tod import tod

    assert tod.interp is interp
    xp = np.sort(rng().uniform(0, 5, 20)).astype(np.float32)
    fp = rng(1).normal(size=(20, 3)).astype(np.float32)
    x = rng(2).uniform(-1, 6, 300).astype(np.float32)
    out = interp(torch.as_tensor(x), torch.as_tensor(xp), torch.as_tensor(fp))
    for j in range(3):
        np.testing.assert_allclose(out[:, j].numpy(), np.interp(x, xp, fp[:, j]), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(out[:, j].numpy(),
                                      interp(torch.as_tensor(x), torch.as_tensor(xp), torch.as_tensor(fp[:, j])).numpy())


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", ["RegularGridInterpolator", "interp_1d", "MaternInterpolator",
                                  "pointing_indices_and_weights"])
def test_arrays_alone_compute_on_the_card(monkeypatch, name):
    """A device function given arrays and no device computes on the card,
    as an entry point given no device does: where there is none it
    raises, and never falls back to the CPU unasked."""
    from maria_torch.ops.interp import RegularGridInterpolator, interp_1d

    side = np.linspace(0.0, 1.0, 5)
    x = rng().uniform(0, 1, 7).astype(np.float32)
    call = {
        "RegularGridInterpolator": lambda **kw: RegularGridInterpolator((side,), np.arange(5.0))((x,), **kw),
        "interp_1d": lambda **kw: interp_1d(x, side, np.arange(5.0), **kw),
        "MaternInterpolator": lambda **kw: functions.MaternInterpolator(nu=1 / 3)(x, **kw),
        "pointing_indices_and_weights": lambda **kw: linalg.pointing_indices_and_weights([x], [side], **kw)[1],
    }[name]
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    out = call(device="cpu")
    assert out.device.type == "cpu" and out.dtype == torch.float32


