"""The plain references' building blocks against float64 closed forms
and published answers, at tiny sizes."""

import math

import numpy as np
import pytest
import torch

from portbench.reference import common, scene

F64 = torch.float64


@pytest.mark.parametrize("ctr, key, want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    got = common.philox4x32_10(tuple(torch.tensor(c, dtype=torch.int64) for c in ctr), key)
    assert tuple(int(g) for g in got) == want


def test_philox_normals_are_standard():
    re, im = common.philox_complex_normals((12345, 678), torch.arange(64, dtype=torch.int64), 1001)
    z = torch.cat([re.reshape(-1), im.reshape(-1)])
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1) < 0.01
    again, _ = common.philox_complex_normals((12345, 678), torch.arange(3, 5, dtype=torch.int64), 1001)
    assert torch.equal(again, re[3:5])  # a row's draw depends on its row alone


def test_white_half_spectrum_gives_a_real_unit_field():
    g = torch.Generator().manual_seed(0)
    ny, nx = 64, 48
    draw = torch.randn((200, ny, nx // 2 + 1, 2), generator=g)
    field = torch.fft.irfft2(common.white_half_spectrum(draw), s=(ny, nx))
    assert abs(float(field.var()) - 1) < 0.02
    # Hermitian columns: the full inverse FFT of the symmetrized spectrum is real
    spec = common.white_half_spectrum(draw[:1])
    full = torch.cat([spec, torch.conj(torch.flip(torch.roll(torch.flip(spec, (-2,)), 1, -2), (-1,)))[..., 1:-1]], -1)
    assert float(torch.fft.ifft2(full).imag.abs().max()) < 1e-9 * float(spec.abs().max())


def test_catmull_rom_reproduces_lines_and_holds_the_end():
    coarse = torch.arange(10, dtype=F64) * 2.5 + 1.0
    fine = common.catmull_rom_upsample(coarse[None], 4, 40)[0]
    t = torch.arange(36, dtype=F64) / 4
    # inside the first and last cells, whose outer knot is the end sample repeated
    assert torch.allclose(fine[4:32], 2.5 * t[4:32] + 1.0, atol=1e-12, rtol=0)
    assert fine[0] == coarse[0] and fine[32] == coarse[8]
    assert torch.all(fine[36:] == coarse[-1])


def test_bilinear_sampling_is_exact_on_bilinear_fields():
    ny, nx, x0, dx, y0, dy = 7, 9, -3.0, 0.5, 2.0, 0.25
    Y, X = torch.meshgrid(y0 + dy * torch.arange(ny, dtype=F64), x0 + dx * torch.arange(nx, dtype=F64), indexing="ij")
    f = lambda x, y: 1.5 + 0.3 * x - 2.0 * y + 0.7 * x * y  # noqa: E731
    x = torch.linspace(x0, x0 + dx * (nx - 1), 31, dtype=F64)
    y = torch.linspace(y0, y0 + dy * (ny - 1), 31, dtype=F64)
    got = common.bilinear_uniform(f(X, Y), x, y, x0, dx, y0, dy)
    assert torch.allclose(got, f(x, y), atol=1e-12, rtol=0)
    outside = common.bilinear_uniform(f(X, Y), torch.tensor([x0 - 1.0], dtype=F64), y[:1], x0, dx, y0, dy)
    assert float(outside) == 0.0


def test_table_lookup_interpolates_in_log_on_a_log_axis():
    pwv = np.geomspace(0.1, 10.0, 21)
    el = np.linspace(0.2, 1.5, 11)
    table = torch.as_tensor(np.log(pwv)[:, None] * 3.0 + el[None, :] * 2.0, dtype=F64)
    x = torch.tensor([0.15, 1.0, 7.3], dtype=F64)
    y = torch.tensor([0.3, 0.9, 1.4], dtype=F64)
    got = common.table_bilinear(pwv, el, table, x, y)
    assert torch.allclose(got, torch.log(x) * 3.0 + y * 2.0, atol=1e-12, rtol=0)


def test_fft_size_and_knee_spectrum():
    assert common.fft_size(3000) == 3072 and common.fft_size(12000) == 12288 and common.fft_size(5) == 16
    c = common.knee_spectrum(50.0, 1.0, 64, 1.0, 0.0)
    assert c[1] == pytest.approx(math.sqrt(50.0 * 32)) and c[0] == pytest.approx(math.sqrt(50.0 * 64))
    pink = common.knee_spectrum(50.0, 2.0, 64, 0.0, 1.0)
    f = np.fft.rfftfreq(64, 1 / 50.0)
    assert pink[3] == pytest.approx(math.sqrt(2 * 50.0 * 1.0 / f[3] * 32)) and pink[0] == 0.0


def test_rounders():
    x = torch.tensor([1.0, 1.0 + 2**-10, 300.0], dtype=F64)
    assert torch.equal(common.rounder("none")(x), x)
    assert common.rounder("bf16")(x)[1] == 1.0
    q8 = common.rounder("fp8")(x)
    assert float((q8 - x).abs().max()) <= 300.0 / 16


def test_passband_by_hand():
    band = {"center": 150e9, "width": 40e9, "shape": "gaussian", "efficiency": 0.5}
    nu = np.array([150e9, 130e9, 170e9, 89e9, 211e9])
    got = scene.passband(band, nu)
    assert got[0] == pytest.approx(0.5, rel=1e-5) and got[1:3] == pytest.approx([0.25, 0.25], rel=1e-4)
    assert list(got[3:]) == [0.0, 0.0]  # outside its support of 1.5 widths a side
    assert scene.band_center(band) == pytest.approx(150e9, rel=1e-9)


def test_loading_table_of_a_flat_sky():
    """A sky of brightness a + b T_base everywhere loads k_B (a + b T) times
    the passband's integral, linear in the base temperature."""
    nu = np.linspace(80e9, 220e9, 2001)
    T, pwv, el = np.array([250.0, 270.0, 290.0]), np.array([0.5, 1.0, 2.0]), np.array([0.5, 1.0])
    bright = (10.0 + 0.1 * T)[:, None, None, None] * np.ones((3, 3, 2, len(nu)))
    grids = {"side_base_temperature_K": T, "side_zenith_pwv_mm": pwv, "side_elevation_rad": el, "side_nu_Hz": nu,
             "rayleigh_jeans_temperature_K": bright}
    band = {"center": 150e9, "width": 40e9}
    _, _, table = scene.loading_table(grids, band, 262.0)
    want = 1e12 * scene.K_B * (10.0 + 0.1 * 262.0) * np.trapezoid(scene.passband(band, nu), nu)
    assert np.allclose(table, want, rtol=1e-12, atol=0)


def test_layer_operators_by_definition():
    heights = np.array([100.0, 300.0, 300.0, 900.0])
    kz, w = scene.kz_nodes(scene.NU_3D, 1e3, heights)
    assert w.sum() == pytest.approx(1.0) and np.all(np.diff(kz) > 0)
    assert kz[0] == pytest.approx(0.5 * math.pi / (2.5 * 800 + 1e3))
    group = {"heights": heights, "ny": 16, "nx": 12, "res": 20.0}
    ops = scene.group_operators(group, [5.0] * 4, torch.device("cpu"))
    # each node's grid variance is its quadrature weight, the horizontal DC bin zeroed
    fold = torch.tensor([1.0] + [2.0] * 5 + [1.0], dtype=F64)
    var = (ops["W"] ** 2 * fold).sum(dim=(1, 2)) / (16 * 12)
    assert torch.allclose(var, torch.as_tensor(w, dtype=F64), rtol=1e-12, atol=0)
    assert float(ops["W"][:, 0, 0].abs().max()) == 0
    assert np.array_equal(ops["M_cos"][1], ops["M_cos"][2]) and ops["M_sin"][0] == pytest.approx(np.sin(kz * 100.0))
    assert float(ops["beam"][0, 0, 0]) == 1.0


def test_beam_sigma_by_hand():
    # a 50 m aperture at 150 GHz, 1 km away: w0 = 25 m, z_R = pi w0^2 / lambda
    lam = scene.C / 150e9
    z_r = math.pi * 25.0**2 / lam
    want = 1e3 * 50.0 * math.sqrt(1e-6 + 1 / z_r**2) / 2.355
    assert scene.beam_sigma(1e3, 50.0, [150e9, 150e9], [3, 1]) == pytest.approx(want, rel=1e-12)


def test_noise_basis_at_its_grid_nodes_is_the_eigenbasis():
    """On the 16 x 16 grid's own nodes the interpolating spline returns the
    leading eigenmodes of the covariance, each times the root of its
    eigenvalue, up to one common sign."""
    x = np.linspace(-0.01, 0.02, 16)
    y = np.linspace(0.0, 0.015, 16)
    nodes = np.stack(np.meshgrid(x, y, indexing="ij"), axis=-1).reshape(-1, 2)
    B = scene.noise_basis(nodes, 0.03)
    dist = np.sqrt(((nodes[:, None] - nodes[None]) ** 2).sum(-1)) / 0.03
    evals = np.linalg.eigvalsh(scene.matern_five_halves(dist))[::-1][:5]
    assert B.shape == (256, 5) and B[:, 0].mean() > 0
    assert np.allclose(np.sort(np.linalg.eigvalsh(B.T @ B)), np.sort(evals), rtol=1e-8, atol=0)


def test_projection_round_trip():
    dx = torch.tensor([0.0, 0.01, -0.02, 0.005], dtype=F64)
    dy = torch.tensor([0.0, -0.015, 0.01, 0.02], dtype=F64)
    phi, theta = common.offsets_to_phi_theta(dx, dy, torch.tensor(2.6, dtype=F64), torch.tensor(0.7, dtype=F64))
    bx, by = common.phi_theta_to_offsets(phi, theta, 2.6, 0.7)
    assert torch.allclose(bx, dx, atol=1e-14, rtol=0) and torch.allclose(by, dy, atol=1e-14, rtol=0)


def test_field_ids_and_coarse_pointing_by_hand():
    t = np.arange(10) / 5.0
    inputs = {"offsets": np.array([[0.001, 0.001], [0.01, 0.001], [-0.01, 0.01]]), "t": t, "bs_az": 1.0 + 0 * t,
              "bs_el": 0.8 + 0 * t, "timestep": 0.4, "sample_rate": 5.0}
    (_, _, ids), = scene.field_ids(inputs, 4, 4, torch.device("cpu"))
    # a half-width of 1.02 x 0.01 + 1e-8 over four pixels a side: pixels (2, 2), (2, 3) and (3, 0)
    assert ids[:, 0].tolist() == [2 * 4 + 2, 2 * 4 + 3, 3 * 4 + 0] and bool((ids == ids[:, :1]).all())
    t_c, az_c, el_c, ratio = scene.coarse_pointing({**inputs, "bs_az": t})
    assert ratio == 2 and t_c == pytest.approx([0.0, 0.4, 0.8, 1.2, 1.6]) and az_c == pytest.approx(t_c)
