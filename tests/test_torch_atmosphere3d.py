"""The port's Fourier 3-D atmosphere against maria_tpu, on CPU:

- the kz quadrature and the layered spectral operators (host numpy);
- the layered synthesis given the same white draw;
- ``accumulate_pwv`` with a screen group against maria_tpu's exact
  bilinear path (``bs_px=None``), given the same draw;
- the band tables' reachable-pwv window, which must count the rms of
  the group's layers (a 3-D scene has no 2-D screens).

The scene (two AtLAST bands, 19 detectors each, site ALMA, a 10 s daisy)
is built by both packages, each with a private data cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import maria_torch  # noqa: E402
import maria_tpu  # noqa: E402
from maria_tpu.atmosphere import fourier as ref_fourier  # noqa: E402
from maria_tpu.io import caching as tpu_caching  # noqa: E402

from maria_torch.atmosphere import fourier  # noqa: E402

ARRAY = {"primary_size": 50, "n": 19, "field_of_view": 2.0, "shape": "circle",
         "bands": ["atlast/f150", "atlast/f850"]}
PLAN_KWARGS = dict(start_time=1.75e9, scan_center=(150.0, 41.0), frame="az/el", duration=10.0,
                   sample_rate=50.0, scan_options={"radius": 0.5, "speed": 0.25})


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    old_tpu, old_torch = tpu_caching.get_cache_dir(), maria_torch.io._cache_state["base"]
    maria_tpu.set_cache_dir(str(tmp_path_factory.mktemp("maria_tpu_cache")))
    maria_torch.set_cache_dir(str(tmp_path_factory.mktemp("maria_torch_cache")))
    try:
        from maria_tpu.ops.program import build_tod_program

        kw = dict(site="ALMA", atmosphere="3d", noise=True, seed=0)
        ref_sim = maria_tpu.Simulation(instrument=maria_tpu.get_instrument(array=ARRAY),
                                       plans=maria_tpu.get_plan("daisy_5arcmin_60s", **PLAN_KWARGS), **kw)
        sim = maria_torch.Simulation(instrument=maria_torch.get_instrument(array=ARRAY),
                                     plans=maria_torch.get_plan("daisy_5arcmin_60s", **PLAN_KWARGS),
                                     device="cpu", **kw)
        yield {"ref_sim": ref_sim, "ref_program": build_tod_program(ref_sim.obs_list[0],
                                                                    noise_kwargs=ref_sim.noise_kwargs),
               "sim": sim, "program": sim.program()}
    finally:
        maria_tpu.set_cache_dir(old_tpu)
        maria_torch.set_cache_dir(old_torch)


def test_kz_nodes_and_layered_weights_match():
    """Host operators equal maria_tpu's to 1e-6 relative (the same numpy
    float64 arithmetic, rounded to float32)."""
    kz, w = fourier.layered_matern_kz_nodes(1 / 3, 1200.0, dz_max=9000.0, dz_min=7.0)
    rkz, rw = ref_fourier.layered_matern_kz_nodes(1 / 3, 1200.0, dz_max=9000.0, dz_min=7.0)
    np.testing.assert_allclose(kz, rkz, rtol=1e-6)
    np.testing.assert_allclose(w, rw, rtol=1e-6)
    heights = np.array([7.5, 40.0, 200.0, 900.0, 3000.0])
    args = (48, 64, 15.0, 15.0, heights)
    kw = dict(nu=1 / 3, r0=1000.0, beam_sigmas=np.array([0.5, 2.0, 5.0, 10.0, 20.0]))
    for ours, ref in zip(fourier.layered_field_spectral_weights(*args, **kw),
                         ref_fourier.layered_field_spectral_weights(*args, **kw)):
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_layered_synthesis_matches():
    """The (L, ny, nx) layer stack given maria_tpu's white draw equals
    maria_tpu's to 1e-5 of the field's std (float32 FFTs and the mixing
    product, summed in another order)."""
    ny, nx = 48, 64
    heights = np.array([7.5, 40.0, 200.0, 900.0])
    W, M_cos, M_sin, beam = ref_fourier.layered_field_spectral_weights(
        ny, nx, 15.0, 15.0, heights, nu=1 / 3, r0=1000.0, beam_sigmas=np.full(4, 8.0))
    key = jax.random.key(4)
    ref = np.asarray(ref_fourier.synthesize_layered_matern_2d(
        key, jnp.asarray(W), jnp.asarray(M_cos), jnp.asarray(M_sin), jnp.asarray(beam), ny, nx))
    draw = np.array(jax.random.normal(key, (2 * W.shape[0], ny, nx // 2 + 1, 2), dtype=jnp.float32))
    ours = fourier.synthesize_layered_matern_2d(
        *(torch.as_tensor(a) for a in (W, M_cos, M_sin, beam)), ny, nx, draw=torch.as_tensor(draw)).numpy()
    assert ours.shape == ref.shape == (4, ny, nx)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * ref.std())


def test_white_spectrum_batch_symmetrizes_each_member():
    """A batched white draw equals the unbatched draws of its members."""
    draw = torch.randn((3, 8, 5, 2), generator=torch.Generator().manual_seed(0))
    batched = fourier.white_rfft2_spectrum(8, 8, draw=draw, batch=(3,))
    for i in range(3):
        assert torch.equal(batched[i], fourier.white_rfft2_spectrum(8, 8, draw=draw[i]))


def test_group_tables_match(scene):
    ref, ours = scene["ref_program"].groups, scene["program"].groups
    assert len(ours) == len(ref) == 1 and not scene["program"].screens
    for k in ("heights", "zs", "pwv_rms", "angle", "vx", "vy", "res", "tx_min", "ty_min", "nx", "ny",
              "W", "M_cos", "M_sin", "beam"):
        np.testing.assert_allclose(np.asarray(getattr(ours[0], k)), np.asarray(getattr(ref[0], k)),
                                   rtol=1e-10, atol=1e-12)
    assert len(ours[0].heights) == 12


def test_accumulate_pwv_with_group_matches_exact_path(scene):
    """The port's group sampling equals maria_tpu's exact bilinear path
    (bs_px=None: a plain gather of every layer at every coarse step)
    given the same draw. Tolerance: 1e-5 of the pwv std or 8 ulp of the
    mean pwv, whichever is larger. The float32 sum of a ~0.8 mm mean and
    twelve ~0.01 mm layer samples rounds to the sum's ulp (6e-8 mm) at
    every addition, so the two orders of evaluation drift by a few ulp,
    far more than 1e-5 of the ~0.02 mm std."""
    from maria_tpu.atmosphere.sampling import accumulate_pwv as ref_fn

    from maria_torch.atmosphere.sampling import accumulate_pwv
    from maria_torch.coords import offsets_to_phi_theta

    p, rp = scene["program"], scene["ref_program"]
    f32 = dict(dtype=torch.float32)
    pt = offsets_to_phi_theta(torch.as_tensor(p.offsets, **f32)[:, None, :], torch.as_tensor(p.bs_az_coarse, **f32),
                              torch.as_tensor(p.bs_el_coarse, **f32))
    el = torch.clamp(pt[..., 1], float(np.float32(np.radians(5.0))), float(np.float32(np.pi / 2)))
    px = torch.sin(pt[..., 0]) / torch.tan(el)
    py = torch.cos(pt[..., 0]) / torch.tan(el)
    t_c = torch.as_tensor(p.t_coarse, **f32)
    key = jax.random.key(9)
    g = rp.groups[0]
    ref = np.asarray(ref_fn(key, rp.mean_pwv, [], rp.groups, jnp.asarray(px.numpy()), jnp.asarray(py.numpy()),
                            None, None, jnp.asarray(t_c.numpy())))
    draw = np.array(jax.random.normal(jax.random.split(key, 1)[0], (2 * g.W.shape[0], g.ny, g.nx // 2 + 1, 2),
                                      dtype=jnp.float32))
    ours = accumulate_pwv(p.mean_pwv, [], px, py, t_c, groups=p.groups, group_draws=[torch.as_tensor(draw)]).numpy()
    assert ours.shape == ref.shape == (p.n_det, len(p.t_coarse))
    atol = max(1e-5 * ref.std(), 8 * float(np.spacing(np.float32(rp.mean_pwv))))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=atol)


def test_table_window_counts_group_rms(scene):
    """The band tables are cropped to mean pwv +- 8 sigma with sigma the
    summed rms of every screen and group layer (maria_tpu
    ops/program.py:678-682): the port's cropped tables equal maria_tpu's
    crop of its full tables, and the window spans more than one pwv cell
    (a window collapsed to the mean keeps the two cells around it)."""
    from maria_tpu.ops.program import _crop_table

    ref, ours = scene["ref_program"], scene["program"]
    atm = scene["ref_sim"].obs_list[0].atmosphere
    sigma = float(np.sqrt(sum(float(np.sum(np.asarray(g.pwv_rms) ** 2)) for g in atm.groups)))
    assert sigma > 0 and not atm.screens
    bs_el = np.asarray(atm.boresight.el)
    off = float(np.abs(np.asarray(scene["ref_sim"].obs_list[0].offsets)).max())
    for b, r in zip(ours.bands, ref.bands):
        xs, ys, tab = _crop_table(
            np.asarray(r.pwv_side), np.asarray(r.el_side), np.asarray(r.power_table),
            max(0.0, ref.mean_pwv - 8 * sigma), ref.mean_pwv + 8 * sigma,
            max(np.radians(5.0), bs_el.min() - 2 * off), min(np.pi / 2, bs_el.max() + 2 * off),
        )
        np.testing.assert_allclose(b.pwv_side, xs, rtol=1e-7)
        np.testing.assert_allclose(b.el_side, ys, rtol=1e-7)
        np.testing.assert_allclose(b.power_table, tab, rtol=1e-6)
        assert len(b.pwv_side) >= 3
