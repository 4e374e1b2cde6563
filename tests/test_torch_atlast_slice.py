"""The port's AtLAST total-power slice against maria_tpu, on CPU.

A small AtLAST-shaped scene (the nine atlast bands, 19 detectors each,
site ALMA, 3-D Fourier atmosphere, a 10 s daisy at 50 Hz with the
benchmark's radius and speed) is built by both packages, each with a
private data cache. maria_tpu is held to the port's route without
editing it: MARIA_TPU_NOISE_TOTAL=matmul takes the matrix-product noise
on the CPU, and MARIA_TPU_SAMPLER_DEC_TOL=0 turns off its temporal
decimation and static-hat sampler, leaving the undecimated windowed
bilinear sampler, whose values equal the plain gather's inside the
window. Its draws are reproduced with jax.random and injected into the
port. Each comparison states its tolerance.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import maria_torch  # noqa: E402
import maria_tpu  # noqa: E402
from maria_tpu.io import caching as tpu_caching  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0
BANDS = [f"atlast/f{b}" for b in ("042", "093", "150", "220", "280", "350", "400", "650", "850")]
ARRAY = {"primary_size": 50, "n": 19, "field_of_view": 2.0, "shape": "circle", "bands": BANDS}
PLAN_KWARGS = dict(start_time=1.75e9, scan_center=(150.0, 41.0), frame="az/el", duration=10.0,
                   sample_rate=50.0, scan_options={"radius": 0.5, "speed": 0.25})
SCENE_KWARGS = dict(site="ALMA", atmosphere="3d", noise=True, seed=SEED)
ROUTE_ENV = {"MARIA_TPU_NOISE_TOTAL": "matmul", "MARIA_TPU_SAMPLER_DEC_TOL": "0"}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    old_env = {k: os.environ.get(k) for k in ROUTE_ENV}
    old_tpu, old_torch = tpu_caching.get_cache_dir(), maria_torch.io._cache_state["base"]
    os.environ.update(ROUTE_ENV)
    maria_tpu.set_cache_dir(str(tmp_path_factory.mktemp("maria_tpu_cache")))
    maria_torch.set_cache_dir(str(tmp_path_factory.mktemp("maria_torch_cache")))
    try:
        from maria_tpu.ops.program import build_tod_program

        ref_sim = maria_tpu.Simulation(instrument=maria_tpu.get_instrument(array=ARRAY),
                                       plans=maria_tpu.get_plan("daisy_5arcmin_60s", **PLAN_KWARGS), **SCENE_KWARGS)
        ref_program = build_tod_program(ref_sim.obs_list[0], noise_kwargs=ref_sim.noise_kwargs)
        sim = maria_torch.Simulation(instrument=maria_torch.get_instrument(array=ARRAY),
                                     plans=maria_torch.get_plan("daisy_5arcmin_60s", **PLAN_KWARGS),
                                     device="cpu", **SCENE_KWARGS)
        yield {"ref_sim": ref_sim, "ref_program": ref_program, "sim": sim, "program": sim.program()}
    finally:
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        maria_tpu.set_cache_dir(old_tpu)
        maria_torch.set_cache_dir(old_torch)


def _t(x):
    return torch.as_tensor(np.array(x))


def group_draws(ref_program, key_scr):
    """The group's white draw: accumulate_pwv splits one key per screen
    and group (atmosphere/sampling.py:105-106), and the layered synthesis
    draws (2J, ny, nx//2+1, 2) normals from it (fourier.py:57,281)."""
    keys = jax.random.split(key_scr, len(ref_program.screens) + len(ref_program.groups))
    return [_t(jax.random.normal(keys[len(ref_program.screens) + i], (2 * g.W.shape[0], g.ny, g.nx // 2 + 1, 2),
                                 dtype=jnp.float32))
            for i, g in enumerate(ref_program.groups)]


def total_power_draws(ref_program, key):
    """maria_tpu total_power_fn's normals for ``key``: the atmosphere,
    noise and gain streams (ops/program.py:297,318,487), the shared-shape
    white draw from the noise key and each band's mode draw from
    fold_in(noise key, band index) (noise/dft.py:155-175)."""
    from maria_tpu.atmosphere.fourier import good_fft_size

    key_atm, key_noise, key_gain = jax.random.split(key, 3)
    m1 = good_fft_size(len(ref_program.t_fine)) // 2 + 1
    n_det = len(ref_program.offsets)
    modes = []
    for i, band in enumerate(ref_program.bands):
        k = np.asarray(band.noise_basis).shape[-1]
        key_modes = jax.random.split(jax.random.fold_in(key_noise, i), 3)[2]
        modes.append(_t(jax.random.normal(key_modes, (k, 2, m1), dtype=jnp.float32)))
    return {
        "groups": group_draws(ref_program, jax.random.split(key_atm)[0]),
        "gains": _t(jax.random.normal(key_gain, (n_det,))),
        "v": _t(jax.random.normal(key_noise, (n_det, 2, m1), dtype=jnp.float32)),
        "modes": modes,
    }


def program_tables(p):
    """A maria_tpu TODProgram's static tables as numpy, the input of
    maria_torch.convert.program_from_tables, with its groups and its
    matrix-product noise specs."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_slice import program_tables as base_tables

    tables = base_tables(p)
    tables["groups"] = [
        {k: np.asarray(getattr(g, k)) if k in ("W", "M_cos", "M_sin", "beam", "heights", "zs", "pwv_rms")
         else getattr(g, k)
         for k in ("heights", "zs", "pwv_rms", "angle", "vx", "vy", "res", "tx_min", "ty_min", "nx", "ny",
                   "W", "M_cos", "M_sin", "beam")}
        for g in p.groups
    ]
    specs, corr_cols, n_fft, shared_c, row_scale = p._noise_matmul_specs()
    tables["noise_matmul"] = {
        "specs": [{k: getattr(sp, k) for k in ("start", "stop", "c", "k_modes", "mode_c", "key_index")}
                  for sp in specs],
        "corr_cols": corr_cols, "n_fft": n_fft, "shared_c": shared_c, "row_scale": row_scale,
    }
    return tables


@pytest.fixture(scope="module")
def totals(scene):
    """maria_tpu's total_power_fn and the port's, with the same draws."""
    rp = scene["ref_program"]
    key = jax.random.key(21)
    fn = jax.jit(rp.total_power_fn())
    ref = np.asarray(fn(key, *rp.example_args(key)[1:], tables=rp.device_tables()))
    draws = total_power_draws(rp, key)
    ours = scene["program"].total_power_fn()(draws=draws, device="cpu")
    return ref, ours, draws, key


# -- scene tables ------------------------------------------------------------------------


def test_atlast_50k_instrument_matches():
    """The full AtLAST-50k instrument: 9 x 5556 detectors, the same
    offsets, band order and parametric passbands."""
    ref = maria_tpu.get_instrument("AtLAST-50k")
    ours = maria_torch.get_instrument("AtLAST-50k")
    assert ours.n_dets == ref.n_dets == 50004
    np.testing.assert_array_equal(ours.dets.offsets, ref.dets.offsets)
    np.testing.assert_array_equal(ours.dets.band_name, ref.dets.band_name)
    for b, r in zip(ours.bands, ref.bands):
        assert (b.name, b.NEP, b.knee, b.efficiency, b.gain_error, b.center) == \
            (r.name, r.NEP, r.knee, r.efficiency, r.gain_error, r.center)
        np.testing.assert_array_equal(b.nu, r.nu)
        np.testing.assert_array_equal(b.tau, r.tau)


def test_spectrum_covers_every_passband(scene):
    """The synthetic spectrum's frequency grid reaches past every band's
    passband (f850's gaussian reaches 1.06 THz; the grid 1.25 THz)."""
    spectrum = scene["sim"].obs_list[0].atmosphere.spectrum
    for band in scene["sim"].instrument.bands:
        assert spectrum.side_nu.min() <= band.nu.min() and band.nu.max() <= spectrum.side_nu.max()


def test_program_tables_match(scene):
    """The port's own build reproduces maria_tpu's program: pointing,
    the screen group, the band tables and the matrix-product noise specs."""
    ref, ours = scene["ref_program"], scene["program"]
    for name in ("offsets", "bs_az_coarse", "bs_el_coarse", "t_coarse", "t_fine", "mueller_I", "gain_error"):
        np.testing.assert_allclose(getattr(ours, name), np.asarray(getattr(ref, name)), rtol=1e-12, atol=1e-15)
    assert ours.upsample_ratio == ref.upsample_ratio
    np.testing.assert_allclose(ours.mean_pwv, ref.mean_pwv, rtol=1e-12)
    atm, ref_atm = scene["sim"].obs_list[0].atmosphere, scene["ref_sim"].obs_list[0].atmosphere
    np.testing.assert_array_equal(atm.spectrum._emission, ref_atm.spectrum._emission)
    np.testing.assert_array_equal(atm.spectrum._opacity, ref_atm.spectrum._opacity)
    for field in ("temperature", "pressure", "humidity", "wind_east", "wind_north"):
        np.testing.assert_allclose(getattr(atm.weather, field), getattr(ref_atm.weather, field), rtol=1e-12)
    assert ours.band_order == ref.band_order == list(range(9))
    assert ours.band_bounds() == ref.band_bounds()
    assert ours.use_noise_matmul() and ref.use_noise_matmul()
    specs, cols, n_fft, shared_c, row_scale = ours._noise_matmul_specs()
    r_specs, r_cols, r_n_fft, r_shared_c, r_row_scale = ref._noise_matmul_specs()
    assert n_fft == r_n_fft == 512 and shared_c is not None
    np.testing.assert_allclose(shared_c, r_shared_c, rtol=1e-12)
    np.testing.assert_array_equal(row_scale, r_row_scale)
    np.testing.assert_allclose(cols, r_cols, rtol=1e-6, atol=1e-7)
    for sp, r in zip(specs, r_specs):
        assert (sp.start, sp.stop, sp.k_modes, sp.key_index) == (r.start, r.stop, r.k_modes, r.key_index)
        np.testing.assert_allclose(sp.c, r.c, rtol=1e-12)
        np.testing.assert_allclose(sp.mode_c, r.mode_c, rtol=1e-12)


# -- the total-power route -------------------------------------------------------------------


def test_total_power_matches_jax(scene, totals):
    """total_power_fn with maria_tpu's draws equals maria_tpu's total to
    1e-4 of the total's std (float32: the atmosphere's loadings of tens
    of pW dominate the total; the noise is held tighter below)."""
    ref, ours, _, _ = totals
    p = scene["program"]
    assert tuple(ours.shape) == ref.shape == (p.n_det, p.n_t) == (171, 500)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4 * ref.std())


def test_total_noise_matches_jax(scene, totals):
    """The noise stage alone (A = 0) on the program's specs, maria_tpu's
    noise key and draws: 99.9% of samples within 1e-5 of the noise std
    and all within 1e-2 (a bf16 rounding of a float32 mode time-series
    value may flip, as in test_torch_noise_dft)."""
    from maria_tpu.noise.dft import noise_total_matmul as ref_fn

    from maria_torch.noise.dft import noise_total_matmul

    _, _, draws, key = totals
    rp, p = scene["ref_program"], scene["program"]
    r_specs, r_cols, n_fft, r_shared, r_rows = rp._noise_matmul_specs()
    ref = np.asarray(ref_fn(jax.random.split(key, 3)[1], 0.0, r_specs, n=p.n_t, n_fft=n_fft, corr_cols=r_cols,
                            shared_c=r_shared, row_scale=r_rows))
    specs, cols, _, shared_c, row_scale = p._noise_matmul_specs()
    ours = noise_total_matmul(0.0, specs, n=p.n_t, n_fft=n_fft, corr_cols=cols, shared_c=shared_c,
                              row_scale=row_scale, z=draws["v"], mode_z=draws["modes"], device="cpu").numpy()
    err = np.abs(ours - ref)
    assert np.mean(err <= 1e-5 * ref.std()) >= 0.999
    assert err.max() <= 1e-2 * ref.std()


def test_generator_total_launches_the_shared_draw(scene):
    """Without injected draws the total's V comes from kernel K3's
    wrapper (its plain version on the CPU) and the same generator state
    gives the same total."""
    p = scene["program"]
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    a = p.total_power_fn()(generator=gen, device="cpu")
    gen.set_state(state)
    b = p.total_power_fn()(generator=gen, device="cpu")
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())


def test_convert_carries_groups_and_noise_specs(scene, totals):
    """A program carried over from maria_tpu's tables, groups and noise
    specs included, gives the port's own total for the same draws."""
    from maria_torch.convert import program_from_tables

    _, ours, draws, _ = totals
    carried = program_from_tables(program_tables(scene["ref_program"]))
    assert len(carried.groups) == 1 and carried.use_noise_matmul()
    total = carried.total_power_fn()(draws=draws, device="cpu")
    np.testing.assert_allclose(total.numpy(), ours.numpy(), rtol=2e-6, atol=1e-6 * float(ours.std()))


# -- the fields route, and binning ----------------------------------------------------------------


def sim_draws(ref_program, seed=SEED):
    """maria_tpu's normals for one Simulation.run() (see
    test_torch_slice.jax_draws), with the screen group's draw."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_slice import jax_draws

    draws = jax_draws(ref_program, seed)
    key = jax.random.split(jax.random.key(seed))[1]
    draws["groups"] = [np.asarray(d) for d in group_draws(ref_program, jax.random.split(jax.random.split(key, 3)[0])[0])]
    draws.pop("screens")
    return {k: (v if k != "groups" else [torch.as_tensor(d) for d in v]) for k, v in draws.items()}


def test_simulation_run_fields_match(scene):
    """Simulation(..., atmosphere="3d").run() (the per-band K1 route)
    equals maria_tpu's run with the same draws, in K_RJ: within 2e-6
    relative plus 1e-4 of each field's fluctuation std (float32)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_slice import to_torch

    draws = to_torch(sim_draws(scene["ref_program"]))
    ref_tod = scene["ref_sim"].run()[0]
    tod = scene["sim"].run(draws=[draws])[0]
    assert tod.fields == ref_tod.fields == ["atmosphere", "noise"] and tod.units == "K_RJ"
    for k in tod.fields:
        ref = np.asarray(ref_tod.data[k])
        assert tod.data[k].shape == ref.shape == (171, 500)
        np.testing.assert_allclose(tod.data[k].numpy(), ref, rtol=2e-6, atol=1e-4 * (ref - ref.mean()).std())


def test_field_pixel_ids_and_map_match_bench(scene, totals):
    """field_pixel_ids equals bench.py's _pixel_ids chain on this scene
    (float32 pointing on both sides, offsets in float64 there and float32
    here: at most 0.1% of the ids move, each to a neighbouring pixel), and
    K2's map of the port's total matches a numpy bincount of maria_tpu's
    total at bench.py's ids: the hit maps differ by at most twice the
    moved ids and the binned sums agree to 1e-5 of their total."""
    sys.path.insert(0, REPO)
    import bench

    from maria_torch.mappers.bin_mapper import bin_total, field_pixel_ids

    obs = scene["sim"].obs_list[0]
    ref_ids, n_pix = bench._pixel_ids(scene["ref_program"], scene["ref_sim"].obs_list[0])
    ids, n_pix_ours = field_pixel_ids(obs.boresight, obs.offsets, 128, 128, device="cpu")
    assert n_pix_ours == n_pix == 128 * 128 and ids.dtype == torch.int32
    ids = ids.numpy()
    moved = ids != ref_ids
    assert moved.mean() <= 1e-3
    assert np.all(np.abs(ids[moved] // 128 - ref_ids[moved] // 128) <= 1)
    assert np.all(np.abs(ids[moved] % 128 - ref_ids[moved] % 128) <= 1)

    ref_total, total, _, _ = totals
    sums, hits = bin_total(total, torch.as_tensor(ids), n_pix)
    ref_hits = np.bincount(ref_ids.ravel(), minlength=n_pix)
    ref_sums = np.bincount(ref_ids.ravel(), weights=ref_total.ravel().astype(np.float64), minlength=n_pix)
    assert hits.sum() == ref_hits.sum() == total.numel()
    assert np.abs(hits.numpy() - ref_hits).sum() <= 2 * moved.sum()
    np.testing.assert_allclose(sums.double().sum(), ref_sums.sum(), rtol=1e-5)
