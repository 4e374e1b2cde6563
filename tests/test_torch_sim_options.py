"""The Simulation's options against maria_tpu's, on the CPU: the loose
keywords and their routing (``sim/params.py``), the ``pwv`` sugar,
``from_config``, ``dtype``, the atmosphere's ``seed`` and
``simulate_pwv``, the per-stage path of ``fused=False`` against
maria_tpu's mixins on the same draws, the photon-loading noise term
(``NEP_per_loading``) in the program and without an atmosphere, and
noise without a knee.

The scene is test_torch_slice's (MUSTANG-2, GBT, a 10 s daisy in az/el,
the 2-D atmosphere, noise), built by both packages with private caches;
maria_tpu's normals are drawn with jax.random as its key stream draws
them and handed to the port. Tolerances are float32: each test states
its own.
"""

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import maria_tpu  # noqa: E402
import maria_tpu.sim.params as ref_params  # noqa: E402

import maria_torch  # noqa: E402
import maria_torch.sim.params as params  # noqa: E402
from maria_torch.errors import InvalidSimulationParameterError  # noqa: E402
from maria_torch.noise import generate_noise_with_knee  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_slice import PLAN_KWARGS, SCENE_KWARGS, jax_draws, scene, to_torch  # noqa: E402, F401

MASTER_KEYS = [(group, key) for group, keys in ref_params.MASTER_PARAMS.items() for key in keys]


def port_plan(duration=10.0):
    return maria_torch.get_plan("daisy_5arcmin_60s", **{**PLAN_KWARGS, "duration": duration})


# -- loose keywords ------------------------------------------------------------------------------------


def test_master_params_equal():
    assert params.MASTER_PARAMS == ref_params.MASTER_PARAMS
    assert params.master_params is params.MASTER_PARAMS


@pytest.mark.parametrize("group,key", MASTER_KEYS)
def test_parse_sim_kwargs_routes_each_key(group, key):
    """Every master parameter goes to its subsystem alone, as in maria_tpu."""
    ours, ref = params.parse_sim_kwargs({key: 7}), ref_params.parse_sim_kwargs({key: 7})
    assert ours == ref and ours[group] == {key: 7}
    assert all(v == {} for g, v in ours.items() if g != group)


def test_parse_sim_kwargs_rejects_unknown_keys():
    kwargs = {"pwv": 1.0, "nside": 64, "colour": "red", "spin": 2}
    with pytest.raises(ref_params.InvalidSimulationParameterError) as ref:
        ref_params.parse_sim_kwargs(kwargs)
    with pytest.raises(InvalidSimulationParameterError) as ours:
        params.parse_sim_kwargs(kwargs)
    assert str(ours.value) == str(ref.value) and "colour" in str(ours.value)
    assert params.parse_sim_kwargs(kwargs, strict=False) == ref_params.parse_sim_kwargs(kwargs, strict=False)
    with pytest.raises(InvalidSimulationParameterError, match="colour"):
        maria_torch.Simulation(plans=port_plan(), device="cpu", colour="red",
                               **{k: v for k, v in SCENE_KWARGS.items() if k != "atmosphere"})


def test_pwv_sugar_reaches_the_weather(scene):
    """``pwv=1.2`` as a loose keyword becomes the weather's pwv override,
    beside any other weather override, as in maria_tpu: the observation's
    zenith pwv equals maria_tpu's (1.2 mm, the weather's profile rescaled
    to it) to 1e-12, and the user's weather dict is left as it was."""
    weather = {"temperature": 275.0}
    ref = maria_tpu.Simulation(plans=maria_tpu.get_plan("daisy_5arcmin_60s", **PLAN_KWARGS), pwv=1.2,
                               **SCENE_KWARGS)
    ours = maria_torch.Simulation(plans=port_plan(), pwv=1.2, device="cpu", **SCENE_KWARGS)
    assert ours.atmosphere_kwargs == {"weather": {"pwv": 1.2}} == ref.atmosphere_kwargs
    pwv = ours.obs_list[0].atmosphere.weather.pwv
    np.testing.assert_allclose(pwv, ref.obs_list[0].atmosphere.weather.pwv, rtol=1e-12)
    assert abs(pwv - 1.2) < 1e-4
    both = maria_torch.Simulation(plans=port_plan(), pwv=1.5, atmosphere_kwargs={"weather": weather},
                                  device="cpu", **SCENE_KWARGS)
    assert both.atmosphere_kwargs["weather"] == {"temperature": 275.0, "pwv": 1.5}
    assert weather == {"temperature": 275.0}


def test_loose_keywords_reach_their_subsystem():
    """A loose noise and CMB keyword reach the noise and the CMB; an
    atmosphere keyword beside atmosphere_kwargs yields to it."""
    sim = maria_torch.Simulation(plans=port_plan(), device="cpu", correlated_noise_proportion=0.25, nside=8,
                                 cmb="generate", method="ar", atmosphere_kwargs={"method": "fourier"},
                                 **SCENE_KWARGS)
    assert sim.noise_kwargs["correlated_noise_proportion"] == 0.25
    assert sim.cmb.nside == 8 and sim.cmb_kwargs == {"nside": 8}
    assert sim.atmosphere_kwargs == {"method": "fourier"} and sim.obs_list[0].atmosphere.method == "fourier"
    ar = maria_torch.Simulation(plans=port_plan(), device="cpu", method="ar", sampler_dec_tol=0.2, **SCENE_KWARGS)
    atm = ar.obs_list[0].atmosphere
    assert atm.method == "ar" and atm.sampler_dec_tol == 0.2


def test_from_config_equals_the_constructor():
    """Simulation.from_config(config, **params) with params over config:
    the same TOD, bit for bit, as the constructor with the same keywords."""
    config = dict(SCENE_KWARGS, plans=port_plan(), device="cpu", pwv=1.3, seed=5)
    a = maria_torch.Simulation.from_config(config, seed=SCENE_KWARGS["seed"]).run()[0]
    b = maria_torch.Simulation(**{**config, "seed": SCENE_KWARGS["seed"]}).run()[0]
    c = maria_torch.Simulation(**config).run()[0]
    assert a.fields == b.fields
    for field in a.fields:
        assert torch.equal(a.data[field], b.data[field])
    assert not torch.equal(a.data["noise"], c.data["noise"])


@pytest.mark.parametrize("dtype", [torch.float32, np.float32, "float32", jnp.float32, torch.float64, np.float64,
                                   "float16", torch.bfloat16])
def test_dtype(dtype):
    """float32 in any spelling is taken; any other dtype raises ValueError."""
    kw = dict(SCENE_KWARGS, atmosphere=None, plans=port_plan(), device="cpu", dtype=dtype)
    float32 = dtype in (torch.float32, np.float32, "float32", jnp.float32)
    if float32:
        assert maria_torch.Simulation(**kw).dtype == torch.float32
    else:
        with pytest.raises(ValueError, match="float32 only"):
            maria_torch.Simulation(**kw)


def test_reference_flags_are_kept():
    sim = maria_torch.Simulation(plans=port_plan(), device="cpu", progress_bars=True, keep_mean_signal=True,
                                 **SCENE_KWARGS)
    assert sim.progress_bars and sim.keep_mean_signal and sim.fused


# -- the atmosphere's seed -------------------------------------------------------------------------------


def test_atmosphere_seed_repeats(scene):
    """simulate_pwv without a generator draws from one seeded with the
    atmosphere's seed: the same seed gives the same pwv, another seed
    another; given a generator it draws as the program does, so it equals
    the program's coarse pwv from the same generator state."""
    atm = copy.copy(scene["sim"].obs_list[0].atmosphere)
    atm.seed = 11
    a = atm.simulate_pwv(device="cpu").clone()
    b = atm.simulate_pwv(device="cpu").clone()
    assert torch.equal(a, b) and a.shape == (217, len(scene["program"].t_coarse))
    assert atm.det_el.shape == a.shape and atm.zenith_scaled_pwv is not None
    atm.seed = 12
    assert not torch.equal(atm.simulate_pwv(device="cpu"), a)
    gen = torch.Generator().manual_seed(3)
    from_atm = atm.simulate_pwv(generator=gen, device="cpu")
    gen.manual_seed(3)
    from_program = scene["program"].fields(generator=gen, device="cpu", upto="pwv")["pwv"]
    assert torch.equal(from_atm, from_program)
    kept = maria_torch.atmosphere.Atmosphere(seed=4, disable_progress_bars=False, sampler_dec_tol=0.1)
    assert kept.seed == 4 and not kept.disable_progress_bars and kept.sampler_dec_tol == 0.1


def test_atmosphere_seed_through_the_simulation():
    """Atmosphere keywords reach the atmosphere through atmosphere_kwargs."""
    sim = maria_torch.Simulation(plans=port_plan(), device="cpu", atmosphere_kwargs={"seed": 9}, **SCENE_KWARGS)
    assert sim.obs_list[0].atmosphere.seed == 9


# -- the per-stage path ------------------------------------------------------------------------------------


def mixin_key():
    return jax.random.key(21)


def mixin_draws(scene):
    """maria_tpu's mixin normals for one call of _simulate_atmosphere and
    one of _simulate_noise with mixin_key(): the pwv's screens from the
    key's split into one key a screen (atmosphere/sampling.py:106), the
    noise from each band's split of the key that follows
    (sim/noise.py:20, noise/__init__.py:77)."""
    from maria_tpu.atmosphere.fourier import good_fft_size

    p = scene["ref_program"]
    keys = jax.random.split(mixin_key(), max(len(p.screens), 1))
    draws = {"screens": [np.asarray(jax.random.normal(keys[i], (s.ny, s.nx // 2 + 1, 2), dtype=jnp.float32))
                         for i, s in enumerate(p.screens)], "noise": [], "modes": []}
    key = mixin_key()
    n_f = good_fft_size(len(p.t_fine)) // 2 + 1
    for band in p.bands:
        key, band_key = jax.random.split(key)
        _, key_pink, key_modes = jax.random.split(band_key, 3)
        draws["noise"].append(np.asarray(jax.random.normal(key_pink, (len(band.det_index), n_f, 2))))
        k = band.noise_basis.shape[-1]
        draws["modes"].append(np.asarray(jax.random.normal(key_modes, (k, n_f, 2))))
    return to_torch(draws)


def test_per_stage_path_matches_maria_tpu_mixins(scene):
    """Simulation(fused=False)'s atmosphere stage against maria_tpu's
    AtmosphereMixin on the same screens: the coarse pwv to 1e-3 of its
    fluctuation and the upsampled loading to 2e-6 relative plus 1e-4 of
    its fluctuation (test_torch_slice's float32 bounds); the noise stage
    against maria_tpu's NoiseMixin on the same normals, to 1e-4 of its
    std."""
    from maria_torch.sim.atmosphere import compute_atmospheric_loading, simulate_atmosphere

    ref_sim, sim = scene["ref_sim"], scene["sim"]
    ref_obs, obs = ref_sim.obs_list[0], copy.copy(sim.obs_list[0])
    ref_sim._simulate_atmosphere(ref_obs, mixin_key())
    ref_loading = np.asarray(ref_sim._compute_atmospheric_loading(ref_obs))
    draws = mixin_draws(scene)
    simulate_atmosphere(obs, draws=draws, device="cpu")
    ref_pwv = np.asarray(ref_obs.atmosphere.zenith_scaled_pwv)
    fluct = ref_pwv - ref_pwv.mean()
    np.testing.assert_allclose(obs.atmosphere.zenith_scaled_pwv.numpy(), ref_pwv, rtol=0, atol=1e-3 * fluct.std())
    np.testing.assert_allclose(obs.zenith_scaled_pwv.numpy(), np.asarray(ref_obs.zenith_scaled_pwv), rtol=0,
                               atol=1e-3 * fluct.std())
    loading = compute_atmospheric_loading(obs).numpy()
    np.testing.assert_allclose(loading, ref_loading, rtol=2e-6, atol=1e-4 * (ref_loading - ref_loading.mean()).std())

    ref_obs.loading = {}
    ref_sim._simulate_noise(ref_obs, mixin_key())
    ref_noise = np.asarray(ref_obs.loading["noise"])
    noise = sim._simulate_noise(obs, draws).numpy()
    np.testing.assert_allclose(noise, ref_noise, rtol=0, atol=1e-4 * ref_noise.std())


def test_per_stage_path_equals_the_fused_program():
    """The same scene, seed and generator through the fused program and
    the per-stage path: the draws come in the same order, so the noise
    and gains are equal, and the atmosphere within 1e-3 of the field's
    maximum: the program interpolates float32 tables on float32 axes
    (cropped, as maria_tpu's program does), the stage maria_tpu's mixin
    table on float64 axes (4e-4 measured). maria_tpu's own gate, each
    field's std within 0.5-2x of the fused run's, holds a fortiori."""
    kw = dict(SCENE_KWARGS, plans=port_plan(), device="cpu")
    fused = maria_torch.Simulation(**kw).run(units="pW")[0]
    staged_sim = maria_torch.Simulation(fused=False, **kw)
    staged = staged_sim.run(units="pW")[0]
    assert staged.fields == fused.fields == ["atmosphere", "noise"] and staged_sim._programs == {}
    assert torch.equal(staged.data["noise"], fused.data["noise"])
    a, b = staged.data["atmosphere"], fused.data["atmosphere"]
    assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
    for field in staged.fields:
        ratio = float(staged.data[field].std() / fused.data[field].std())
        assert 0.5 <= ratio <= 2.0
    assert staged.metadata["pwv"] == fused.metadata["pwv"]


def test_per_stage_path_with_cmb_and_map(scene):
    """fused=False with a CMB and an input map: the fields of the fused
    program, the CMB's and map's calibration taken at the same fine-rate
    pwv (the map's through the atmosphere's transmission), within 1e-3 of
    each field's maximum; their std within maria_tpu's 0.5-2x gate."""
    from maria_torch.cmb import generate_cmb

    sky = maria_torch.map.get("big_cluster", center=(150.0, 10.0))
    plan = maria_torch.Planner(target=sky, site="GBT").generate_plans(
        start_time=1.75e9, horizon_days=2, total_duration=10.0, chunk_duration=10.0, scan_pattern="daisy",
        scan_options={"radius": 0.083, "speed": 0.017}, sample_rate=50)[0]
    kw = dict(SCENE_KWARGS, plans=plan, map=sky, cmb=generate_cmb(nside=64, seed=1, device="cpu"), device="cpu")
    fused = maria_torch.Simulation(**kw).run(units="pW")[0]
    staged = maria_torch.Simulation(fused=False, **kw).run(units="pW")[0]
    assert staged.fields == fused.fields == ["atmosphere", "cmb", "map", "noise"]
    for field in staged.fields:
        a, b = staged.data[field], fused.data[field]
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max()), field
        assert 0.5 <= float(a.std() / b.std()) <= 2.0, field


# -- the photon-loading noise term --------------------------------------------------------------------------


def test_nep_per_loading_in_the_program(scene):
    """A band with NEP_per_loading: the program's noise is 1e12 (NEP +
    NEP_per_loading P) times the unit-NEP noise, P the atmosphere's
    loading in W, sample by sample, against maria_tpu's fused program on
    the same draws to 1e-4 of its std; use_noise_matmul is then false
    (the matrix product cannot carry a scale that varies by sample), and
    true again without it."""
    program, ref_program = scene["program"], scene["ref_program"]
    band, ref_band = program.bands[0], ref_program.bands[0]
    assert program.use_noise_matmul()
    draws = to_torch(jax_draws(ref_program))
    npl = band.NEP / 3e-12  # the term equals the NEP at 3 pW of loading
    band.NEP_per_loading = ref_band.NEP_per_loading = npl
    try:
        assert not program.use_noise_matmul()
        fields, _ = program.fields(draws=draws, device="cpu")
        key = jax.random.split(jax.random.key(0))[1]
        ref = np.asarray(ref_program._loadings(key, *ref_program.example_args(key)[1:])["noise"])
    finally:
        band.NEP_per_loading = ref_band.NEP_per_loading = 0.0
    assert program.use_noise_matmul()
    unscaled = generate_noise_with_knee(fields["noise"].shape, sample_rate=program.sample_rate, knee=band.knee,
                                        basis=band.noise_basis, corr_prop=band.corr_prop, white=draws["noise"][0],
                                        mode_white=draws["modes"][0], device="cpu")
    formula = 1e12 * (band.NEP + npl * 1e-12 * fields["atmosphere"].double()) * unscaled.double()
    np.testing.assert_allclose(fields["noise"].double().numpy(), formula.numpy(), rtol=1e-5,
                               atol=1e-6 * float(formula.abs().max()))
    np.testing.assert_allclose(fields["noise"].numpy(), ref, rtol=0, atol=1e-4 * ref.std())
    total = program.total_power_fn()
    assert total.__name__ == "matmul_total"


def test_nep_per_loading_without_an_atmosphere(scene):
    """_simulate_noise with a loading: maria_tpu's NoiseMixin formula
    (sim/noise.py:27-33) on the same normals, to 1e-4 of its std, over a
    loading of two fields summed."""
    ref_sim, sim = scene["ref_sim"], scene["sim"]
    ref_obs, obs = ref_sim.obs_list[0], sim.obs_list[0]
    band, ref_band = obs.instrument.dets.bands[0], ref_obs.instrument.dets.bands[0]
    rng = np.random.default_rng(2)
    parts = [(2e-12 + 1e-13 * rng.standard_normal(obs.shape)).astype(np.float32) for _ in range(2)]
    npl = band.NEP / 2e-12
    band.NEP_per_loading = ref_band.NEP_per_loading = npl
    try:
        ref_obs.loading = {"a": jnp.asarray(1e12 * parts[0]), "b": jnp.asarray(1e12 * parts[1])}
        ref_sim._simulate_noise(ref_obs, mixin_key())
        ref = np.asarray(ref_obs.loading["noise"])
        draws = mixin_draws(scene)
        ours = sim._simulate_noise(obs, draws, loading={"a": torch.as_tensor(1e12 * parts[0]),
                                                        "b": torch.as_tensor(1e12 * parts[1])}).numpy()
    finally:
        band.NEP_per_loading = ref_band.NEP_per_loading = 0.0
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * ref.std())
    plain = sim._simulate_noise(obs, draws).numpy()
    assert 2.9 < ours.std() / plain.std() < 3.1  # NEP + (NEP / 2 pW) x 4 pW


# -- noise without a knee --------------------------------------------------------------------------------


def test_knee_free_noise_matches_maria_tpu():
    """knee <= 0: sqrt(sample_rate) N(0, 1) of shape (n_det, n), no
    correlated part and no kernel (maria_tpu/noise/__init__.py:78-79),
    equal to maria_tpu's on its own normals; the white draw handed in is
    (n_det, n), and another shape raises."""
    from maria_tpu.noise import generate_noise_with_knee as ref_fn

    from maria_torch.ops.pink_noise import pink_noise

    key = jax.random.key(8)
    shape, fs = (6, 1000), 50.0
    ref = np.asarray(ref_fn(key, shape, sample_rate=fs, knee=0.0, basis=np.ones((6, 2)), corr_prop=0.5))
    white = torch.as_tensor(np.asarray(jax.random.normal(jax.random.split(key, 3)[0], shape, dtype=jnp.float32)))
    launches = pink_noise.launches
    ours = generate_noise_with_knee(shape, sample_rate=fs, knee=0.0, basis=np.ones((6, 2)), corr_prop=0.5,
                                    white=white, device="cpu")
    assert pink_noise.launches == launches and ours.shape == shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6)
    with pytest.raises(ValueError, match="white draw must have shape"):
        generate_noise_with_knee(shape, sample_rate=fs, knee=0.0, white=torch.zeros(6, 513, 2), device="cpu")


def test_knee_free_noise_variance_and_flat_psd():
    """Unit-NEP noise without a knee: variance sample_rate within 2%, and a
    flat PSD, the mean periodogram in eight bands of frequency each within
    10% of their mean."""
    gen = torch.Generator().manual_seed(0)
    fs, n = 50.0, 20000
    x = generate_noise_with_knee((64, n), sample_rate=fs, knee=0.0, generator=gen, device="cpu").double()
    assert abs(float(x.var()) / fs - 1) < 0.02
    psd = (torch.fft.rfft(x, dim=-1).abs() ** 2).mean(0).numpy()[1:] / n
    bands = [b.mean() for b in np.array_split(psd, 8)]
    assert max(abs(b / np.mean(bands) - 1) for b in bands) < 0.10


def test_knee_free_band_in_the_program(scene):
    """A band with knee 0 in the program: its noise is 1e12 NEP
    sqrt(fs) times the (n_det, n) white draw handed in."""
    program = scene["program"]
    band = program.bands[0]
    knee = band.knee
    band.knee = 0.0
    try:
        white = torch.randn((len(band.det_index), program.n_t), generator=torch.Generator().manual_seed(1))
        fields, _ = program.fields(draws={"screens": jax_screen_draws(scene), "noise": [white], "modes": [None]},
                                   device="cpu")
    finally:
        band.knee = knee
    expected = float(np.float32(1e12 * band.NEP)) * float(np.sqrt(program.sample_rate)) * white
    np.testing.assert_allclose(fields["noise"].numpy(), expected.numpy(), rtol=1e-6)


def jax_screen_draws(scene):
    return to_torch(jax_draws(scene["ref_program"]))["screens"]


def test_docs_simulating_snippet_runs_on_the_cpu():
    """docs/usage.md's "Simulating" snippet with its keywords as written
    (the Planner's ra/dec daisy, the 2-D atmosphere, cmb="generate", the
    cluster map, noise, pwv=1.2 loose, seed 0), plus device="cpu" and the
    loose nside=64 (the default nside 1024 is for the card), on a 20 s cut
    of the plan: run(units="K_RJ") gives the four fields, finite, and the
    observation's zenith pwv is 1.2 mm."""
    plans = maria_torch.Planner(target=(150.0, 10.0), site="GBT").generate_plans(
        start_time=1.75e9, horizon_days=2, total_duration=20, scan_pattern="daisy", scan_options={"radius": 0.083},
    )
    sim = maria_torch.Simulation(
        instrument="MUSTANG-2", plans=plans, site="GBT", atmosphere="2d", cmb="generate",
        map=maria_torch.map.get("cluster", center=(150.0, 10.0)), noise=True, pwv=1.2, seed=0, device="cpu",
        nside=64,
    )
    tods = sim.run(units="K_RJ")
    assert len(tods) == len(plans) >= 1
    tod = tods[0]
    assert tod.fields == ["atmosphere", "cmb", "map", "noise"] and tod.units == "K_RJ"
    assert all(bool(torch.isfinite(v).all()) for v in tod.data.values())
    assert abs(sim.obs_list[0].atmosphere.weather.pwv - 1.2) < 1e-4 and tod.metadata["pwv"] == 1.2
