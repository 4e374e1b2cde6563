"""The port's MUSTANG-2 simulate-and-bin slice against maria_tpu, on CPU.

One module-scoped scene (MUSTANG-2, GBT, 10 s daisy in az/el, 2-D
atmosphere, noise) is built by both packages, each with a private data
cache (the shared default cache can hold a corrupt green_bank spectrum
written by maria_tpu's shared temporary path). The JAX package's key
stream is reproduced here with jax.random, and its draws are handed to
the port as numpy arrays, so each stage compares like with like:

- scene tables: configs, weather, spectrum, band tables, the program's
  static arrays;
- per stage: pointing, the Matérn screen, accumulate_pwv, the
  atmospheric loading, the noise field with its correlated modes, gains;
- the whole slice: TOD fields in K_RJ and the BinMapper map;
- the port's own generator path, by distribution (noise PSD, pwv rms).

Tolerances are f32: each comparison states its own.
"""

import ast
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import maria_torch  # noqa: E402
import maria_tpu  # noqa: E402
from maria_tpu.io import caching as tpu_caching  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_jax_stream import jax_draws, to_torch  # noqa: E402, F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0
DURATION = 10.0
PLAN_KWARGS = dict(
    start_time=1.75e9, scan_center=(150.0, 41.0), frame="az/el", duration=DURATION,
    sample_rate=50.0, scan_options={"radius": 0.083, "speed": 0.017},
)
SCENE_KWARGS = dict(instrument="MUSTANG-2", site="GBT", atmosphere="2d", noise=True, seed=SEED)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Both packages' simulations of the same scene, private caches."""
    old_tpu, old_torch = tpu_caching.get_cache_dir(), maria_torch.io._cache_state["base"]
    maria_tpu.set_cache_dir(str(tmp_path_factory.mktemp("maria_tpu_cache")))
    maria_torch.set_cache_dir(str(tmp_path_factory.mktemp("maria_torch_cache")))
    try:
        from maria_tpu.ops.program import build_tod_program

        ref_sim = maria_tpu.Simulation(plans=maria_tpu.get_plan("daisy_5arcmin_60s", **PLAN_KWARGS), **SCENE_KWARGS)
        ref_program = build_tod_program(ref_sim.obs_list[0], noise_kwargs=ref_sim.noise_kwargs)
        sim = maria_torch.Simulation(
            plans=maria_torch.get_plan("daisy_5arcmin_60s", **PLAN_KWARGS), device="cpu", **SCENE_KWARGS
        )
        yield {"ref_sim": ref_sim, "ref_program": ref_program, "sim": sim, "program": sim.program()}
    finally:
        maria_tpu.set_cache_dir(old_tpu)
        maria_torch.set_cache_dir(old_torch)


def program_tables(p):
    """A maria_tpu TODProgram's static tables as numpy arrays, the input
    of maria_torch.convert.program_from_tables."""
    from maria_tpu.ops.program import _crop_table

    return {
        "offsets": np.asarray(p.offsets), "bs_az_coarse": np.asarray(p.bs_az_coarse),
        "bs_el_coarse": np.asarray(p.bs_el_coarse), "t_coarse": np.asarray(p.t_coarse),
        "t_fine": np.asarray(p.t_fine), "mueller_I": np.asarray(p.mueller_I),
        "gain_error": np.asarray(p.gain_error), "mean_pwv": p.mean_pwv, "sample_rate": p.sample_rate,
        "with_noise": p.with_noise,
        "screens": [
            {k: getattr(s, k) for k in ("h", "z", "res", "pwv_rms", "angle", "vx", "vy", "tx_min", "ty_min",
                                        "nx", "ny", "ty_res", "win_x", "win_y", "band")}
            | {"W": np.asarray(s.W)}
            for s in p.screens
        ],
        "bands": [
            {"name": b.name, "det_index": np.asarray(b.det_index), "NEP": b.NEP, "knee": b.knee,
             "noise_basis": None if b.noise_basis is None else np.asarray(b.noise_basis),
             "corr_prop": b.corr_prop, "pwv_side": np.asarray(b.pwv_side), "el_side": np.asarray(b.el_side),
             "power_table": np.asarray(b.power_table)}
            for b in p.bands
        ],
    }


# -- configs and scene tables ------------------------------------------------------


@pytest.mark.parametrize(
    "json_name,yaml_path",
    [
        ("instrument_m2", "maria_tpu/instrument/configs/m2.yml"),
        ("array_m2", "maria_tpu/array/configs/m2.yml"),
        ("band_m2", "maria_tpu/band/configs/m2.yml"),
        ("instrument_atlast", "maria_tpu/instrument/configs/atlast.yml"),
        ("band_atlast", "maria_tpu/band/configs/atlast.yml"),
    ] + [(f"{kind}_{tag}", f"maria_tpu/{kind}/configs/{tag}.yml") for kind, tags in (
        ("band", ("abs", "act", "alma", "apex", "music", "so", "test", "toltec")),
        ("array", ("act", "alma", "apex", "hd", "so")),
        ("instrument", ("act", "alma", "apex", "hd", "lmt", "music", "newmusic", "so", "test")),
    ) for tag in tags],
)
def test_json_configs_equal_yaml_sources(json_name, yaml_path):
    with open(os.path.join(REPO, "maria_torch", "configs", f"{json_name}.json")) as f:
        ours = json.load(f)
    with open(os.path.join(REPO, yaml_path)) as f:
        assert ours == yaml.safe_load(f)


def test_plan_site_region_configs_equal_sources():
    from maria_tpu.site import SITE_CONFIGS
    from maria_tpu.site.regions import REGIONS

    from maria_torch.io import read_config

    with open(os.path.join(REPO, "maria_tpu", "plan", "configs", "plans.yml")) as f:
        plans = yaml.safe_load(f)
    for name, cfg in read_config("plans").items():
        assert cfg == plans[name]
    assert sorted(read_config("plans")) == sorted(plans)
    assert sorted(read_config("sites")) == sorted(SITE_CONFIGS)
    assert list(read_config("regions")) == list(REGIONS.index)
    for name, cfg in read_config("sites").items():
        assert cfg == SITE_CONFIGS[name]
    for name, row in read_config("regions").items():
        ref = REGIONS.loc[name]
        assert row == {k: (v.item() if hasattr(v, "item") else v) for k, v in ref.items()}


def test_import_guard():
    """No module of maria_torch, and not chip_smoke.py (the port's smoke
    test on the card), imports jax or maria_tpu."""
    bad = []
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "maria_torch")):
        paths += [os.path.join(root, name) for name in files if name.endswith(".py")]
    assert len(paths) > 30
    for module in ("atmosphere/process.py", "ops/ar_extrude.py", "ops/kernels.py", "convert.py", "healpix/core.py",
                   "healpix/sht.py", "cmb/__init__.py", "cmb/spectra.py", "map/healpix.py", "sim/cmb.py", "ops/sht.py",
                   "utils/signal.py", "tod/processing.py", "mappers/ml_mapper.py", "radiometry.py",
                   "array/generation.py", "plan/patterns.py", "band/__init__.py", "array/__init__.py",
                   "instrument/__init__.py", "site/__init__.py", "scenes.py", "errors.py", "units/__init__.py",
                   "units/units.py", "units/quantity.py", "units/prefixes.py", "calibration/functions.py",
                   "sim/params.py", "sim/atmosphere.py", "map/base.py", "noise/streaming.py", "ops/streaming_exec.py",
                   "atmosphere/streaming.py", "mappers/streaming_ml.py", "ops/pink_cascade.py",
                   "parallel/__init__.py", "parallel/multihost.py", "parallel/binning.py"):
        assert os.path.join(REPO, "maria_torch", *module.split("/")) in paths, module
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad += [(path, m) for m in mods if m.split(".")[0] in ("jax", "jaxlib", "maria_tpu")]
    assert not bad, bad


def test_weather_and_spectrum_tables(scene):
    ref_atm = scene["ref_sim"].obs_list[0].atmosphere
    atm = scene["sim"].obs_list[0].atmosphere
    for field in ("temperature", "pressure", "humidity", "wind_east", "wind_north", "wind_speed"):
        np.testing.assert_allclose(getattr(atm.weather, field), getattr(ref_atm.weather, field), rtol=1e-12)
    np.testing.assert_allclose(atm.weather.pwv, ref_atm.weather.pwv, rtol=1e-12)
    for a, b in zip(atm.spectrum.points, ref_atm.spectrum.points):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(atm.spectrum._emission, ref_atm.spectrum._emission)
    np.testing.assert_array_equal(atm.spectrum._opacity, ref_atm.spectrum._opacity)
    for field in ("h", "res", "z", "total_water", "pwv_rms"):
        np.testing.assert_allclose(atm.layers[field], ref_atm.layers[field].values, rtol=1e-12)


def test_program_tables_match(scene):
    """The port's own build_tod_program reproduces maria_tpu's tables."""
    from maria_tpu.ops.program import _crop_table

    ref, ours = scene["ref_program"], scene["program"]
    for name in ("offsets", "bs_az_coarse", "bs_el_coarse", "t_coarse", "t_fine", "mueller_I", "gain_error"):
        np.testing.assert_allclose(getattr(ours, name), np.asarray(getattr(ref, name)), rtol=1e-12, atol=1e-15)
    assert ours.upsample_ratio == ref.upsample_ratio
    np.testing.assert_allclose(ours.mean_pwv, ref.mean_pwv, rtol=1e-12)
    assert len(ours.screens) == len(ref.screens)
    for s, r in zip(ours.screens, ref.screens):
        for k in ("h", "z", "res", "pwv_rms", "angle", "vx", "vy", "tx_min", "ty_min"):
            np.testing.assert_allclose(getattr(s, k), getattr(r, k), rtol=1e-10, atol=1e-9)
        assert (s.nx, s.ny, s.win_x, s.win_y, s.band) == (r.nx, r.ny, r.win_x, r.win_y, r.band)
        np.testing.assert_allclose(s.W, np.asarray(r.W), rtol=1e-6)
    for b, r in zip(ours.bands, ref.bands):
        np.testing.assert_array_equal(b.det_index, r.det_index)
        assert (b.name, b.NEP, b.knee, b.corr_prop) == (r.name, r.NEP, r.knee, r.corr_prop)
        np.testing.assert_allclose(b.noise_basis, r.noise_basis, rtol=1e-10, atol=1e-12)
        # the port stores the table cropped to the reachable window, as
        # maria_tpu's evaluator does
        atm = scene["ref_sim"].obs_list[0].atmosphere
        sigma = float(np.sqrt(sum(float(s.pwv_rms) ** 2 for s in atm.screens)))
        bs_el = np.asarray(atm.boresight.el)
        off = float(np.abs(np.asarray(scene["ref_sim"].obs_list[0].offsets)).max())
        xs, ys, tab = _crop_table(
            np.asarray(r.pwv_side), np.asarray(r.el_side), np.asarray(r.power_table),
            max(0.0, ref.mean_pwv - 8 * sigma), ref.mean_pwv + 8 * sigma,
            max(np.radians(5.0), bs_el.min() - 2 * off), min(np.pi / 2, bs_el.max() + 2 * off),
        )
        np.testing.assert_allclose(b.pwv_side, xs, rtol=1e-7)
        np.testing.assert_allclose(b.el_side, ys, rtol=1e-7)
        np.testing.assert_allclose(b.power_table, tab, rtol=1e-6)


def test_spectrum_cache_is_validated(tmp_path):
    """A corrupt cached spectrum is regenerated, not read."""
    from maria_torch.spectrum import _load_valid

    path = tmp_path / "green_bank.npz"
    path.write_bytes(b"not a zip archive")
    assert _load_valid(str(path)) is None
    np.savez(path, side_nu_Hz=np.arange(3.0))
    assert _load_valid(str(path)) is None


# -- per-stage parity with injected draws ---------------------------------------------


def test_pointing(scene):
    from maria_tpu.coords.transforms import offsets_to_phi_theta as ref_fn

    from maria_torch.coords import offsets_to_phi_theta

    p = scene["program"]
    offs = np.asarray(p.offsets, dtype=np.float32)[:, None, :]
    az = np.asarray(p.bs_az_coarse, dtype=np.float32)
    el = np.asarray(p.bs_el_coarse, dtype=np.float32)
    ref = np.asarray(ref_fn(jnp.asarray(offs), jnp.asarray(az), jnp.asarray(el)))
    ours = offsets_to_phi_theta(torch.as_tensor(offs), torch.as_tensor(az), torch.as_tensor(el)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)  # f32 radians near az ~ 2.6


def test_matern_screen(scene):
    from maria_tpu.atmosphere.fourier import synthesize_matern_field_2d as ref_fn

    from maria_torch.atmosphere.fourier import synthesize_matern_field_2d

    for i in (0, 1, len(scene["ref_program"].screens) - 2):
        s = scene["ref_program"].screens[i]
        key = jax.random.key(100 + i)
        draw = np.array(jax.random.normal(key, (s.ny, s.nx // 2 + 1, 2), dtype=jnp.float32))
        ref = np.asarray(ref_fn(key, jnp.asarray(s.W), s.ny, s.nx))
        ours = synthesize_matern_field_2d(torch.as_tensor(np.array(s.W)), s.ny, s.nx, draw=torch.as_tensor(draw)).numpy()
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * ref.std())


@pytest.mark.parametrize("kind", ["cubic", "linear"])
def test_upsample(kind):
    """Both upsamplers (integer-ratio phase stencil, arbitrary fine
    times) equal maria_tpu's, to f32."""
    from maria_tpu.ops.interp import upsample_time as ref_general
    from maria_tpu.ops.interp import upsample_time_phases as ref_phases

    from maria_torch.ops.interp import upsample_time, upsample_time_phases

    rng = np.random.default_rng(2)
    values = rng.standard_normal((7, 13)).astype(np.float32)
    ref = np.asarray(ref_phases(jnp.asarray(values), 49, 600, kind=kind))
    ours = upsample_time_phases(torch.as_tensor(values), 49, 600, kind=kind).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
    t_c = np.arange(13, dtype=np.float32) * 0.97
    t_f = np.linspace(-0.2, 12.5, 301).astype(np.float32)
    ref = np.asarray(ref_general(jnp.asarray(values), jnp.asarray(t_c), jnp.asarray(t_f), kind=kind))
    ours = upsample_time(torch.as_tensor(values), t_c, t_f, kind=kind).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def _ref_program_key(seed=SEED):
    key = jax.random.key(seed)
    return jax.random.split(key)[1]


def _ref_upto(scene, upto):
    p = scene["ref_program"]
    key = _ref_program_key()
    return p._loadings(key, *[a for a in p.example_args(key)[1:]], upto=upto)


@pytest.fixture(scope="module")
def draws(scene):
    return to_torch(jax_draws(scene["ref_program"]))


def test_accumulate_pwv(scene, draws):
    ref = np.asarray(_ref_upto(scene, "pwv")["pwv"])
    ours = scene["program"].fields(draws=draws, device="cpu", upto="pwv")["pwv"].numpy()
    # pwv is ~17 mm of mean plus ~0.02 mm of turbulence: f32 carries the
    # sum to ~2e-6 mm, so the bound is 1e-3 of the fluctuation (~10 ulp)
    fluct = ref - ref.mean()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-3 * fluct.std())


def test_atmosphere_loading(scene, draws):
    ref = np.asarray(_ref_upto(scene, "atmosphere")["atmosphere"])
    ours = scene["program"].fields(draws=draws, device="cpu", upto="atmosphere")["atmosphere"].numpy()
    # f32: a few ulp of the loading's level, plus 1e-4 of its fluctuation
    np.testing.assert_allclose(ours, ref, rtol=2e-6, atol=1e-4 * (ref - ref.mean()).std())


def test_noise_with_correlated_modes(scene, draws):
    """The noise field given maria_tpu's _spectral_white draws, including
    the correlated modes, to 1e-4 x std."""
    from maria_tpu.noise import generate_noise_with_knee as ref_fn

    from maria_torch.noise import generate_noise_with_knee

    p = scene["ref_program"]
    band = p.bands[0]
    key_noise = jax.random.split(_ref_program_key(), 3)[1]
    n_t = len(p.t_fine)
    ref = np.asarray(ref_fn(jax.random.fold_in(key_noise, 0), shape=(len(band.det_index), n_t),
                            sample_rate=p.sample_rate, knee=band.knee, basis=band.noise_basis,
                            corr_prop=band.corr_prop))
    ours = generate_noise_with_knee(
        (len(band.det_index), n_t), sample_rate=p.sample_rate, knee=band.knee,
        basis=band.noise_basis, corr_prop=band.corr_prop,
        white=draws["noise"][0], mode_white=draws["modes"][0], device="cpu",
    ).numpy()
    assert band.corr_prop == 0.5 and band.noise_basis.shape == (217, 5)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * ref.std())


def test_gains(scene, draws):
    p = scene["ref_program"]
    key = jax.random.key(SEED)
    key = jax.random.split(key)[0]
    gain_key = jax.random.split(key)[1]
    ref = np.asarray(jnp.exp(jnp.asarray(p.gain_error, jnp.float32) * jax.random.normal(gain_key, (len(p.offsets),))))
    ours = scene["program"].draw_gains(draw=draws["gains"], device="cpu")[:, 0].numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6)


def test_convert_program_from_tables(scene, draws):
    """A program carried over from maria_tpu's tables gives the same
    fields as the port's own build."""
    from maria_torch.convert import program_from_tables

    carried = program_from_tables(program_tables(scene["ref_program"]))
    a, _ = carried.fields(draws=draws, device="cpu")
    b, _ = scene["program"].fields(draws=draws, device="cpu")
    for k in ("atmosphere", "noise"):
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=2e-6, atol=1e-4 * float(b[k].std()))


# -- the whole slice ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def slice_runs(scene, draws):
    ref_tod = scene["ref_sim"].run()[0]
    tod = scene["sim"].run(draws=[draws])[0]
    return ref_tod, tod


def test_slice_fields_match(slice_runs):
    ref_tod, tod = slice_runs
    assert tod.units == ref_tod.units == "K_RJ"
    assert tod.fields == ref_tod.fields == ["atmosphere", "noise"]
    for k in tod.fields:
        ref = np.asarray(ref_tod.data[k])
        ours = tod.data[k].numpy()
        assert ours.shape == ref.shape == (217, 500)
        np.testing.assert_allclose(ours, ref, rtol=2e-6, atol=1e-4 * (ref - ref.mean()).std())


def test_slice_map_matches(slice_runs):
    """BinMapper maps of the two TODs agree. Pixel ids come from f32
    pointing (az ~ 2.6 rad carries ~0.05 arcsec), so a sample within
    that of a pixel edge (14 arcsec pixels here) may land in the
    neighbour: at most 0.5% of the hits move, and each moved sample
    changes two pixels. The binned totals agree to f32, and 80% of the
    pixels hold the same value to 1e-5 relative (f32 sums of ~200 K_RJ
    samples; the rest gained or lost an edge sample).
    test_bin_mapper_equals_direct_binning holds the mapper itself."""
    from maria_tpu.mappers import BinMapper as RefBinMapper

    ref_tod, tod = slice_runs
    center = tuple(np.degrees(tod.boresight.center()))
    kw = dict(center=center, width=0.25, resolution=0.25 / 64, frame="az/el",
              map_postprocessing={"keep_mean": True})
    ref_map = RefBinMapper(ref_tod, **kw).run()
    ours = maria_torch.BinMapper(tod, **kw).run()
    ref_w = np.asarray(ref_map.weight)
    w = ours.weight.numpy()
    assert w.shape == ref_w.shape == (1, 1, 1, 64, 64)
    assert w.sum() == ref_w.sum() == 217 * 500
    assert np.abs(w - ref_w).sum() <= 5e-3 * ref_w.sum()
    ref_d = np.nan_to_num(np.asarray(ref_map.data))
    d = ours.data.numpy()
    np.testing.assert_allclose((d * w).sum(), (ref_d * ref_w).sum(), rtol=1e-5)
    hit = (w > 0) & (ref_w > 0)
    close = np.abs(d - ref_d)[hit] <= 1e-5 * np.abs(ref_d[hit])
    assert close.mean() >= 0.8, close.mean()


def test_bin_mapper_equals_direct_binning(slice_runs):
    """The port's BinMapper map equals np.add.at of its TOD at its own
    pixel ids, before the zero-mean convention."""
    from maria_torch.coords import phi_theta_to_offsets
    from maria_torch.mappers.bin_mapper import pixel_ids

    _, tod = slice_runs
    center = tuple(np.degrees(tod.boresight.center()))
    mapper = maria_torch.BinMapper(tod, center=center, width=0.25, resolution=0.25 / 64, frame="az/el",
                                   map_postprocessing={"keep_mean": True})
    out = mapper.run()
    az, el = tod.pointing.det_azel(device="cpu")
    offs = phi_theta_to_offsets(torch.stack([az, el], dim=-1), *mapper.center)
    x0 = -(mapper.n_x - 1) / 2 * mapper.res
    ids = pixel_ids(offs[..., 0], offs[..., 1], x0, x0, mapper.res, mapper.n_x, mapper.n_y).numpy().ravel()
    good = ids >= 0
    sums = np.zeros(64 * 64)
    hits = np.zeros(64 * 64)
    np.add.at(sums, ids[good], tod.signal.double().numpy().ravel()[good])
    np.add.at(hits, ids[good], 1.0)
    np.testing.assert_array_equal(out.weight.numpy().ravel(), hits)
    seen = hits > 0
    np.testing.assert_allclose(out.data.numpy().ravel()[seen], (sums[seen] / hits[seen]), rtol=2e-6)


def test_generator_path_by_distribution(scene):
    """The port's own torch.Generator draws give the same processes: the
    noise PSD above 2x the knee matches the process's expected PSD, and
    the pwv at one sample varies across realizations by the sum of the
    layers' variances (each fine/coarse pair carries its layer once)."""
    from maria_torch.atmosphere.fourier import good_fft_size
    from maria_torch.noise import _pink_weights_np

    p = scene["program"]
    band = p.bands[0]
    gen = torch.Generator().manual_seed(5)
    fields, _ = p.fields(generator=gen, device="cpu")
    x = fields["noise"].double().numpy() / (1e12 * band.NEP)
    n = x.shape[-1]
    measured = (np.abs(np.fft.rfft(x - x.mean(-1, keepdims=True), axis=-1)) ** 2).mean(0) / n
    f = np.fft.rfftfreq(n, d=1 / p.sample_rate)
    n_fft = good_fft_size(n)
    w2 = np.interp(f, np.fft.rfftfreq(n_fft, d=1 / p.sample_rate), _pink_weights_np(n_fft, p.sample_rate, band.knee, 1.0) ** 2)
    b2 = float(np.mean(np.sum(band.noise_basis**2, axis=-1)))
    expected = p.sample_rate + (1 - band.corr_prop) * w2 + band.corr_prop * b2 * w2
    sel = (f >= 2 * band.knee) & (f < 0.98 * p.sample_rate / 2)
    # 217 detectors x ~200 bins: the mean periodogram is good to ~1%
    assert abs(measured[sel].mean() / expected[sel].mean() - 1) < 0.05

    # 64 realizations: the variance estimate is good to ~18% (1 sigma)
    samples = np.array([
        float(p.fields(generator=gen, device="cpu", upto="pwv")["pwv"][0, 0]) for _ in range(64)
    ])
    layer_var = sum(s.pwv_rms**2 for s in p.screens if s.band != "coarse")
    ratio = samples.var() / layer_var
    assert 0.5 < ratio < 1.6, ratio
    assert abs(samples.mean() - p.mean_pwv) < 4 * np.sqrt(layer_var / 64)
