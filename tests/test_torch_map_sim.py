"""The port's input maps, map stage, noise-only scenes and ra/dec BinMapper
against maria_tpu, on the CPU.

One module-scoped scene is built by both packages with private data
caches: MUSTANG-2 at the GBT on a Planner-made 20 s ra/dec daisy over the
synthetic ``big_cluster`` map at (150, 10) deg, once with the 2-D
atmosphere and once without any. maria_tpu's key stream is reproduced
with jax.random and its draws handed to the port, so the fields compare
sample by sample; each comparison states its tolerance (float32 both
sides unless it says otherwise).
"""

import contextlib
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

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_slice import jax_draws, to_torch  # noqa: E402

from maria_torch.convert import map_from_arrays  # noqa: E402
from maria_torch.map import EXAMPLE_MAPS, ProjectionMap  # noqa: E402

T0 = 1.75e9
SEED = 0
CENTER = (150.0, 10.0)
FAMILIES = list(EXAMPLE_MAPS)
PLANNER_KW = dict(start_time=T0, horizon_days=2, total_duration=20.0, chunk_duration=20.0, scan_pattern="daisy",
                  scan_options={"radius": 0.083, "speed": 0.017}, sample_rate=50)


def ref_get(name, **kw):
    return maria_tpu.map.get(name, fetch_first=False, **kw)


def carried(ref_map) -> ProjectionMap:
    """A maria_tpu map as the port's, through its arrays."""
    return map_from_arrays(np.asarray(ref_map.data), ref_map.center, float(ref_map.width.rad),
                           float(ref_map.height.rad), frame=ref_map.frame, stokes=ref_map.stokes, nu=ref_map.nu,
                           t=ref_map.t, units=ref_map.units, weight=np.asarray(ref_map.weight))


@contextlib.contextmanager
def reference_pointing(scene):
    """Hand the port's map stage maria_tpu's detector offsets from the
    map's centre (float32, as the reference's det_radec made them), so
    that the stages after the pointing compare on the same inputs: the
    two float32 ra tracks differ by one ulp at 2.6 rad, 2.4e-7 rad or
    1.4% of a 3.5 arcsec pixel, for a few samples in a hundred."""
    from maria_tpu.sim.map import map_offsets as ref_offsets
    from maria_tpu.tod.tod import Pointing as RefPointing

    import maria_torch.sim.map as port_stage

    ref_obs = scene["ref_vac"].obs_list[0]
    offsets = torch.as_tensor(np.array(
        ref_offsets(scene["ref_map"], RefPointing(ref_obs.boresight, ref_obs.offsets, ref_obs.q))))

    def given(input_map, pointing, device=None, idx=None):
        assert input_map.center == scene["map"].center and pointing.shape == tuple(offsets.shape[:2])
        return offsets if idx is None else offsets[torch.as_tensor(idx)]

    own, port_stage.map_offsets = port_stage.map_offsets, given
    try:
        yield
    finally:
        port_stage.map_offsets = own


def ulp_tolerance(smoothed_map) -> float:
    """What one float32 ulp of ra at 2.6 rad (2.4e-7 rad) moves a bilinear
    sample of ``smoothed_map`` by at most: the largest step between
    neighbouring pixels times the ulp's share of a pixel, doubled for the
    two sides' roundings."""
    d = smoothed_map.data[0, 0].numpy()
    step = max(np.abs(np.diff(d, axis=-1)).max(), np.abs(np.diff(d, axis=-2)).max())
    return 2 * step * float(np.spacing(np.float32(2.6))) / smoothed_map.x_res


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    old_tpu, old_torch = tpu_caching.get_cache_dir(), maria_torch.io._cache_state["base"]
    maria_tpu.set_cache_dir(str(tmp_path_factory.mktemp("maria_tpu_cache")))
    maria_torch.set_cache_dir(str(tmp_path_factory.mktemp("maria_torch_cache")))
    try:
        ref_map, our_map = ref_get("big_cluster", center=CENTER), maria_torch.map.get("big_cluster", center=CENTER)
        ref_plan = maria_tpu.plan.Planner(target=ref_map, site="GBT").generate_plans(**PLANNER_KW)[0]
        plan = maria_torch.Planner(target=our_map, site="GBT").generate_plans(**PLANNER_KW)[0]
        kw = dict(instrument="MUSTANG-2", site="GBT", seed=SEED)
        out = {"ref_map": ref_map, "map": our_map, "ref_plan": ref_plan, "plan": plan}
        for key, atmosphere in (("atm", "2d"), ("vac", None)):
            out[f"ref_{key}"] = maria_tpu.Simulation(plans=ref_plan, atmosphere=atmosphere, map=ref_map, **kw)
            out[key] = maria_torch.Simulation(plans=plan, atmosphere=atmosphere, map=our_map, device="cpu", **kw)
        yield out
    finally:
        maria_tpu.set_cache_dir(old_tpu)
        maria_torch.set_cache_dir(old_torch)


# -- the named maps ---------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_synthesized_family_is_bit_equal(family):
    ref, ours = ref_get(family, center=CENTER), maria_torch.map.get(family, center=CENTER)
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(ours.weight.numpy(), np.asarray(ref.weight))
    assert ours.shape == tuple(ref.shape) and ours.stokes == ref.stokes and ours.units == ref.units
    np.testing.assert_array_equal(ours.nu, ref.nu)
    np.testing.assert_array_equal(ours.t, ref.t)
    np.testing.assert_array_equal(ours.x_side, ref.x_side)
    np.testing.assert_array_equal(ours.y_side, ref.y_side)
    assert ours.center == ref.center and ours.frame == ref.frame == "ra/dec"
    assert (ours.width, ours.height, ours.resolution) == (ref.width.rad, ref.height.rad, ref.resolution.rad)
    assert (ours.x_res, ours.y_res, ours.n_x, ours.n_y) == (ref.x_res, ref.y_res, ref.n_x, ref.n_y)


def test_get_names_overrides_and_unported():
    from maria_tpu.map import MAP_ALIASES, REFERENCE_MAP_CENTERS

    assert maria_torch.map.MAP_ALIASES == MAP_ALIASES and maria_torch.map.REFERENCE_MAP_CENTERS == REFERENCE_MAP_CENTERS
    assert maria_torch.map.EXAMPLE_MAPS == maria_tpu.map.EXAMPLE_MAPS
    for name in ("M1", "maps/cluster2.fits", "time_evolving_sun"):
        ref, ours = ref_get(name), maria_torch.map.get(name)
        np.testing.assert_array_equal(ours.data.numpy(), np.asarray(ref.data))
        assert ours.center == ref.center
    wide_ref, wide = ref_get("dust", width=2.0, n=64, center=(10.0, -20.0)), \
        maria_torch.map.get("dust", width=2.0, n=64, center=(10.0, -20.0))
    np.testing.assert_array_equal(wide.data.numpy(), np.asarray(wide_ref.data))
    assert wide.width == wide_ref.width.rad and wide.shape == (1, 1, 1, 64, 64)
    for name in ("polarized_source", "12CO(2-1)"):  # Stokes IQUV and a velocity axis, ported
        ref, ours = ref_get(name), maria_torch.map.get(name)
        np.testing.assert_array_equal(ours.data.numpy(), np.asarray(ref.data))
        assert ours.stokes == ref.stokes and ours.center == ref.center
    with pytest.raises(ValueError, match="not a known map"):
        maria_torch.map.get("andromeda")


def test_map_constructor_channels_and_units():
    rng = np.random.default_rng(1)
    data = rng.standard_normal((3, 2, 12, 16)).astype(np.float32)
    kw = dict(center=(20.0, -5.0), resolution=0.01, nu=[90e9, 150e9, 220e9], t=[T0, T0 + 60.0])
    ref, ours = maria_tpu.map.ProjectionMap(data=data, **kw), ProjectionMap(data=data, **kw)
    assert ours.shape == tuple(ref.shape) == (1, 3, 2, 12, 16) and ours.axis3_label == ref.axis3_label == "t"
    np.testing.assert_array_equal(ours.x_side, ref.x_side)
    np.testing.assert_array_equal(ours.y_side, ref.y_side)
    assert ours.nu_bin_bounds == [(float(lo.Hz), float(hi.Hz)) for lo, hi in ref.nu_bin_bounds]
    assert ours.to("K_RJ", band=None) is ours
    milli = ours.to("mK_RJ")
    # 1e-6 relative: one float32 multiply
    np.testing.assert_allclose(milli.data.numpy(), 1e3 * np.asarray(ref.data), rtol=1e-6)
    np.testing.assert_allclose(milli.weight.numpy(), 1e-6 * np.asarray(ref.weight), rtol=1e-6)
    np.testing.assert_allclose(milli.to("K_RJ").data.numpy(), np.asarray(ref.data), rtol=1e-6)
    for units in ("K_CMB", "Jy/pixel"):  # per channel through the calibration graph
        converted, ref_converted = ours.to(units), ref.to(units)
        np.testing.assert_allclose(converted.data.numpy(), np.asarray(ref_converted.data), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(ref_converted.data)).max())
    replaced = ours._replace(nu=[1e11, 2e11, 3e11])
    assert replaced.center == ours.center and replaced.width == pytest.approx(ours.width, rel=1e-15)
    cube = ProjectionMap(data=data[:1], center=(0, 0), resolution=0.01, v=[-1e3, 1e3])
    assert cube.axis3_label == "v" and cube.shape == (1, 1, 2, 12, 16)
    with pytest.raises(ValueError, match="at most one"):
        ProjectionMap(data=data[0], center=(0, 0), resolution=0.01, t=[0.0, 1.0], z=[0.0, 1.0])


@pytest.mark.parametrize("family,fwhm_arcsec", [("big_cluster", 9.0), ("point_sources", 30.0), ("dust", 4.0)])
def test_smooth(family, fwhm_arcsec):
    """Beam smoothing, an rfft2 multiply in float32 on both sides: 1e-6
    of the smoothed map's maximum."""
    from maria_tpu.units import Quantity

    fwhm = np.radians(fwhm_arcsec / 3600)
    ref = np.asarray(ref_get(family).smooth(fwhm=Quantity(fwhm, "rad")).data)
    ours = maria_torch.map.get(family).smooth(fwhm, device="cpu").data.numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("family,bilinear,tol", [
    ("big_cluster", True, 1e-6), ("point_sources", True, 3e-5), ("point_sources", False, 1e-6),
], ids=["bilinear-big_cluster", "bilinear-point_sources", "nearest"])
def test_sample_in_and_off_the_map(family, bilinear, tol):
    """Seeded offsets up to 0.7 widths from the centre, so a share falls
    off the map and gives 0. Bilinear values are continuous: 1e-6 of the
    map's maximum on the slice's smooth ``big_cluster``. On one-pixel
    sources the float32 fractional index of an offset 512 pixels wide
    carries 3e-5 of a pixel and the map changes by 0.6 of its maximum a
    pixel: each side stands 1e-5 of the maximum from the float64 value,
    so 3e-5 there. The nearest-pixel branch may pick the other pixel for
    an offset within float32 rounding of a pixel border: at most 1 in
    1,000 samples may differ."""
    ref_map, our_map = ref_get(family), maria_torch.map.get(family)
    rng = np.random.default_rng(2)
    dx, dy = (rng.uniform(-0.7, 0.7, (2, 6, 4000)) * our_map.width).astype(np.float32)
    sw = rng.uniform(0.5, 1.0, (6, 1)).astype(np.float32)
    ref = np.asarray(ref_map.sample(jnp.asarray(dx), jnp.asarray(dy), stokes_weight=jnp.asarray(sw),
                                    bilinear=bilinear))
    ours = our_map.sample(torch.as_tensor(dx), torch.as_tensor(dy), stokes_weight=torch.as_tensor(sw),
                          bilinear=bilinear).numpy()
    off = (np.abs(dx) > our_map.width.rad / 2 + our_map.x_res) | (np.abs(dy) > our_map.height.rad / 2 + our_map.y_res)
    assert 0.2 < off.mean() < 0.8 and (ours[off] == 0).all() and (ours[~off] != 0).any()
    close = np.abs(ours - ref) <= tol * np.abs(ref).max()
    assert close.all() if bilinear else close.mean() >= 0.999
    unweighted = our_map.sample(torch.as_tensor(dx), torch.as_tensor(dy), bilinear=bilinear).numpy()
    np.testing.assert_allclose(unweighted * sw, ours, rtol=1e-6, atol=0)


def test_pixel_index():
    ref_map, our_map = ref_get("quasar"), maria_torch.map.get("quasar")
    rng = np.random.default_rng(3)
    # offsets at pixel centres plus up to 0.45 of a pixel, so float32 rounding cannot cross a border
    ix, iy = rng.integers(-5, our_map.n_x + 5, (2, 3000))
    dx = (our_map.x_side[0] + (ix + rng.uniform(-0.45, 0.45, 3000)) * our_map.x_res).astype(np.float32)
    dy = (our_map.y_side[0] + (iy + rng.uniform(-0.45, 0.45, 3000)) * our_map.y_res).astype(np.float32)
    flat_ref, inside_ref = ref_map.pixel_index(jnp.asarray(dx), jnp.asarray(dy))
    flat, inside = our_map.pixel_index(torch.as_tensor(dx), torch.as_tensor(dy))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(flat_ref))
    np.testing.assert_array_equal(inside.numpy(), np.asarray(inside_ref))
    expected = (ix >= 0) & (ix < our_map.n_x) & (iy >= 0) & (iy < our_map.n_y)
    np.testing.assert_array_equal(inside.numpy(), expected)
    np.testing.assert_array_equal(flat.numpy()[expected], (iy * our_map.n_x + ix)[expected])


def test_interp_bilinear_grid_is_exact_at_pixel_centres():
    from maria_torch.ops.interp import interp_bilinear_grid

    m = maria_torch.map.get("galaxy")
    X, Y = np.meshgrid(m.x_side, m.y_side)
    vals = interp_bilinear_grid(m.data[0, 0, 0].double(), torch.as_tensor(X), torch.as_tensor(Y), m.x_side, m.y_side)
    np.testing.assert_allclose(vals.numpy(), m.data[0, 0, 0].numpy(), rtol=0, atol=1e-12)


def test_convert_map_from_arrays(scene):
    ours = carried(scene["ref_map"])
    np.testing.assert_array_equal(ours.data.numpy(), scene["map"].data.numpy())
    np.testing.assert_allclose(ours.x_side, scene["map"].x_side, rtol=0, atol=1e-18)
    assert ours.center == scene["map"].center and ours.frame == "ra/dec"


# -- the band's transmission integral and the stage's tables ----------------------------


@pytest.mark.parametrize("nu_range", [(0.0, np.inf), (0.0, 9.0e10), (8.8e10, 9.6e10)])
def test_compute_transmission_integral(scene, nu_range):
    """In a vacuum a float64 trapezoid on both sides (1e-12 relative); with
    a spectrum the reference interpolates the grid in float32: 1e-5."""
    ref_band = scene["ref_atm"].instrument.dets.bands[0]
    band = scene["atm"].instrument.dets.bands[0]
    lo, hi = nu_range
    vac = band.compute_transmission_integral(nu_min_Hz=lo, nu_max_Hz=hi)
    assert vac == pytest.approx(ref_band.compute_transmission_integral(nu_min_Hz=lo, nu_max_Hz=hi), rel=1e-12)
    assert vac > 0
    ref_atm, atm = scene["ref_atm"].obs_list[0].atmosphere, scene["atm"].obs_list[0].atmosphere
    rng = np.random.default_rng(4)
    kw = dict(base_temperature=rng.uniform(265, 295, 50), zenith_pwv=rng.uniform(2, 20, 50),
              elevation=rng.uniform(0.4, 1.5, 50))
    ours = band.compute_transmission_integral(spectrum=atm.spectrum, nu_min_Hz=lo, nu_max_Hz=hi, **kw)
    ref = ref_band.compute_transmission_integral(spectrum=ref_atm.spectrum, nu_min_Hz=lo, nu_max_Hz=hi, **kw)
    np.testing.assert_allclose(ours, ref, rtol=1e-5)
    assert (ours > 0).all() and (lo > 0 or hi < np.inf or (ours < vac).all())


def test_map_transmission_table(scene):
    from maria_tpu.sim.map import map_transmission_table as ref_table

    from maria_torch.sim.map import map_transmission_table

    ref_obs, obs = scene["ref_atm"].obs_list[0], scene["atm"].obs_list[0]
    T = float(obs.atmosphere.weather.temperature[0])
    assert T == float(ref_obs.atmosphere.weather.temperature[0])
    ref = ref_table(ref_obs.instrument.dets.bands[0], scene["ref_map"], 0, ref_obs.atmosphere.spectrum, T)
    ours = map_transmission_table(obs.instrument.dets.bands[0], scene["map"], 0, obs.atmosphere.spectrum, T)
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    # the reference interpolates the grid in float32: 1e-5 relative, and 1e-6 of the largest entry for
    # the entries at high pwv and low elevation that are a millionth of it
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6 * ref.max())


@pytest.mark.parametrize("pointing", ["given", "own"])
@pytest.mark.parametrize("which", ["big_cluster", "time_evolving"])
def test_static_map_samples(scene, which, pointing):
    """The K_RJ sky timelines along the pointing, one frame or blended
    between three. Given maria_tpu's float32 offsets, 1e-5 of the largest
    sample (two float32 bilinear gathers of the same offsets). With the
    port's own det_radec, what one float32 ulp of ra can move a sample by
    (``ulp_tolerance``, 2-4e-4 of the largest sample here), and 90% of
    the samples within 1e-5 all the same."""
    from maria_tpu.sim.map import static_map_samples as ref_samples

    from maria_torch.sim.map import band_fwhm, static_map_samples

    ref_obs, obs = scene["ref_vac"].obs_list[0], scene["vac"].obs_list[0]
    if which == "big_cluster":
        ref_map, our_map = scene["ref_map"], scene["map"]
    else:
        kw = dict(center=CENTER, t=obs.t[0] + np.array([0.0, 8.0, 16.0]), width=0.5)
        ref_map, our_map = ref_get("time_evolving_source", **kw), maria_torch.map.get("time_evolving_source", **kw)
    band_idx = np.arange(0, 217, 3)
    band = obs.instrument.dets.bands[0]
    ref = ref_samples(ref_map, ref_obs.instrument.dets.bands[0], band_idx, ref_obs)
    with reference_pointing(scene) if pointing == "given" else contextlib.nullcontext():
        ours = static_map_samples(our_map, band, band_idx, obs, device="cpu")
    assert [c for c, _ in ours] == [c for c, _ in ref] == [0]
    a, b = ours[0][1].numpy(), ref[0][1]
    assert a.shape == b.shape == (len(band_idx), 1000) and a.dtype == np.float32
    assert np.abs(b).max() > 1e-5  # the scan crosses the source
    tight = 1e-5 * np.abs(b).max()
    if pointing == "given":
        np.testing.assert_allclose(a, b, rtol=0, atol=tight)
    else:
        loose = ulp_tolerance(our_map.smooth(band_fwhm(obs, band), device="cpu"))
        assert tight < loose < 1e-3 * np.abs(b).max()
        np.testing.assert_allclose(a, b, rtol=0, atol=loose)
        assert (np.abs(a - b) <= tight).mean() >= 0.9


def test_map_offsets_in_an_azel_map(scene):
    from maria_tpu.sim.map import map_offsets as ref_offsets
    from maria_tpu.tod.tod import Pointing as RefPointing

    from maria_torch.sim.map import map_offsets
    from maria_torch.tod import Pointing

    ref_obs, obs = scene["ref_vac"].obs_list[0], scene["vac"].obs_list[0]
    center = tuple(np.degrees(obs.boresight.center(frame="az/el")))
    data = np.zeros((8, 8), dtype=np.float32)
    ref_map = maria_tpu.map.ProjectionMap(data=data, center=center, width=1.0, frame="az/el")
    our_map = ProjectionMap(data=data, center=center, width=1.0, frame="az/el")
    ref = np.asarray(ref_offsets(ref_map, RefPointing(ref_obs.boresight, ref_obs.offsets, ref_obs.q)))
    ours = map_offsets(our_map, Pointing(obs.boresight, obs.offsets, obs.q), device="cpu").numpy()
    # offsets of ~1e-3 rad from float32 angles of ~2.6 rad: 2e-6 rad
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-6)


def test_check_map_observable_and_initialize_map():
    from maria_torch.sim.map import initialize_map

    data = np.zeros((2, 8, 8), dtype=np.float32)
    cube = ProjectionMap(data=data, center=CENTER, width=0.1, v=[-1e3, 1e3])
    with pytest.raises(NotImplementedError, match="multi-slice 'v' cube"):
        initialize_map(cube)
    assert initialize_map(ProjectionMap(data=data[:1], center=CENTER, width=0.1, z=[0.3])).axis3_label == "z"
    assert initialize_map("quasar", bilinear_sampling=False, n=32).shape == (1, 1, 1, 32, 32)
    with pytest.raises(ValueError, match="ProjectionMap or a string"):
        initialize_map(data)


# -- the fused program with an input map ----------------------------------------------------


@pytest.fixture(scope="module")
def atm_runs(scene):
    """Both packages' K_RJ TODs of the scene with the atmosphere,
    maria_tpu's draws handed to the port, and its pointing to the port's
    map stage (``reference_pointing``): the program is built here."""
    from maria_tpu.ops.program import build_tod_program

    ref_sim = scene["ref_atm"]
    ref_program = build_tod_program(ref_sim.obs_list[0], noise_kwargs=ref_sim.noise_kwargs)
    draws = to_torch(jax_draws(ref_program, SEED))
    ref_tod = ref_sim.run()[0]
    scene["atm"]._programs.clear()
    with reference_pointing(scene):
        tod = scene["atm"].run(draws=[draws])[0]
    return ref_tod, tod, draws


def test_program_map_stages_are_static(scene, atm_runs):
    program = scene["atm"].program()
    ((table, samples),) = program.bands[0].map_stages
    assert samples.shape == (217, 1000) and samples.dtype == torch.float32
    assert table.shape == program.bands[0].power_table.shape


def test_slice_with_atmosphere_fields_match(atm_runs):
    """atmosphere, map and noise in K_RJ, sample by sample. The map field
    (the pwv the same on both sides through the draws, the pointing
    through ``reference_pointing``) is held to 1e-5 of its maximum; atmosphere and noise as the az/el slice holds
    them (tests/test_torch_slice.py)."""
    ref_tod, tod, _ = atm_runs
    assert tod.units == ref_tod.units == "K_RJ"
    assert tod.fields == ref_tod.fields == ["atmosphere", "map", "noise"]
    for k in ("atmosphere", "noise"):
        ref, ours = np.asarray(ref_tod.data[k]), tod.data[k].numpy()
        assert ours.shape == ref.shape == (217, 1000)
        np.testing.assert_allclose(ours, ref, rtol=2e-6, atol=1e-4 * (ref - ref.mean()).std())
    ref, ours = np.asarray(ref_tod.data["map"]), tod.data["map"].numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert np.abs(ref).max() > 1e-4  # big_cluster's 5e-4 K_RJ decrement, smoothed and attenuated
    assert tod.metadata["input_map"] is not None and tod.metadata["atmosphere"] is True


def test_total_power_carries_the_map_with_gains(scene, atm_runs):
    """Both forms of total_power_fn add the map with the gains applied:
    the total minus the total of a map-free program on the same draws is
    gains x the "map" field, to 1e-5 of its maximum. The totals are
    float32 numbers of ~4 pW that round at 2e-7 pW, and big_cluster's
    field reaches 7e-6 pW, so the map is made 1e6 times brighter here:
    its field is then as large as the total, and 1e-5 of it is 30
    roundings."""
    from maria_torch.ops.program import build_tod_program

    sim = scene["atm"]
    _, _, draws = atm_runs
    bright = scene["map"]._replace(data=scene["map"].data * 1e6)
    program = build_tod_program(sim.obs_list[0], noise_kwargs=sim.noise_kwargs, input_map=bright, device="cpu")
    bare = build_tod_program(sim.obs_list[0], noise_kwargs=sim.noise_kwargs, device="cpu")
    assert program.use_noise_matmul() and bare.bands[0].map_stages is None
    signal = program.fields(draws=draws, device="cpu", upto="signal")
    assert sorted(signal) == ["atmosphere", "map"]
    assert sorted(program.fields(draws=draws, device="cpu", upto="atmosphere")) == ["atmosphere"]
    gains = program.draw_gains(draw=draws["gains"], device="cpu")
    gen_draws = dict(draws)
    m = program._noise_matmul_specs()[2] // 2
    g = torch.Generator().manual_seed(7)
    gen_draws["v"] = torch.randn((217, 2, m + 1), generator=g)
    gen_draws["modes"] = [torch.randn((5, 2, m + 1), generator=g)]
    expected = (gains * signal["map"]).double()
    scale = float(expected.abs().max())
    assert 1.0 < scale < 100.0  # pW, beside totals of ~4 pW
    for form in ("matmul", "fields"):
        if form == "fields":
            program.with_noise = bare.with_noise = False  # the fields route: the signal alone
        assert program.use_noise_matmul() == (form == "matmul")
        with_map = program.total_power_fn()(draws=gen_draws, device="cpu").double()
        without = bare.total_power_fn()(draws=gen_draws, device="cpu").double()
        assert float((with_map - without - expected).abs().max()) <= 1e-5 * scale, form


# -- scenes without an atmosphere ------------------------------------------------------------


def vacuum_draws(ref_sim, seed=SEED):
    """maria_tpu's normals for one run() of a simulation without an
    atmosphere (sim/simulation.py:198-210, sim/noise.py:22, noise/__init__.py:77):
    the first split of the simulation key feeds the noise, one further
    split a band; the second the gains."""
    from maria_tpu.atmosphere.fourier import good_fft_size
    from maria_tpu.utils import compute_diameter

    dets = ref_sim.instrument.dets
    n_f = good_fft_size(ref_sim.obs_list[0].shape[-1]) // 2 + 1
    key, noise_key = jax.random.split(jax.random.key(seed))
    draws = {"noise": [], "modes": []}
    for band in dets.bands:
        noise_key, band_key = jax.random.split(noise_key)
        _, key_pink, key_modes = jax.random.split(band_key, 3)
        n_band = int((dets.band_name == band.name).sum())
        assert n_band > 16 and compute_diameter(dets.offsets[dets.band_name == band.name]) > 0
        draws["noise"].append(np.asarray(jax.random.normal(key_pink, (n_band, n_f, 2), dtype=jnp.float32)))
        draws["modes"].append(np.asarray(jax.random.normal(key_modes, (5, n_f, 2), dtype=jnp.float32)))
    _, gain_key = jax.random.split(key)
    draws["gains"] = np.asarray(jax.random.normal(gain_key, (dets.n,)))
    return to_torch(draws)


@pytest.fixture(scope="module")
def vac_runs(scene):
    draws = vacuum_draws(scene["ref_vac"])
    with reference_pointing(scene):
        tod = scene["vac"].run(draws=[draws])[0]
    return scene["ref_vac"].run()[0], tod, draws


@pytest.mark.parametrize("units", ["K_RJ", "pW"])
def test_noise_only_scene_fields_match(scene, vac_runs, units):
    """The "map" field (vacuum calibration, gains applied; the pointing
    through ``reference_pointing``) to 1e-5 of its maximum and the noise to 1e-4 of its std, in pW and through
    TOD.to("K_RJ") without an atmosphere (one factor a band)."""
    ref_tod, tod, _ = vac_runs
    ref_tod, tod = ref_tod.to(units), tod.to(units)
    assert tod.units == ref_tod.units == units and tod.fields == ref_tod.fields == ["map", "noise"]
    assert tod.metadata["atmosphere"] is False and "pwv" not in tod.metadata
    ref, ours = np.asarray(ref_tod.data["map"]), tod.data["map"].numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    ref, ours = np.asarray(ref_tod.data["noise"]), tod.data["noise"].numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4 * ref.std())
    assert tod.spectrum is None


def test_noise_only_scene_map_with_its_own_pointing(scene, vac_runs):
    """The "map" field in pW through the port's own det_radec, gains
    aside: within what one float32 ulp of ra moves a sample by
    (``ulp_tolerance``), and 90% of the samples within 1e-5 of the
    field's maximum."""
    from maria_torch.sim.map import band_fwhm, sample_maps

    ref_tod, _, draws = vac_runs
    obs = scene["vac"].obs_list[0]
    band = obs.instrument.dets.bands[0]
    gains = torch.exp(torch.as_tensor(obs.instrument.dets.gain_error, dtype=torch.float32) * draws["gains"])[:, None]
    ours = (gains * sample_maps(scene["map"], obs, device="cpu")).numpy()
    ref = np.asarray(ref_tod.to("pW").data["map"])
    smoothed = scene["map"].smooth(band_fwhm(obs, band), device="cpu")
    loose = ulp_tolerance(smoothed) / float(smoothed.data.abs().max()) * np.abs(ref).max()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=loose)
    assert (np.abs(ours - ref) <= 1e-5 * np.abs(ref).max()).mean() >= 0.9


def test_noise_only_scene_without_noise_or_map(scene):
    kw = dict(instrument="MUSTANG-2", plans=scene["plan"], site="GBT", atmosphere=None, seed=1, device="cpu")
    tod = maria_torch.Simulation(map=scene["map"], noise=False, **kw).run()[0]
    assert tod.fields == ["map"] and tod.shape == (217, 1000) and bool(torch.isfinite(tod.data["map"]).all())
    noise = maria_torch.Simulation(**kw).run(units="pW")[0]
    assert noise.fields == ["noise"]
    band = noise.dets.bands[0]
    # above twice the knee the mean periodogram of 217 rows follows the process: white NEP^2 x sample rate
    # plus the pink part, shared between the detectors' own and the five correlated modes; 15% with
    # ~100 bins x 217 rows
    from maria_torch.atmosphere.fourier import good_fft_size
    from maria_torch.noise import DEFAULT_NOISE_SIM_KWARGS, _pink_weights_np
    from maria_torch.ops.program import band_noise_basis

    basis, cp = band_noise_basis(noise.dets.offsets, DEFAULT_NOISE_SIM_KWARGS)
    x = noise.data["noise"].double().numpy() / (1e12 * band.NEP)
    f = np.fft.rfftfreq(1000, d=1 / 50.0)
    psd = (np.abs(np.fft.rfft(x - x.mean(-1, keepdims=True), axis=-1)) ** 2).mean(0) / 1000
    n_fft = good_fft_size(1000)
    w2 = np.interp(f, np.fft.rfftfreq(n_fft, d=1 / 50.0), _pink_weights_np(n_fft, 50.0, band.knee, 1.0) ** 2)
    expected = 50.0 + (1 - cp) * w2 + cp * float(np.mean(np.sum(basis**2, axis=-1))) * w2
    for lo, hi in ((2 * band.knee, 16.0), (16.0, 24.5)):
        sel = (f >= lo) & (f < hi)
        assert abs(psd[sel].mean() / expected[sel].mean() - 1) < 0.15, (lo, hi)
    with pytest.raises(ValueError, match="nothing to simulate"):
        maria_torch.Simulation(noise=False, **kw).run()
    with pytest.raises(ValueError, match="no TODProgram"):
        maria_torch.Simulation(**kw).program()
    # the CMB (ROADMAP item 8b) runs without an atmosphere too, as its own field
    cmb_only = maria_torch.Simulation(cmb="generate", cmb_kwargs={"nside": 8}, noise=False, **kw)
    assert cmb_only.cmb.nside == 8 and cmb_only.run(units="pW")[0].fields == ["cmb"]


# -- BinMapper in ra/dec -------------------------------------------------------------------------


MAPPER_KW = dict(center=CENTER, width=0.5, resolution=0.5 / 64, frame="ra/dec", map_postprocessing={"keep_mean": True})


def test_bin_mapper_radec_matches(vac_runs):
    """BinMapper in ra/dec on the two TODs of the noise-only scene. Ids
    come from float32 ra/dec, so a sample within rounding of a pixel
    border may land in the neighbour: at most 0.5% of the hits move; the
    binned totals agree to 1e-5 and 80% of the hit pixels to 1e-5 of the
    map's largest value (the rest gained or lost a border sample)."""
    from maria_tpu.mappers import BinMapper as RefBinMapper

    ref_tod, tod, _ = vac_runs
    ref_map = RefBinMapper(ref_tod, **MAPPER_KW).run()
    ours = maria_torch.BinMapper(tod, **MAPPER_KW).run()
    ref_w, w = np.asarray(ref_map.weight), ours.weight.numpy()
    assert w.shape == ref_w.shape == (1, 1, 1, 64, 64) and ours.frame == "ra/dec"
    assert w.sum() == ref_w.sum() == 217 * 1000
    assert np.abs(w - ref_w).sum() <= 5e-3 * ref_w.sum()
    ref_d, d = np.nan_to_num(np.asarray(ref_map.data)), ours.data.numpy()
    np.testing.assert_allclose((d * w).sum(), (ref_d * ref_w).sum(), rtol=1e-5)
    hit = (w > 0) & (ref_w > 0)
    close = np.abs(d - ref_d)[hit] <= 1e-5 * np.abs(ref_d).max()
    assert close.mean() >= 0.8, close.mean()
    np.testing.assert_allclose(ours.center, ref_map.center, rtol=0, atol=1e-15)
    assert ours.resolution == pytest.approx(float(ref_map.resolution.rad), rel=1e-12)


def test_bin_mapper_in_power_units(vac_runs):
    """BinMapper(units="pW") bins the TOD in pW into a map that carries
    the unit. Without an atmosphere pW -> K_RJ is one factor a band, so
    the map is maria_tpu's K_RJ map times the band's vacuum pW per K_RJ
    (taken from maria_tpu's two TODs): the hits as there, the binned
    total to 1e-5, 80% of the hit pixels to 1e-5 of the map's largest
    value. The map converts to K_RJ only with a band (the graph's edge
    needs one); a map in Jy/pixel is binned in K_RJ and converted."""
    from maria_tpu.mappers import BinMapper as RefBinMapper

    ref_tod, tod, _ = vac_runs
    ref_map = RefBinMapper(ref_tod, **MAPPER_KW).run()
    pW_per_K_RJ = float(np.asarray(ref_tod.to("pW").data["map"]).max() / np.asarray(ref_tod.data["map"]).max())
    mapper = maria_torch.BinMapper(tod, units="pW", **MAPPER_KW)
    assert mapper.tods[0].units == "pW"
    ours = mapper.run()
    assert ours.units == "pW" and ours.to("pW") is ours
    ref_w, w = np.asarray(ref_map.weight), ours.weight.numpy()
    assert w.sum() == ref_w.sum() and np.abs(w - ref_w).sum() <= 5e-3 * ref_w.sum()
    ref_d, d = pW_per_K_RJ * np.nan_to_num(np.asarray(ref_map.data)), ours.data.numpy()
    np.testing.assert_allclose((d * w).sum(), (ref_d * ref_w).sum(), rtol=1e-5)
    hit = (w > 0) & (ref_w > 0)
    assert (np.abs(d - ref_d)[hit] <= 1e-5 * np.abs(ref_d).max()).mean() >= 0.8
    with pytest.raises(maria_torch.errors.MissingCalibrationKwargsError, match="band"):
        ours.to("K_RJ")
    jy = maria_torch.BinMapper(tod, units="Jy/pixel", **MAPPER_KW).run()
    rj = maria_torch.BinMapper(tod, **MAPPER_KW).run()
    assert jy.units == "Jy/pixel"
    np.testing.assert_allclose(jy.data.numpy(), rj.to("Jy/pixel").data.numpy(), rtol=1e-6)


def test_bin_mapper_radec_equals_direct_binning(vac_runs):
    """The mapper's map equals np.add.at of its TOD at radec_pixel_ids."""
    from maria_torch.mappers.bin_mapper import radec_pixel_ids

    _, tod, _ = vac_runs
    mapper = maria_torch.BinMapper(tod, **MAPPER_KW)
    out = mapper.run()
    ids = radec_pixel_ids(tod.pointing, mapper.center, mapper.res, 64, 64, device="cpu").numpy().ravel()
    good = ids >= 0
    sums, hits = np.zeros(64 * 64), np.zeros(64 * 64)
    np.add.at(sums, ids[good], tod.signal.double().numpy().ravel()[good])
    np.add.at(hits, ids[good], 1.0)
    np.testing.assert_array_equal(out.weight.numpy().ravel(), hits)
    seen = hits > 0
    np.testing.assert_allclose(out.data.numpy().ravel()[seen], sums[seen] / hits[seen], rtol=2e-6, atol=1e-9)


def test_bin_mapper_infers_geometry_and_takes_a_target(scene, vac_runs):
    from maria_tpu.mappers import BinMapper as RefBinMapper

    ref_tod, tod, _ = vac_runs
    ref, ours = RefBinMapper(ref_tod, resolution=0.01), maria_torch.BinMapper(tod, resolution=0.01)
    assert ours.frame == "ra/dec" and (ours.n_x, ours.n_y) == (ref.n_x, ref.n_y)
    np.testing.assert_allclose(ours.center, ref.center, rtol=0, atol=1e-12)
    assert abs(np.degrees(ours.center[0]) - 150.0) < 0.05 and abs(np.degrees(ours.center[1]) - 10.0) < 0.05
    on_target = maria_torch.BinMapper(tod, target=scene["map"])
    ref_on_target = RefBinMapper(ref_tod, target=scene["ref_map"])
    assert (on_target.n_x, on_target.n_y) == (ref_on_target.n_x, ref_on_target.n_y) == (512, 512)
    assert on_target.center == scene["map"].center and on_target.input_map is scene["map"]
    with pytest.raises(ValueError, match="'az/el' or 'ra/dec'"):
        maria_torch.BinMapper(tod, frame="galactic")


def test_point_source_comes_back_in_its_pixel(scene):
    """The port alone: a 20 arcsec source a quarter of the map off centre
    is scanned without atmosphere or noise and binned in ra/dec on the
    input map's grid; the binned map peaks in the source's pixel, so no
    axis is flipped between ``sample`` and the mapper's ids."""
    n, width = 48, 0.3
    x = (np.arange(n) - (n - 1) / 2) * np.radians(width) / n
    X, Y = np.meshgrid(x, x)
    iy0, ix0 = 30, 13
    sigma = np.radians(20 / 3600) / 2.355
    data = 1e-3 * np.exp(-((X - x[ix0]) ** 2 + (Y - x[iy0]) ** 2) / (2 * sigma**2))
    source = ProjectionMap(data=data, center=CENTER, width=width, nu=[93e9])
    sim = maria_torch.Simulation("MUSTANG-2", plans=scene["plan"], site="GBT", atmosphere=None, map=source,
                                 noise=False, seed=2, device="cpu")
    out = maria_torch.BinMapper(sim.run(), target=source, map_postprocessing={"keep_mean": True}).run()
    assert (out.n_y, out.n_x) == (n, n)
    hit = out.weight[0, 0, 0] > 0
    assert bool(hit[iy0, ix0])
    peak = int(torch.where(hit, out.data[0, 0, 0], torch.zeros(())).argmax())
    assert divmod(peak, n) == (iy0, ix0)


def test_scenes_of_the_sky_path(scene):
    """``maria_torch.scenes`` at a small size on the CPU: the noise-free
    sky scene recovers its input map (correlation above 0.95, as on the
    card at full length), its map stage agrees with itself, and the az/el
    scene's ``input_map`` covers the scan's whole field."""
    from maria_torch.scenes import map_stage_errors, simulation, sky_mapper, sky_recovery, sky_simulation

    sim = sky_simulation(20.0, "cpu", atmosphere=None, noise=False)
    assert sky_recovery(sim, sky_mapper(sim.run(), sim.map).run()) > 0.95
    e = map_stage_errors(sim, "cpu")
    assert e["offsets_rad"] == 0 and e["field"] == 0 and e["gather"] <= 1e-5 and 1e-5 < e["field_limit"] < 1e-3
    assert e["smooth"] <= 1e-6  # float32 rfft2 against float64, of the map's maximum
    with pytest.raises(ValueError, match="not centred"):
        sky_recovery(sim, maria_torch.BinMapper(sim.run(), center=(150.01, 10.0), width=0.5, resolution=0.01).run())
    dusty = simulation("mustang2", 10.0, "cpu", input_map="dust")
    assert dusty.map.frame == "ra/dec" and dusty.map.shape == (1, 1, 1, 512, 512)
    ((_, samples),) = dusty.program().bands[0].map_stages
    assert samples.shape == (217, 500) and bool((samples > 0).all())  # dust is positive: every sample on the map


def test_slice_with_atmosphere_maps_in_radec(atm_runs):
    """The slice as a whole: the atmosphere TOD binned in ra/dec has every
    sample on the map and a finite, zero-mean map."""
    _, tod, _ = atm_runs
    out = maria_torch.BinMapper([tod], center=CENTER, width=0.5, resolution=0.5 / 64, frame="ra/dec").run()
    assert out.shape == (1, 1, 1, 64, 64) and float(out.weight.sum()) == 217 * 1000
    assert bool(torch.isfinite(out.data).all())
    seen = out.weight > 0
    assert abs(float(out.data[seen].mean())) <= 1e-4 * float(out.data[seen].abs().max())
