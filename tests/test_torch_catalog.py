"""The port's scene catalogue against maria_tpu, on the CPU: every band,
array, instrument, site, region, scan pattern and registry plan, the
focal-plane patterns, and the map families that need Stokes IQUV or a
velocity axis. Each registry entry is its own case. Weather is computed,
not cached, so the file needs no data cache; the comparisons are exact
unless a test says otherwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import maria_tpu  # noqa: E402
import maria_tpu.array  # noqa: E402
import maria_tpu.band  # noqa: E402
import maria_tpu.instrument  # noqa: E402
import maria_tpu.plan  # noqa: E402
import maria_tpu.site  # noqa: E402

import maria_torch  # noqa: E402
import maria_torch.array  # noqa: E402
import maria_torch.band  # noqa: E402
import maria_torch.instrument  # noqa: E402
import maria_torch.plan  # noqa: E402
import maria_torch.site  # noqa: E402

BAND_FIELDS = ("efficiency", "NEP", "NEP_per_loading", "knee", "gain_error", "time_constant", "center", "width")
STRING_COLUMNS = ("array_name", "band_name", "pol_label")
NUMBER_COLUMNS = ("base_det_index", "xi", "eta", "baseline_x", "baseline_y", "baseline_z", "gamma", "primary_size",
                  "bath_temp", "time_constant")


def assert_same_table(ours, ref):
    """The port's Array against a maria_tpu Array, element for element,
    order included."""
    assert ours.n == ref.n and ours.name == ref.name
    assert ours.bands.names == ref.bands.names
    for col in STRING_COLUMNS:
        np.testing.assert_array_equal(ours.dets[col].astype(str), ref.dets[col].values.astype(str), err_msg=col)
    for col in NUMBER_COLUMNS:
        np.testing.assert_array_equal(ours.dets[col].astype(float), ref.dets[col].values.astype(float), err_msg=col)
    np.testing.assert_array_equal(ours.stokes_weight(), ref.stokes_weight())


# -- bands ---------------------------------------------------------------------------------------


def test_band_registry_keys():
    assert maria_torch.band.all_bands == maria_tpu.band.all_bands
    assert len(maria_torch.band.all_bands) == 52


@pytest.mark.parametrize("name", maria_tpu.band.all_bands)
def test_band_matches(name):
    ref, ours = maria_tpu.band.get_band(name), maria_torch.band.get_band(name)
    assert ours.name == ref.name and ours.shape == ref.shape
    np.testing.assert_array_equal(ours.nu, ref.nu)
    np.testing.assert_array_equal(ours.tau, ref.tau)
    for field in BAND_FIELDS:
        assert getattr(ours, field) == getattr(ref, field), field
    nu = np.linspace(ours.nu.min() * 0.9, ours.nu.max() * 1.1, 101)
    np.testing.assert_array_equal(ours.passband(nu), ref.passband(nu))


@pytest.mark.parametrize("kw", [
    dict(center=150e9, width=30e9, NET_RJ=60e-6),
    dict(center=90e9, width=20e9, shape="flat", NET_RJ=40e-6, efficiency=0.7),
    dict(center=220e9, width=40e9, shape="top_hat", NET_RJ=1e-5),
    dict(nu=np.linspace(140e9, 160e9, 64), tau=np.hanning(64), NET_RJ=3e-5),
    dict(center=150e9, width=30e9),
], ids=["gaussian", "flat", "top_hat", "table", "default"])
def test_band_net_rj(kw):
    """A Band given NET_RJ (or nothing: 50 uK_RJ√s) has maria_tpu's NEP,
    its default name and width; the getter and setter round-trip at 1e-12."""
    ref, ours = maria_tpu.band.Band(**kw), maria_torch.band.Band(**kw)
    assert ours.NEP == pytest.approx(ref.NEP, rel=1e-12)
    assert ours.NET_RJ == pytest.approx(ref.NET_RJ, rel=1e-12)
    assert ours.NET_RJ == pytest.approx(kw.get("NET_RJ", 50e-6), rel=1e-12)
    assert ours.name == ref.name and ours.width == ref.width and ours.center == ref.center
    ours.NET_RJ = ref.NET_RJ = 7e-6
    assert ours.NEP == pytest.approx(ref.NEP, rel=1e-12)


@pytest.mark.parametrize("name", ["act/pa5/f090", "act/pa5/f150"])
def test_band_net_rj_setter_on_registry_bands(name):
    """docs/tutorials.md's CMB patch: NET_RJ = 10e-6 through the setter
    (1.4690e-18 W√s at f090 and 2.2036e-18 at f150)."""
    ref, ours = maria_tpu.band.get_band(name), maria_torch.band.get_band(name)
    ref.NET_RJ = ours.NET_RJ = 10e-6
    assert ours.NEP == pytest.approx(ref.NEP, rel=1e-12)
    assert ours.NEP == pytest.approx({"act/pa5/f090": 1.4690e-18, "act/pa5/f150": 2.2036e-18}[name], rel=1e-4)


def test_band_parse_bandlist_and_net_cmb():
    from maria_torch.band import Band, BandList, parse_band

    band = parse_band({"center": 150e9, "width": 30e9, "NEP": 1e-17})
    assert parse_band(band) is band and parse_band("m2/f093").name == "m2/f093"
    bands = BandList(["m2/f093", band])
    assert bands.names == ["m2/f093", "f150"] and bands["f150"] is band and len(bands) == 2
    with pytest.raises(KeyError):
        bands["f999"]
    ref_band = maria_tpu.band.Band(center=150e9, width=30e9, NEP=1e-17)
    assert band.NET_CMB == pytest.approx(ref_band.NET_CMB, rel=1e-10)
    made = Band(center=150e9, width=30e9, NET_CMB=1e-5)
    assert made.NET_CMB == pytest.approx(1e-5, rel=1e-12)
    assert made.NEP == pytest.approx(maria_tpu.band.Band(center=150e9, width=30e9, NET_CMB=1e-5).NEP, rel=1e-10)
    with pytest.raises(ValueError, match="Invalid passband shape"):
        Band(center=150e9, width=30e9, shape="lorentzian", NEP=1e-17)
    with pytest.raises(ValueError, match="not a valid pre-defined band"):
        maria_torch.band.get_band("act/pa9/f090")


# -- focal-plane patterns ------------------------------------------------------------------------


SIZINGS = {"count": dict(n=37, max_diameter=0.02), "diameter_and_spacing": dict(max_diameter=0.05, spacing=0.004),
           "columns": dict(n_col=5, n_row=7, spacing=1.0)}


@pytest.mark.parametrize("sizing", list(SIZINGS))
@pytest.mark.parametrize("packing", maria_tpu.array.PACKINGS)
@pytest.mark.parametrize("shape", maria_tpu.array.SHAPES)
def test_generate_2d_pattern_is_bit_equal(shape, packing, sizing):
    from maria_tpu.array.generation import generate_2d_pattern as ref_pattern

    from maria_torch.array.generation import generate_2d_pattern

    kw = dict(SIZINGS[sizing], shape=shape, packing=packing, rotation=0.3, height_scale=1.0)
    np.testing.assert_array_equal(generate_2d_pattern(**kw), ref_pattern(**kw))


def test_generate_2d_pattern_height_scale_and_errors():
    from maria_tpu.array.generation import generate_2d_pattern as ref_pattern

    from maria_torch.array.generation import generate_2d_pattern

    kw = dict(n=50, max_diameter=1.0, shape="rhombus", height_scale=2.0)
    np.testing.assert_array_equal(generate_2d_pattern(**kw), ref_pattern(**kw))
    with pytest.raises(ValueError, match="packings"):
        generate_2d_pattern(n=7, packing="random")
    with pytest.raises(ValueError, match="shapes"):
        generate_2d_pattern(n=7, shape="star")
    with pytest.raises(ValueError, match="max_diameter"):
        generate_2d_pattern(max_diameter=1.0)


# -- arrays and instruments -----------------------------------------------------------------------


def test_array_registry_keys():
    assert maria_torch.array.all_arrays == maria_tpu.array.all_arrays


@pytest.mark.parametrize("name", maria_tpu.array.all_arrays)
def test_registry_array_matches(name):
    assert_same_table(maria_torch.array.get_array(name), maria_tpu.array.get_array(name))


ARRAY_CASES = {
    "polarized_sunflower": {"name": "cmb", "field_of_view": 0.7, "beam_spacing": 1.5, "primary_size": 10,
                            "packing": "sunflower", "shape": "circle", "polarized": True,
                            "bands": ["act/pa5/f090", "act/pa5/f150"]},
    "square_rotated": {"name": "sq", "n": 30, "field_of_view": 1.0, "packing": "square", "shape": "rhombus",
                       "rotation": 15.0, "focal_plane_offset": [0.3, -0.2], "primary_size": 7,
                       "bath_temp": 0.1, "bands": ["m2/f093"]},
    "count_and_spacing": {"name": "cs", "n": 19, "beam_spacing": 2.0, "primary_size": 6, "bands": ["act/pa4/f150"]},
    "explicit_offsets": {"name": "xy", "sky_x": [0.0, 0.1, 0.2], "sky_y": [0.0, 0.05, -0.05],
                         "pol_angle": [0.0, 45.0, 90.0], "primary_size": 6, "bands": ["act/pa4/f150"]},
    "per_detector_bands": {"name": "pd", "xi": [0.0, 0.1, 0.2, 0.3], "eta": [0.0, 0.0, 0.1, 0.1],
                           "band_name": ["act/pa5/f090", "act/pa5/f150", "act/pa5/f090", "act/pa5/f150"],
                           "polarized": True, "primary_size": 6, "bands": ["act/pa5/f090", "act/pa5/f150"]},
    "baselines": {"name": "bl", "baseline_x": [0.0, 10.0, 20.0], "baseline_y": [0.0, 5.0, 0.0], "primary_size": 12,
                  "bands": ["alma/f144"]},
    "radians": {"name": "rad", "n": 7, "field_of_view": 0.01, "degrees": False, "primary_size": 6, "band":
                {"center": 150e9, "width": 30e9, "NEP": 1e-17}},
    "one_detector": {"name": "one", "n": 1, "primary_size": 6, "bands": ["m2/f093"]},
}


@pytest.mark.parametrize("case", list(ARRAY_CASES))
def test_array_from_config_matches(case):
    """Array.from_config with maria_tpu's keywords, the detector table
    element for element (the polarized doubling's order, the gammas seeded
    by the array's name, the stable sort by band and base index)."""
    cfg = ARRAY_CASES[case]
    assert_same_table(maria_torch.array.Array.from_config(cfg), maria_tpu.array.Array.from_config(cfg))


def test_array_methods():
    cfg = ARRAY_CASES["polarized_sunflower"]
    ref, ours = maria_tpu.array.Array.from_config(cfg), maria_torch.array.Array.from_config(cfg)
    assert ours.n == 1052 and set(ours.pol_label) == {"A", "B"} and np.isfinite(ours.gamma).all()
    a, b = ours.gamma[ours.pol_label == "A"], ours.gamma[ours.pol_label == "B"]
    np.testing.assert_allclose(np.abs(np.cos(a - b)), 0.0, atol=1e-12)  # orthogonal pairs
    np.testing.assert_array_equal(ours.mask(band_name="act/pa5/f090"), ref.mask(band_name="act/pa5/f090"))
    np.testing.assert_array_equal(ours["act/pa5/f150"], ref["act/pa5/f150"])
    assert_same_table(ours.subset(ours.pol_label == "B"), ref.subset(ref.pol_label == "B"))
    assert_same_table(ours[[5, 3, 3]], ref[[5, 3, 3]])
    assert_same_table(ours.take([0, 700]), ref.take([0, 700]))
    assert_same_table(ours.one_detector_from_each_band(), ref.one_detector_from_each_band())
    assert_same_table(ours.outer(), ref.outer())
    for attr in ("knee", "efficiency", "gain_error", "band_center"):
        np.testing.assert_array_equal(getattr(ours, attr), getattr(ref, attr))
    np.testing.assert_array_equal(ours.passband([90e9, 150e9]), ref.passband([90e9, 150e9]))
    np.testing.assert_array_equal(ours.angular_fwhm(), ref.angular_fwhm().rad)
    assert ours.field_of_view == float(ref.field_of_view.rad)


def test_array_list_combine_and_configs():
    cfgs = [dict(ARRAY_CASES["count_and_spacing"]), dict(ARRAY_CASES["square_rotated"])]
    ref = maria_tpu.array.ArrayList([maria_tpu.array.Array.from_config(c) for c in cfgs]).combine()
    ours = maria_torch.array.ArrayList([maria_torch.array.Array.from_config(c) for c in cfgs]).combine()
    assert_same_table(ours, ref)
    assert maria_torch.array.get_array_config("act/pa5", n=3) == maria_tpu.array.get_array_config("act/pa5", n=3)
    with pytest.raises(ValueError, match="not a valid array"):
        maria_torch.array.get_array("act/pa9")


def test_instrument_registry():
    assert maria_torch.instrument.all_instruments == maria_tpu.instrument.all_instruments
    assert len(maria_torch.instrument.all_instruments) == 21
    for name in maria_tpu.instrument.all_instruments:
        assert maria_torch.instrument.get_instrument_config(name) == maria_tpu.instrument.get_instrument_config(name)
    assert maria_torch.get_instrument("act/act").name == maria_torch.get_instrument("ACT").name == "ACT"
    with pytest.raises(ValueError, match="not a valid instrument"):
        maria_torch.get_instrument("HAWC")


@pytest.mark.parametrize("name", maria_tpu.instrument.all_instruments)
def test_registry_instrument_matches(name):
    """Every instrument's detector table, element for element; the
    1,385,092 detectors of AtLAST-SZ included (seconds on the host)."""
    ref, ours = maria_tpu.instrument.get_instrument(name), maria_torch.get_instrument(name)
    assert ours.name == ref.name and [a.name for a in ours.arrays] == [a.name for a in ref.arrays]
    for attr in ("az_vel_limit", "az_acc_limit", "el_vel_limit", "el_acc_limit", "min_elevation", "max_elevation"):
        assert getattr(ours, attr) == float(getattr(ref, attr).value), attr
    assert_same_table(ours.dets, ref.dets)


def test_instruments_of_band_objects_and_arrays():
    """get_instrument(array={...}) with Band objects (the tutorials' form),
    Instrument(arrays=[dict, name]) naming its dicts "array-{i}"."""
    kw = dict(center=90e9, width=20e9, NET_RJ=40e-6, knee=1.0, gain_error=5e-2)
    ref_bands = [maria_tpu.band.Band(**kw), maria_tpu.band.Band(**{**kw, "center": 150e9, "width": 30e9})]
    bands = [maria_torch.band.Band(**kw), maria_torch.band.Band(**{**kw, "center": 150e9, "width": 30e9})]
    array = {"field_of_view": 0.05, "beam_spacing": 1.5, "primary_size": 50, "polarized": True}
    ref = maria_tpu.get_instrument(array={**array, "bands": ref_bands})
    ours = maria_torch.get_instrument(array={**array, "bands": bands})
    assert_same_table(ours.dets, ref.dets)
    ref = maria_tpu.instrument.Instrument(arrays=[{"n": 7, "primary_size": 6, "bands": ["m2/f093"]}, "act/pa5"])
    ours = maria_torch.Instrument(arrays=[{"n": 7, "primary_size": 6, "bands": ["m2/f093"]}, "act/pa5"])
    assert ours.name == ref.name == "array-0+act/pa5"
    assert_same_table(ours.dets, ref.dets)


# -- sites and regions ----------------------------------------------------------------------------


def test_site_and_region_registries():
    from maria_tpu.site.regions import REGIONS

    assert maria_torch.site.all_sites == maria_tpu.site.all_sites and len(maria_torch.site.all_sites) == 26
    assert maria_torch.site.all_regions == maria_tpu.site.all_regions and len(maria_torch.site.all_regions) == 25
    for name in maria_tpu.site.all_regions:
        ref = {k: (v.item() if hasattr(v, "item") else v) for k, v in REGIONS.loc[name].items()}
        assert maria_torch.site.get_region(name) == ref
    for name in maria_tpu.site.all_sites:
        assert maria_torch.site.get_site_config(name) == maria_tpu.site.get_site_config(name)


@pytest.mark.parametrize("name", maria_tpu.site.all_sites)
def test_site_matches(name):
    ref, ours = maria_tpu.get_site(name), maria_torch.get_site(name)
    assert (ours.name, ours.region, ours.description) == (ref.name, ref.region, ref.description)
    assert (ours.latitude, ours.longitude, ours.altitude) == (ref.latitude.deg, ref.longitude.deg, ref.altitude.m)
    for alias in maria_tpu.site.SITE_CONFIGS[name]["aliases"]:
        assert maria_torch.get_site(alias).name == name


def test_site_overrides_and_regions_as_sites():
    ref, ours = maria_tpu.get_site("llano_de_chajnantor", altitude=5065), \
        maria_torch.get_site("llano_de_chajnantor", altitude=5065)
    assert ours.altitude == float(ref.altitude.m) == 5065
    ref, ours = maria_tpu.get_site("chajnantor"), maria_torch.get_site("chajnantor")
    assert (ours.name, ours.altitude) == (ref.name, ref.altitude.m)
    with pytest.raises(ValueError, match="not a valid site"):
        maria_torch.get_site("atlantis")


@pytest.mark.parametrize("region", maria_tpu.site.all_regions)
def test_region_weather_matches(region):
    """The synthetic weather of every region at one time: every profile
    and the pwv within 1e-12 relative."""
    from maria_tpu.weather import Weather as RefWeather

    from maria_torch.weather import Weather

    ref, ours = RefWeather(region=region, time=1.75e9), Weather(region=region, time=1.75e9)
    for field in ("temperature", "pressure", "humidity", "wind_east", "wind_north", "wind_speed"):
        np.testing.assert_allclose(getattr(ours, field), getattr(ref, field), rtol=1e-12, err_msg=field)
    np.testing.assert_allclose(ours.pwv, ref.pwv, rtol=1e-12)


# -- scan patterns and plans ----------------------------------------------------------------------


PATTERN_OPTIONS = {
    "stare": [{}],
    "daisy": [{"radius": 1.0, "speed": 0.3}, {"radius": 2, "speed": 0.5, "petals": 3.18, "miss_factor": 0.15,
                                                "miss_freq": 1.41}],
    "lissajous": [{"width": 2.0, "height": 1.0, "speed": 0.5}, {"x_throw": 1.0, "y_throw": 0.5, "freq_ratio": 1.5}],
    "raster": [{"radius": 1.0, "speed": 0.5}, {"width": 2.0, "height": 1.0, "speed": 0.4, "n": ((5, 1), (1, 5)),
                                               "rotation_period": 30.0}],
    "back_and_forth": [{"x_throw": 2, "y_throw": 0, "speed": 1.0}, {"radius": 5, "speed": 0.5}],
    "double_circle": [{"radius": 1.0, "speed": 0.5, "ratio": 0.4}],
}
PATTERN_CASES = [(p, i) for p, opts in PATTERN_OPTIONS.items() for i in range(len(opts))]


@pytest.mark.parametrize("pattern,i", PATTERN_CASES, ids=[f"{p}-{i}" for p, i in PATTERN_CASES])
def test_scan_pattern_plan_matches(pattern, i):
    """Plan.generate with every pattern and its options: the boresight in
    az/el and ra/dec at 1e-12 rad."""
    kw = dict(duration=60, sample_rate=20, start_time="2026-03-05T12:00:00", scan_center=(45, 45), frame="az/el",
              scan_pattern=pattern, scan_options=PATTERN_OPTIONS[pattern][i], site="cerro_toco")
    ref, ours = maria_tpu.Plan.generate(**kw), maria_torch.Plan.generate(**kw)
    np.testing.assert_array_equal(ours.time, ref.time)
    for attr in ("az", "el", "ra", "dec"):
        np.testing.assert_allclose(getattr(ours, attr), getattr(ref, attr), rtol=0, atol=1e-12, err_msg=attr)


def test_scan_patterns_and_kwargs():
    from maria_tpu.plan.patterns import parse_scan_kwargs as ref_parse

    from maria_torch.plan import SCAN_PATTERNS, get_scan_pattern_generator, parse_scan_kwargs

    assert list(SCAN_PATTERNS) == list(maria_tpu.plan.SCAN_PATTERNS)
    assert get_scan_pattern_generator("back-and-forth") is get_scan_pattern_generator("back_and_forth")
    for kw in ({}, {"radius": 2}, {"width": 3}, {"height": 1.0}, {"y_throw": 0.4}, {"width": 2, "height": 1}):
        assert parse_scan_kwargs(kw) == ref_parse(kw)
    with pytest.raises(ValueError, match="Invalid scan kwarg"):
        parse_scan_kwargs({"spiral": 1})
    with pytest.raises(ValueError, match="Invalid scan pattern"):
        get_scan_pattern_generator("spiral")


def test_plan_registry():
    assert maria_torch.plan.all_plans == maria_tpu.plan.all_plans and len(maria_torch.plan.all_plans) == 6
    for name in maria_tpu.plan.all_plans:
        assert maria_torch.plan.get_plan_config(name, duration=5) == maria_tpu.plan.get_plan_config(name, duration=5)


@pytest.mark.parametrize("name", maria_tpu.plan.all_plans)
def test_registry_plan_matches(name):
    kw = dict(start_time=1.75e9) if name != "back_and_forth_10deg_45el" else dict(duration=600, site="ACT")
    ref, ours = maria_tpu.get_plan(name, **kw), maria_torch.get_plan(name, **kw)
    np.testing.assert_array_equal(ours.time, ref.time)
    for attr in ("az", "el", "ra", "dec"):
        np.testing.assert_allclose(getattr(ours, attr), getattr(ref, attr), rtol=0, atol=1e-12, err_msg=attr)


def test_get_plan_of_an_unknown_plan_raises():
    with pytest.raises(ValueError, match="not a supported plan"):
        maria_torch.get_plan("spiral_1h")


# -- the map families of Stokes IQUV and a velocity axis -------------------------------------------


@pytest.mark.parametrize("name", ["polarized_source", "spectral_line_cube"])
def test_polarized_and_line_families_are_bit_equal(name):
    ref, ours = maria_tpu.map.get(name, fetch_first=False), maria_torch.map.get(name)
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(ours.weight.numpy(), np.asarray(ref.weight))
    assert ours.stokes == ref.stokes and ours.shape == tuple(ref.shape)
    if name == "polarized_source":
        assert ours.stokes == "IQUV"
        I, Q, U, V = ours.data[:, 0, 0].double()
        p = torch.sqrt(Q**2 + U**2) / I.clamp(min=1e-30)
        assert float(p.max()) == pytest.approx(0.1, rel=0.05) and not V.any()
    else:
        assert ours.axis3_label == "v" and len(ours.t) == 16
        np.testing.assert_array_equal(ours.t, np.asarray(ref.v))


def test_array_from_columns_carries_a_uuid_named_table():
    """A maria_tpu array made without a name (a random uuid, which seeds
    its polarization angles) carried into the port by its columns: the
    table element for element, so the port's Stokes weights are its."""
    from maria_torch.convert import array_from_columns

    cfg = {"n": 19, "field_of_view": 0.1, "primary_size": 6, "polarized": True, "bands": ["act/pa5/f090", "act/pa5/f150"]}
    ref = maria_tpu.instrument.Instrument(arrays=[maria_tpu.array.Array.from_config(cfg)]).dets
    columns = {k: ref.dets[k].values for k in ("xi", "eta", "gamma", "band_name", "pol_label", "base_det_index",
                                              "array_name", "primary_size", "bath_temp", "time_constant")}
    ours = array_from_columns(columns, ref.bands.names)
    assert ours.name == ref.name and len(ref.name) == 8  # the uuid's first eight characters
    assert_same_table(ours, ref)
    with pytest.raises(ValueError, match="missing detector columns"):
        array_from_columns({"xi": columns["xi"]}, ref.bands.names)


def test_band_net_rj_through_an_atmosphere(tmp_path):
    """NET_RJ with spectrum_kwargs: the K_RJ <-> W kernel through the
    region's synthetic spectrum at its pwv, temperature and elevation, as
    maria_tpu's (1e-6 relative: both interpolate the same float64 grid)."""
    from maria_tpu.io import caching as tpu_caching

    old_tpu, old_torch = tpu_caching.get_cache_dir(), maria_torch.io._cache_state["base"]
    maria_tpu.set_cache_dir(str(tmp_path / "maria_tpu"))
    maria_torch.set_cache_dir(str(tmp_path / "maria_torch"))
    try:
        kw = dict(center=150e9, width=30e9, NET_RJ=60e-6,
                  spectrum_kwargs={"region": "chajnantor", "pwv": 1.5, "elevation": 50})
        ref, ours = maria_tpu.band.Band(**kw), maria_torch.band.Band(**kw)
        assert ours.spectrum.region == "chajnantor"
        assert ours.NEP == pytest.approx(ref.NEP, rel=1e-6)
        assert ours.NEP < maria_torch.band.Band(center=150e9, width=30e9, NET_RJ=60e-6).NEP  # the sky's transmission
        assert ours.NET_RJ == pytest.approx(60e-6, rel=1e-12)
    finally:
        maria_tpu.set_cache_dir(old_tpu)
        maria_torch.set_cache_dir(old_torch)
