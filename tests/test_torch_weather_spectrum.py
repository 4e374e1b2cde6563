"""The port's weather thermodynamics, atmospheric spectrum lookups and
the Band's atmosphere methods against maria_tpu on the CPU
(maria_tpu/weather/__init__.py, spectrum/__init__.py, band/__init__.py).

Host numpy is held at 1e-12 in float64; the device lookups (the 4-D
spectrum interpolation, Band.atmosphere_power) within 1e-6 relative to
the values' scale in float32. Each package keeps its spectrum in a
private cache directory.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import maria_tpu  # noqa: E402
import maria_tpu.weather as tpu_weather  # noqa: E402
from maria_tpu.io import caching as tpu_caching  # noqa: E402

import maria_torch  # noqa: E402
import maria_torch.weather as weather  # noqa: E402

REGION = "chajnantor"


def rng(seed=0):
    return np.random.default_rng(seed)


def assert_scaled(ours, ref, rtol):
    """|ours - ref| <= rtol * max|ref|."""
    ours, ref = np.asarray(ours, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max() / np.abs(ref).max()
    assert err <= rtol, f"worst error {err:.3e} of the scale"


# -- weather -----------------------------------------------------------------------------------


def test_thermodynamics():
    r = rng()
    T = r.uniform(200, 310, 100)
    h = r.uniform(0.0, 1.0, 100)
    p = r.uniform(3e4, 1.05e5, 100)
    for name, args in (("vapor_pressure", (T, h)), ("dew_point", (T, h)), ("saturation_pressure", (T,)),
                       ("air_density", (p, T, h)), ("relative_to_absolute_humidity", (T, h))):
        np.testing.assert_allclose(getattr(weather, name)(*args), getattr(tpu_weather, name)(*args), rtol=1e-12)
    dp = tpu_weather.dew_point(T, h)
    np.testing.assert_allclose(weather.dew_point_to_relative_humidity(T, dp),
                               tpu_weather.dew_point_to_relative_humidity(T, dp), rtol=1e-12)
    np.testing.assert_allclose(weather.dew_point_to_relative_humidity(T, weather.dew_point(T, h)),
                               np.clip(h, 1e-8, None), rtol=1e-9)


@pytest.mark.parametrize("region, t, override", [("chajnantor", 1.75e9, {}), ("green_bank", 1.76e9, {"pwv": 3.0}),
                                                 ("south_pole", 1.7e9, {})])
def test_weather_layers_and_bearing(region, t, override):
    """``layers`` gives maria_tpu's DataFrame as numpy columns; the wind
    bearing and the pwv agree."""
    ours = weather.Weather(region, time=t, override=override, refresh_cache=True)
    ref = tpu_weather.Weather(region, time=t, override=override)
    layers, ref_layers = ours.layers(), ref.layers()
    assert list(layers) == list(ref_layers.columns)
    for col in layers:
        np.testing.assert_allclose(layers[col], ref_layers[col].values, rtol=1e-12, err_msg=col)
    np.testing.assert_allclose(ours.wind_bearing, ref.wind_bearing, rtol=1e-12)
    assert ours.pwv == pytest.approx(float(ref_layers.total_water.sum()), rel=1e-12)


def test_weather_default_region():
    assert weather.Weather(time=1.75e9).region == tpu_weather.Weather(time=1.75e9).region == REGION


# -- the spectrum --------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def spectra(tmp_path_factory):
    """Both packages' spectra of one region, private caches."""
    old_tpu, old_torch = tpu_caching.get_cache_dir(), maria_torch.io._cache_state["base"]
    maria_tpu.set_cache_dir(str(tmp_path_factory.mktemp("maria_tpu_cache")))
    maria_torch.set_cache_dir(str(tmp_path_factory.mktemp("maria_torch_cache")))
    try:
        from maria_tpu.spectrum import AtmosphericSpectrum as TpuSpectrum

        from maria_torch.spectrum import AtmosphericSpectrum

        yield AtmosphericSpectrum(REGION), TpuSpectrum(REGION)
    finally:
        maria_tpu.set_cache_dir(old_tpu)
        maria_torch.set_cache_dir(old_torch)


def spectrum_samples(spectrum, n=400, seed=0):
    """(base_temperature, pwv, elevation, nu) samples inside and beyond the grid, float32."""
    r = rng(seed)
    T = r.uniform(255, 305, n)
    pwv = np.exp(r.uniform(np.log(0.03), np.log(120), n))
    el = r.uniform(0.05, 1.6, n)
    nu = r.uniform(0.5e9, 1.3e12, n)
    return tuple(x.astype(np.float32) for x in (T, pwv, el, nu))


def test_spectrum_grids(spectra):
    ours, ref = spectra
    for a, b in zip(ours.points, ref.points):
        np.testing.assert_array_equal(a, b)
    for q in ("emission", "opacity", "path_delay"):
        np.testing.assert_array_equal(getattr(ours, f"_{q}"), getattr(ref, f"_{q}"))
    assert float(ours.nu_min.Hz) == float(ref.nu_min.Hz) and float(ours.nu_max.Hz) == float(ref.nu_max.Hz)
    assert ours.altitude == ref.altitude


@pytest.mark.parametrize("quantity", ["emission", "opacity", "path_delay", "transmission"])
def test_spectrum_lookups(spectra, quantity):
    """At every sample within 1e-6 of maria_tpu's scale; arrays computed
    on the device asked for give what their tensors give, on that device;
    the defaults (the grid's median temperature and pwv, 45 deg) as
    maria_tpu's."""
    ours, ref = spectra
    T, pwv, el, nu = spectrum_samples(ours)
    want = np.asarray(getattr(ref, quantity)(nu, pwv=pwv, base_temperature=T, elevation=el))
    got = getattr(ours, quantity)(nu, pwv=pwv, base_temperature=T, elevation=el, device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32 and got.device.type == "cpu"
    assert_scaled(got.numpy(), want, 1e-6)
    t = getattr(ours, quantity)(torch.as_tensor(nu), pwv=torch.as_tensor(pwv), base_temperature=torch.as_tensor(T),
                                elevation=torch.as_tensor(el))
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), got.numpy())
    assert_scaled(getattr(ours, quantity)(nu, device="cpu").numpy(), np.asarray(getattr(ref, quantity)(nu)), 1e-6)


def test_spectrum_keywords(spectra):
    """``altitude`` is kept (the grids stay the region's); ``refresh_cache``
    makes the cached grids anew, the same values."""
    from maria_torch.spectrum import AtmosphericSpectrum

    ours, _ = spectra
    s = AtmosphericSpectrum(REGION, altitude=5200.0, refresh_cache=True)
    assert s.altitude == 5200.0
    np.testing.assert_array_equal(s._opacity, ours._opacity)


# -- the band's atmosphere -----------------------------------------------------------------------


@pytest.mark.parametrize("band", ["atlast/f093", "m2/f093", "act/pa5/f150"])
def test_band_atmosphere_power(spectra, band):
    """Band.atmosphere_power within 1e-6 of maria_tpu's scale at samples
    across the table, arrays on the CPU asked for and tensors in."""
    ours_s, ref_s = spectra
    ours, ref = maria_torch.get_band(band), maria_tpu.get_band(band)
    r = rng(1)
    pwv = np.exp(r.uniform(np.log(0.05), np.log(20), 500)).astype(np.float32)
    el = r.uniform(0.2, 1.5, 500).astype(np.float32)
    want = np.asarray(ref.atmosphere_power(ref_s, 270.0, pwv, el))
    got = ours.atmosphere_power(ours_s, 270.0, pwv, el, device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert_scaled(got.numpy(), want, 1e-6)
    t = ours.atmosphere_power(ours_s, 270.0, torch.as_tensor(pwv), torch.as_tensor(el))
    np.testing.assert_array_equal(t.numpy(), got.numpy())


def test_band_atmosphere_power_is_the_programs():
    """The loading a TODProgram evaluates at its coarse pwv and elevation
    (its cropped TableEval) is Band.atmosphere_power's at the same
    samples, band by band, within 1e-6 of the scale."""
    from maria_torch.ops.program import build_tod_program

    old = maria_torch.io._cache_state["base"]
    try:
        plan = maria_torch.get_plan("daisy", start_time=1.75e9, scan_center=(150.0, 41.0), frame="az/el",
                                    duration=4.0, sample_rate=20.0, scan_options={"radius": 0.083, "speed": 0.017},
                                    site="GBT")
        sim = maria_torch.Simulation("MUSTANG-2", plans=plan, site="GBT", atmosphere="2d", seed=0, device="cpu")
        program = build_tod_program(sim.obs_list[0], device="cpu")
        coarse = program.fields(seed=1, device="cpu", upto="coarse")
        atm = sim.obs_list[0].atmosphere
        T_base = float(atm.weather.temperature[0])
        mueller_I = torch.as_tensor(np.asarray(program.mueller_I, dtype=np.float32))
        for band, block in zip(sim.instrument.dets.bands, program.bands):
            idx = torch.as_tensor(block.det_index)
            p = band.atmosphere_power(atm.spectrum, T_base, coarse["pwv_c"][idx], coarse["el_c"][idx])
            assert_scaled(p * mueller_I[idx, None], coarse["loading_c"][idx], 1e-6)
    finally:
        maria_torch.set_cache_dir(old)


@pytest.mark.parametrize("name", ["emission", "opacity", "path_delay", "transmission", "Band.atmosphere_power",
                                  "Band.transmission"])
def test_lookups_of_arrays_alone_run_on_the_card(monkeypatch, spectra, name):
    """Given numbers or arrays and no device, the spectrum's lookups and
    the band's compute on the card, as an entry point given no device
    does: where there is none they raise, and never fall back to the CPU
    unasked."""
    ours, _ = spectra
    band = maria_torch.get_band("m2/f093")
    nu, pwv, el = np.array([90e9, 150e9]), np.array([1.0, 2.0]), np.array([0.8, 1.2])
    call = {
        "Band.atmosphere_power": lambda **kw: band.atmosphere_power(ours, 270.0, pwv, el, **kw),
        "Band.transmission": lambda **kw: band.transmission(region=REGION, **kw),
    }.get(name, lambda **kw: getattr(ours, name)(nu, pwv=pwv, elevation=el, **kw))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    out = call(device="cpu")
    assert out.device.type == "cpu" and out.dtype == torch.float32


def test_band_transmission_summary_and_wavelength(spectra):
    """maria_tpu's ``transmission`` keeps the region's spectrum as the
    band's own, after which its NET_RJ (and ``summary``) fails without
    spectrum keywords; the port keeps it aside, so the summary is held
    against a fresh maria_tpu band."""
    ours, ref = maria_torch.get_band("m2/f093"), maria_tpu.get_band("m2/f093")
    for pwv, el in ((1.0, np.radians(90)), (3.0, np.radians(40))):
        assert float(ours.transmission(region=REGION, pwv=pwv, elevation=el, device="cpu")) == pytest.approx(
            float(ref.transmission(region=REGION, pwv=pwv, elevation=el)), rel=1e-6)
    assert ours.spectrum is None  # the band's noise levels keep their vacuum kernel
    assert ours.wavelength == ref.wavelength
    s, r = ours.summary(), maria_tpu.get_band("m2/f093").summary()
    assert list(s) == list(r) and s["name"] == r["name"] and s["efficiency"] == r["efficiency"]
    for key in ("center", "width", "NEP", "NET_RJ"):
        assert float(s[key].value) == pytest.approx(float(r[key].value), rel=1e-12)


def test_band_plot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ax = maria_torch.get_band("m2/f093").plot()
    ref_ax = maria_tpu.get_band("m2/f093").plot()
    np.testing.assert_array_equal(ax.lines[0].get_xydata(), ref_ax.lines[0].get_xydata())
    assert ax.get_xlabel() == ref_ax.get_xlabel()
    plt.close("all")


def test_band_sensitivity_warns(caplog):
    """``sensitivity`` is NET_RJ's deprecated name: it warns and gives the
    band NET_RJ gives."""
    with caplog.at_level(logging.WARNING, logger="maria_torch"):
        band = maria_torch.Band(center=150e9, width=30e9, sensitivity=40e-6)
    assert "'sensitivity' is deprecated" in caplog.text
    assert band.NEP == maria_torch.Band(center=150e9, width=30e9, NET_RJ=40e-6).NEP
    assert band.NEP == pytest.approx(maria_tpu.Band(center=150e9, width=30e9, sensitivity=40e-6).NEP, rel=1e-12)


def test_validate_band_config():
    from maria_tpu.band import validate_band_config as tpu_validate

    from maria_torch.band import validate_band_config

    for cfg in ({"center": 1, "width": 2}, {"passband": "x"}):
        assert validate_band_config(cfg) is tpu_validate(cfg) is None
    for f in (validate_band_config, tpu_validate):
        with pytest.raises(ValueError, match="center and width"):
            f({"center": 1})


@pytest.mark.parametrize("eps", [1e-6, 1e-4])
def test_cmb_power_tables_eps(spectra, eps):
    """The CMB stage's (pwv, el) tables with the two-point step ``eps``
    as maria_tpu's (float32 tables)."""
    from maria_torch.sim.cmb import cmb_power_tables

    from maria_tpu.sim.cmb import cmb_power_tables as tpu_tables

    ours_s, ref_s = spectra
    band, ref_band = maria_torch.get_band("act/pa5/f150"), maria_tpu.get_band("act/pa5/f150")
    for a, b in zip(cmb_power_tables(band, ours_s, 272.0, eps=eps), tpu_tables(ref_band, ref_s, 272.0, eps=eps)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6)
