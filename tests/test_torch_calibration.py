"""The port's calibration graph against maria_tpu's, on the CPU: every
edge, every route of the graph and its missing keywords, Band.NET_CMB,
TOD.to into every TOD quantity in a vacuum and through an atmosphere,
Map.to for projected and HEALPix maps, the mappers in uK_RJ, uK_CMB and
Jy/pixel, and input skies in Jy/pixel and uK_CMB through the map and CMB
stages. The same numpy inputs, made from a seed, go to both packages.

Through an atmosphere the port is held to a float64 oracle written here
(the passband integral of each temperature on the spectrum's grid, then
scipy's multilinear interpolation on maria_tpu's axis transforms, then
the difference): maria_tpu interpolates its grid in float32 before it
differences two powers 1e-5 K apart. One float32 ulp of a band power is
~1.5% of that difference, so maria_tpu's dP/dT_CMB moves in steps of
elevation by 0.85% at 40-50 deg (act/pa5/f150) and by up to 4.6% on a
sample of the TOD test here (ROADMAP queue 3, hazard 9). There the port
is held to maria_tpu only within 5%, and test_hazard_9_float32_steps
states the steps.
"""

import os
import sys

import numpy as np
import pytest
from scipy.interpolate import RegularGridInterpolator

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import maria_tpu  # noqa: E402
import maria_tpu.band  # noqa: E402
import maria_tpu.calibration as ref_cal  # noqa: E402
import maria_tpu.calibration.functions as RF  # noqa: E402
import maria_tpu.map  # noqa: E402
from maria_tpu.io import caching as tpu_caching  # noqa: E402

import maria_torch  # noqa: E402
import maria_torch.calibration as cal  # noqa: E402
import maria_torch.calibration.functions as F  # noqa: E402
from maria_torch.band import axis_transform, get_band  # noqa: E402
from maria_torch.constants import T_CMB, k_B  # noqa: E402
from maria_torch.errors import IncompatibleQuantityError, MissingCalibrationKwargsError  # noqa: E402
from maria_torch.map import HEALPixMap, ProjectionMap  # noqa: E402
from maria_torch.spectrum import AtmosphericSpectrum  # noqa: E402
from maria_torch.tod import Pointing  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_polarized import SMALL_ARRAY, block_arrays, caches, pair, patch, patch_grid  # noqa: E402, F401

QUANTITIES = list(cal.QUANTITY_UNITS)
BAND = "act/pa5/f150"
NU = 148e9
PIXEL_AREA, BEAM_AREA = 3.1e-7, 2.4e-6
ATM = dict(zenith_pwv=1.0, base_temperature=270.0)
SAMPLE_QUANTITY = {  # a row of canonical values of each quantity, away from its singular points
    "power": np.array([1e-13, 2.5e-12, 7e-12]),
    "rayleigh_jeans_temperature": np.array([-3e-4, 1e-3, 20.0]),
    "cmb_temperature_anisotropy": np.array([-2e-4, 3e-5, 1e-3]),
    "brightness_temperature": np.array([2.7, 3.5, 30.0]),
    "spectral_flux_density_per_pixel": np.array([-0.2, 1e-3, 4.0]),
    "spectral_flux_density_per_beam": np.array([-0.2, 1e-3, 4.0]),
    "spectral_radiance": np.array([-1e6, 3e4, 1e8]),
    "compton_y": np.array([-1e-5, 2e-6, 3e-4]),
}


@pytest.fixture(scope="module")
def spectra(caches):
    from maria_tpu.spectrum import AtmosphericSpectrum as RefSpectrum

    return RefSpectrum("chajnantor"), AtmosphericSpectrum("chajnantor")


def edge_kwargs(package, polarized=False, spectrum=None, **extra):
    band = (maria_tpu.band if package == "ref" else maria_torch.band).get_band(BAND)
    return dict(band=band, nu=NU, pixel_area=PIXEL_AREA, beam_area=BEAM_AREA, polarized=polarized, spectrum=spectrum,
                **extra)


# -- the float64 oracle through an atmosphere ----------------------------------------------------------


def _axis(side):
    return np.log(side) if axis_transform(side)[0] == "log" else np.asarray(side, dtype=np.float64)


def oracle_band_power(T_b, band, spectrum, zenith_pwv, base_temperature, elevation, polarized=False):
    """k_B ∫ T_RJ(T_b, nu) passband e^-opacity dnu [W] at each elevation, in
    float64: the integral on the spectrum's whole grid, then scipy's
    multilinear interpolation in (T, log pwv, el), coordinates clipped."""
    nu = spectrum.side_nu
    T_RJ = RF.inverse_rayleigh_jeans_spectrum(RF.planck_spectrum(T_b, nu), nu)
    grid = np.trapezoid(T_RJ * band.passband(nu) * np.exp(-spectrum._opacity), x=nu, axis=-1)
    sides = spectrum.points[:3]
    el = np.clip(np.asarray(elevation, dtype=np.float64), sides[2][0], sides[2][-1])
    xi = np.stack(np.broadcast_arrays(
        np.clip(base_temperature, sides[0][0], sides[0][-1]),
        np.log(np.clip(zenith_pwv, sides[1][0], sides[1][-1])), el), axis=-1)
    value = RegularGridInterpolator(tuple(_axis(s) for s in sides), grid)(xi)
    return (0.5 if polarized else 1.0) * k_B * value


def oracle_dP_dT_CMB(band, spectrum, elevation, eps=1e-5, **kw):
    hi = oracle_band_power(T_CMB + eps / 2, band, spectrum, ATM["zenith_pwv"], ATM["base_temperature"], elevation, **kw)
    lo = oracle_band_power(T_CMB - eps / 2, band, spectrum, ATM["zenith_pwv"], ATM["base_temperature"], elevation, **kw)
    return (hi - lo) / eps


def oracle_rj_kernel(band, spectrum, elevation, polarized=False):
    nu = spectrum.side_nu
    grid = np.trapezoid(band.passband(nu) * np.exp(-spectrum._opacity), x=nu, axis=-1)
    sides = spectrum.points[:3]
    xi = np.stack(np.broadcast_arrays(ATM["base_temperature"], np.log(ATM["zenith_pwv"]),
                                      np.clip(np.asarray(elevation, np.float64), sides[2][0], sides[2][-1])), axis=-1)
    return (0.5 if polarized else 1.0) * k_B * RegularGridInterpolator(tuple(_axis(s) for s in sides), grid)(xi)


# -- every edge -----------------------------------------------------------------------------------------


EDGES = [(q1, q2) for q1, ends in ref_cal.conversions.items() for q2 in ends]


def test_graph_tables_equal():
    """The same quantities, the same edges in the same order (the BFS
    takes the first chain whose keywords are met), the same linearity and
    keywords, and the same functions by name."""
    assert cal.QUANTITY_UNITS == ref_cal.QUANTITY_UNITS
    assert list(cal.conversions) == list(ref_cal.conversions)
    for q1, ends in ref_cal.conversions.items():
        assert list(cal.conversions[q1]) == list(ends), q1
        for q2, edge in ends.items():
            ours = cal.conversions[q1][q2]
            assert ours["linear"] == edge["linear"] and ours.get("required_kwargs") == edge.get("required_kwargs")
            assert ours["f"].__name__ == edge["f"].__name__
    assert cal.VALID_CALIBRATION_KWARGS == ref_cal.VALID_CALIBRATION_KWARGS
    assert cal.KWARGS_UNITS == ref_cal.KWARGS_UNITS


@pytest.mark.parametrize("q1,q2", EDGES)
@pytest.mark.parametrize("polarized", [False, True])
def test_edge_in_a_vacuum_matches(q1, q2, polarized):
    """Every edge in float64 on the host, without a spectrum, at 1e-12."""
    x = SAMPLE_QUANTITY[q1]
    ref_f, f = ref_cal.conversions[q1][q2]["f"], cal.conversions[q1][q2]["f"]
    if q1 == "power" and q2 == "brightness_temperature":
        for fn, package in ((ref_f, "ref"), (f, "ours")):
            with pytest.raises(NotImplementedError):
                fn(x, **edge_kwargs(package, polarized))
        return
    ref = ref_f(x, **edge_kwargs("ref", polarized))
    ours = f(x, **edge_kwargs("ours", polarized))
    assert np.asarray(ours).dtype == np.float64
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=0)


@pytest.mark.parametrize("fn", ["dP_dT_CMB", "T_RJ_per_T_CMB", "brightness_temperature_to_power_explicit"])
def test_band_functions_in_a_vacuum_match(fn):
    args = {"brightness_temperature_to_power_explicit": (np.array([2.0, T_CMB, 40.0]),)}.get(fn, ())
    for polarized in (False, True):
        kw = {} if fn == "T_RJ_per_T_CMB" else {"polarized": polarized}
        ref = getattr(RF, fn)(*args, band=maria_tpu.band.get_band(BAND), **kw)
        ours = getattr(F, fn)(*args, band=get_band(BAND), **kw)
        np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=0)
    with pytest.raises(maria_torch.errors.ShapeError):
        F.brightness_temperature_to_power_explicit(np.ones((2, 2)), band=get_band(BAND))


@pytest.mark.parametrize("q1,q2", [e for e in EDGES if "band" in ref_cal.conversions[e[0]][e[1]].get(
    "required_kwargs", []) and e != ("power", "brightness_temperature")])
def test_band_edge_through_the_atmosphere(spectra, q1, q2):
    """The band-integrated edges through the atmosphere at host
    elevations (float64) and at an elevation tensor (the elevation table
    interpolated on the device in float32), from 20 to 80 deg: against
    the float64 oracle at 1e-9 and 1e-6, and against maria_tpu within 5%
    for the K_CMB edges (hazard 9), 1e-6 for the others."""
    ref_spec, spec = spectra
    el = np.radians(np.linspace(20.0, 80.0, 41))
    x = SAMPLE_QUANTITY[q1][1]
    band = get_band(BAND)
    host = cal.conversions[q1][q2]["f"](x, **edge_kwargs("ours", spectrum=spec, elevation=el, **ATM))
    dev = cal.conversions[q1][q2]["f"](x, **edge_kwargs("ours", spectrum=spec, **ATM,
                                                        elevation=torch.as_tensor(el, dtype=torch.float32)))
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.float32 and dev.shape == el.shape
    ref = ref_cal.conversions[q1][q2]["f"](x, **edge_kwargs("ref", spectrum=ref_spec, elevation=el, **ATM))
    if q1 == "brightness_temperature":  # the two-point line about T_b
        P_lo, P_hi = (oracle_band_power(x + d, band, spec, **ATM, elevation=el) for d in (-5e-5, 5e-5))
        oracle, maria_tpu_limit = P_lo + 5e-5 * (P_hi - P_lo) / 1e-4, 1e-6
    elif "cmb_temperature_anisotropy" in (q1, q2):
        slope, maria_tpu_limit = oracle_dP_dT_CMB(band, spec, el), 5e-2
    else:
        slope, maria_tpu_limit = oracle_rj_kernel(band, spec, el), 1e-6
    if q1 != "brightness_temperature":
        oracle = x * slope if q1 != "power" else x / slope
    np.testing.assert_allclose(host, oracle, rtol=1e-9)
    np.testing.assert_allclose(dev.double().numpy(), oracle, rtol=1e-6)
    np.testing.assert_allclose(ref, oracle, rtol=maria_tpu_limit)


def test_hazard_9_float32_steps(spectra):
    """maria_tpu's K_CMB -> pW factor through the atmosphere (ROADMAP
    queue 3, hazard 9) at 40, 42.5, 45, 47.5 and 50 deg: it takes the same
    value at 42.5 and 45 deg, falls from 40 to 42.5 deg and is up to 0.85%
    from the float64 oracle; the port is monotonic and within 1e-6 of it."""
    ref_spec, spec = spectra
    el = np.radians([40, 42.5, 45, 47.5, 50])
    ref = ref_cal.Calibration("K_CMB -> pW", band=maria_tpu.band.get_band("act/pa5/f150"), spectrum=ref_spec,
                              elevation=el, **ATM)(1.0)
    ours = maria_torch.Calibration("K_CMB -> pW", band=get_band("act/pa5/f150"), spectrum=spec,
                                   elevation=torch.as_tensor(el, dtype=torch.float32), **ATM)(1.0).double().numpy()
    oracle = 1e12 * oracle_dP_dT_CMB(get_band("act/pa5/f150"), spec, el)
    np.testing.assert_allclose(ours, oracle, rtol=1e-6)
    assert (np.diff(ours) > 0).all() and (np.diff(oracle) > 0).all()
    assert ref[1] == ref[2] and ref[0] > ref[1]
    assert 5e-3 < np.abs(ref / oracle - 1).max() < 1.5e-2


# -- routes --------------------------------------------------------------------------------------------


KWARG_SETS = [
    {}, {"band": "b"}, {"nu": NU}, {"nu": NU, "pixel_area": PIXEL_AREA}, {"nu": NU, "beam_area": BEAM_AREA},
    {"pixel_area": PIXEL_AREA, "beam_area": BEAM_AREA}, {"band": "b", "nu": NU},
    {"band": "b", "nu": NU, "pixel_area": PIXEL_AREA, "beam_area": BEAM_AREA},
]


def _route(module, q1, q2, kwargs, enforce=True):
    try:
        return ("chain", module.compute_quantities_chain(q1, q2, kwargs=kwargs, enforce_kwargs=enforce))
    except Exception as e:  # noqa: BLE001 — the exception is what is compared
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("q1", QUANTITIES)
@pytest.mark.parametrize("q2", QUANTITIES)
def test_every_route_matches(q1, q2):
    """Every ordered pair of the eight quantities, under each set of
    keywords and without enforcing them: the same chain, or the same
    exception (MissingCalibrationKwargsError naming the same keywords in
    the same order, or IncompatibleQuantityError)."""
    for kwargs in KWARG_SETS:
        ours, ref = _route(cal, q1, q2, kwargs), _route(ref_cal, q1, q2, kwargs)
        assert ours == ref, (kwargs, ours, ref)
        assert ours[0] in ("chain", "MissingCalibrationKwargsError", "IncompatibleQuantityError")
    assert _route(cal, q1, q2, {}, enforce=False) == _route(ref_cal, q1, q2, {}, enforce=False)
    u1, u2 = cal.QUANTITY_UNITS[q1], cal.QUANTITY_UNITS[q2]
    try:
        linear = ref_cal.Calibration(f"{u1} -> {u2}").linear()
    except IncompatibleQuantityError as e:
        with pytest.raises(type(e)):
            cal.Calibration(f"{u1} -> {u2}").linear()
    else:
        assert cal.Calibration(f"{u1} -> {u2}").linear() == linear


@pytest.mark.parametrize("signature", [
    "uK_RJ -> pW", "pW -> uK_CMB", "mK_CMB -> uK_RJ", "K_RJ -> mJy/pixel", "Jy/pixel -> MJy/sr", "uK_RJ -> K_b",
    "K_b -> pW", "K_CMB -> y", "y -> uK_RJ", "Jy/beam -> Jy/pixel", "K_b -> K_CMB", "uK_CMB -> K_b",
])
def test_calibration_calls_match(signature):
    """Calibration(signature, ...)(x) with every keyword given, at 1e-12;
    and the errors of the signature parser and the keyword check."""
    for quantity, x in SAMPLE_QUANTITY.items():
        if cal.parse_calibration_signature(signature)["in"].quantity == quantity:
            break
    ref = ref_cal.Calibration(signature, **edge_kwargs("ref"))
    ours = cal.Calibration(signature, **edge_kwargs("ours"))
    assert ours.linear() == ref.linear() and repr(ours) == repr(ref)
    np.testing.assert_allclose(ours(x), ref(x), rtol=1e-12)
    for bad in ("K_RJ", "K_RJ -> pW -> K_CMB"):
        with pytest.raises(ValueError):
            cal.parse_calibration_signature(bad)
    with pytest.raises(ValueError, match="Invalid calibration kwarg"):
        cal.Calibration(signature, colour="red")
    with pytest.raises(ValueError, match="does not map between"):
        cal.Calibration("m -> s^-1 m")


def test_missing_kwargs_raise_by_name():
    with pytest.raises(MissingCalibrationKwargsError, match="beam_area"):
        cal.Calibration("K_RJ -> Jy/beam", nu=NU)(1.0)
    with pytest.raises(maria_torch.errors.MissingCalibrationKwargs, match="band"):
        cal.Calibration("pW -> K_RJ")(1.0)
    with pytest.raises(IncompatibleQuantityError):
        cal.Calibration("K_RJ -> s")(1.0)


# -- Band.NET_CMB --------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", maria_tpu.band.all_bands)
def test_net_cmb_matches(name):
    """NET_CMB of every registry band, and its setter, against maria_tpu's
    at 1e-10 (no registry band names a spectrum: both in a vacuum)."""
    ref, ours = maria_tpu.band.get_band(name), get_band(name)
    np.testing.assert_allclose(ours.NET_CMB, ref.NET_CMB, rtol=1e-10)
    ref.NET_CMB, ours.NET_CMB = 7e-5, 7e-5
    np.testing.assert_allclose(ours.NEP, ref.NEP, rtol=1e-10)
    np.testing.assert_allclose(ours.NET_RJ, ref.NET_RJ, rtol=1e-10)
    made = maria_torch.band.Band(nu=ours.nu, tau=ours.tau, NET_CMB=3e-5)
    ref_made = maria_tpu.band.Band(nu=ref.nu, tau=ref.tau, NET_CMB=3e-5)
    np.testing.assert_allclose(made.NEP, ref_made.NEP, rtol=1e-10)
    np.testing.assert_allclose(made.NET_CMB, 3e-5, rtol=1e-12)


def test_net_cmb_through_a_spectrum(caches):
    """A band whose noise is given through a spectrum (spectrum_kwargs):
    NET_CMB against the float64 oracle at 1e-9, and against maria_tpu
    within 1.5% (hazard 9)."""
    kw = dict(center=150e9, width=30e9, NEP=2e-17, spectrum_kwargs={"region": "chajnantor", "pwv": 1.0,
                                                                     "temperature": 270.0, "elevation": 45})
    ours, ref = maria_torch.band.Band(**kw), maria_tpu.band.Band(**kw)
    oracle = 2e-17 / oracle_dP_dT_CMB(ours, ours.spectrum, np.radians(45.0))
    np.testing.assert_allclose(ours.NET_CMB, oracle, rtol=1e-9)
    np.testing.assert_allclose(ref.NET_CMB, oracle, rtol=1.5e-2)


# -- TOD.to ----------------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tods(caches):
    """The polarized two-band array (76 detectors) on a 10 s, 20 Hz
    back-and-forth at 45 deg: both packages' observations, and a maker of
    TOD pairs of the same data on each package's own pointing, in a
    vacuum or through the chajnantor atmosphere at pwv 1 mm and 270 K."""
    from maria_tpu.tod.tod import Pointing as RefPointing

    plan_kw = dict(duration=10.0, sample_rate=20, start_time=1.75e9, scan_center=(45, 45),
                   scan_pattern="back-and-forth", scan_options={"x_throw": 2, "y_throw": 0, "speed": 1.0},
                   frame="az/el", site="cerro_toco")
    ref_sim = maria_tpu.Simulation(maria_tpu.get_instrument(array=SMALL_ARRAY), plans=maria_tpu.Plan.generate(
        **plan_kw), site="cerro_toco", noise=True)
    sim = maria_torch.Simulation(maria_torch.get_instrument(array=SMALL_ARRAY), plans=maria_torch.Plan.generate(
        **plan_kw), site="cerro_toco", noise=True, device="cpu")
    ref_obs, obs = ref_sim.obs_list[0], sim.obs_list[0]
    assert np.array_equal(ref_obs.offsets, obs.offsets)

    def make(data, units, atmosphere):
        metadata = {"atmosphere": atmosphere, "region": "chajnantor", "pwv": ATM["zenith_pwv"],
                    "base_temperature": ATM["base_temperature"]}
        ref = maria_tpu.tod.TOD(data={"x": data}, pointing=RefPointing(ref_obs.boresight, ref_obs.offsets, ref_obs.q),
                                dets=ref_obs.instrument.dets, units=units, metadata=metadata)
        ours = maria_torch.TOD(data={"x": torch.as_tensor(data)}, dets=obs.instrument.dets, units=units,
                               pointing=Pointing(obs.boresight, obs.offsets, obs.q),
                               metadata=metadata)
        return ref, ours

    return {"make": make, "shape": obs.shape, "ref_obs": ref_obs, "obs": obs}


def tod_data(units, shape, seed=0):
    rng = np.random.default_rng(seed)
    quantity = maria_torch.units.parse_units(units)
    x = {"power": 3e-12 + 1e-13 * rng.standard_normal(shape),
         "brightness_temperature": 3.0 + 0.2 * rng.standard_normal(shape)}.get(quantity.quantity)
    if x is None:
        x = 1e-3 * rng.standard_normal(shape)
    return (x / quantity.factor).astype(np.float32)


TOD_UNITS = ["pW", "K_RJ", "uK_RJ", "uK_CMB", "K_CMB", "K_b"]


@pytest.mark.parametrize("start", ["pW", "uK_RJ", "uK_CMB", "K_b"])
@pytest.mark.parametrize("end", TOD_UNITS)
def test_tod_to_in_a_vacuum(tods, start, end):
    """TOD.to between the TOD quantities without an atmosphere, against
    maria_tpu within 1e-6 of the field's maximum (a linear chain is a
    factor a band; K_CMB <-> K_b and K_b -> W are the 1,025-point table
    interpolated on the device); a chain that raises in maria_tpu (W ->
    K_b) raises alike."""
    ref, ours = tods["make"](tod_data(start, tods["shape"]), start, atmosphere=False)
    try:
        ref_out = ref.to(end)
    except NotImplementedError:
        with pytest.raises(NotImplementedError):
            ours.to(end)
        return
    out = ours.to(end)
    assert out.units == end and out.data["x"].dtype == torch.float32
    r = np.asarray(ref_out.data["x"], dtype=np.float64)
    np.testing.assert_allclose(out.data["x"].double().numpy(), r, rtol=0, atol=1e-6 * np.abs(r).max())


def oracle_tod(tods, data, start, end):
    """The float64 conversion of ``data`` through the atmosphere, sample
    by sample at maria_tpu's float32 detector elevations: the per-band
    slope of each linear leg from the oracle above."""
    from maria_tpu.tod.tod import Pointing as RefPointing

    obs = tods["ref_obs"]
    _, el = RefPointing(obs.boresight, obs.offsets, obs.q).det_azel()
    el = np.minimum(np.asarray(el, dtype=np.float64), np.pi / 2)
    dets = obs.instrument.dets
    out = np.zeros(data.shape)
    spec = AtmosphericSpectrum("chajnantor")
    u1, u2 = (maria_torch.units.parse_units(u) for u in (start, end))
    for name in dets.bands.names:
        rows = np.where(dets.band_name == name)[0]
        band = get_band(name)
        pol = bool(~np.isnan(dets.gamma[rows]).all())
        x = data[rows].astype(np.float64) * u1.factor
        e = el[rows]
        slope = {"power": 1.0, "rayleigh_jeans_temperature": oracle_rj_kernel(band, spec, e, polarized=pol),
                 "cmb_temperature_anisotropy": oracle_dP_dT_CMB(band, spec, e, polarized=pol)}
        if u1.quantity == "brightness_temperature":
            T_lo = x.min() - 5e-5
            P_lo = oracle_band_power(T_lo, band, spec, **ATM, elevation=e, polarized=pol)
            P_hi = oracle_band_power(T_lo + 1e-4, band, spec, **ATM, elevation=e, polarized=pol)
            P = P_lo + (x - T_lo) * (P_hi - P_lo) / 1e-4
        else:
            P = x * slope[u1.quantity]
        out[rows] = P / slope[u2.quantity] if u2.quantity != "brightness_temperature" else x + T_CMB
    return out / u2.factor


@pytest.mark.parametrize("start,end", [("pW", "K_RJ"), ("pW", "uK_CMB"), ("uK_RJ", "K_CMB"), ("K_CMB", "pW"),
                                       ("mK_CMB", "uK_RJ"), ("K_b", "pW"), ("K_b", "uK_RJ"), ("K_CMB", "K_b"),
                                       ("pW", "K_b")])
def test_tod_to_through_the_atmosphere(tods, start, end):
    """TOD.to with the atmosphere's per-sample elevations: the factors and
    the non-linear chains evaluated on the TOD's device, against the
    float64 oracle at 1e-6 of the field's maximum, and against maria_tpu
    (which pulls the field to the host and interpolates in float32)
    within 5% of each sample where K_CMB is on the route (hazard 9),
    1% where K_b is (the same float32 difference, of two powers 1e-4 K
    apart: 0.18% measured), 1e-6 of the field's maximum otherwise."""
    data = tod_data(start, tods["shape"])
    ref, ours = tods["make"](data, start, atmosphere=True)
    if end == "K_b" and start == "pW":
        for tod in (ref, ours):
            with pytest.raises(NotImplementedError):
                tod.to(end)
        return
    out = ours.to(end).data["x"].double().numpy()
    if (start, end) == ("K_CMB", "K_b"):  # float32 plus T_CMB, as maria_tpu adds it
        np.testing.assert_array_equal(out, np.asarray(ref.to(end).data["x"], dtype=np.float64))
        np.testing.assert_allclose(out, data.astype(np.float64) + T_CMB, rtol=3e-7)
        return
    oracle = oracle_tod(tods, data, start, end)
    np.testing.assert_allclose(out, oracle, rtol=0, atol=1e-6 * np.abs(oracle).max())
    r = np.asarray(ref.to(end).data["x"], dtype=np.float64)
    quantities = {maria_torch.units.parse_units(u).quantity for u in (start, end)}
    if "cmb_temperature_anisotropy" in quantities:
        np.testing.assert_allclose(r, oracle, rtol=5e-2)
    elif "brightness_temperature" in quantities:
        np.testing.assert_allclose(r, oracle, rtol=1e-2)
    else:
        np.testing.assert_allclose(r, oracle, rtol=0, atol=1e-6 * np.abs(oracle).max())


@pytest.mark.parametrize("atmosphere,end", [(False, "uK_CMB"), (True, "K_RJ")])
def test_tod_to_on_an_interleaved_table(tods, atmosphere, end):
    """TOD.to on the two-band table with its rows permuted so that the
    bands alternate (the port reads each band's rows by an int64 index,
    not a slice) against maria_tpu on the same permuted table, data and
    pointing, at 1e-6 of the field's maximum, in a vacuum and through the
    atmosphere."""
    from maria_tpu.tod.tod import Pointing as RefPointing

    ref_obs, obs = tods["ref_obs"], tods["obs"]
    half = obs.instrument.dets.n // 2
    perm = np.stack([np.arange(half), half + np.arange(half)], axis=1).ravel()
    dets = obs.instrument.dets.take(perm)
    assert all(torch.is_tensor(r) for r in dets.band_rows_on("cpu"))
    metadata = {"atmosphere": atmosphere, "region": "chajnantor", "pwv": ATM["zenith_pwv"],
                "base_temperature": ATM["base_temperature"]}
    data = tod_data("pW", tods["shape"])[perm]
    ref = maria_tpu.tod.TOD(data={"x": data}, pointing=RefPointing(ref_obs.boresight, ref_obs.offsets[perm], ref_obs.q),
                            dets=ref_obs.instrument.dets.take(perm), units="pW", metadata=metadata)
    ours = maria_torch.TOD(data={"x": torch.as_tensor(data)}, dets=dets, units="pW", metadata=metadata,
                           pointing=Pointing(obs.boresight, obs.offsets[perm], obs.q))
    r = np.asarray(ref.to(end).data["x"], dtype=np.float64)
    out = ours.to(end).data["x"].double().numpy()
    np.testing.assert_allclose(out, r, rtol=0, atol=1e-6 * np.abs(r).max())


def test_tod_to_rejects_map_quantities(tods):
    _, ours = tods["make"](tod_data("pW", tods["shape"]), "pW", atmosphere=False)
    for units in ("Jy/pixel", "y", "m"):
        with pytest.raises(ValueError, match="Cannot convert TOD"):
            ours.to(units)


def test_table_interp_is_jnp_interp():
    """The device interpolation of the vacuum table (torch.searchsorted)
    against jnp.interp on float32 inputs: the held ends equal, inside
    within two float32 ulps of the table's largest value."""
    import jax.numpy as jnp

    from maria_torch.tod.tod import interp

    rng = np.random.default_rng(4)
    xp = np.sort(rng.uniform(0, 1, 200)).astype(np.float32)
    fp = rng.standard_normal(200).astype(np.float32)
    x = rng.uniform(-0.2, 1.2, 5000).astype(np.float32)
    x[:3] = xp[[0, 10, -1]]
    ours = interp(torch.as_tensor(x), torch.as_tensor(xp), torch.as_tensor(fp)).numpy()
    ref = np.asarray(jnp.interp(x, xp, fp))
    np.testing.assert_array_equal(ours[(x < xp[0]) | (x > xp[-1])], ref[(x < xp[0]) | (x > xp[-1])])
    # XLA contracts fp[i-1] + w * df into one FMA; torch rounds the product first
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2 * np.spacing(np.abs(fp).max()))


# -- Map.to ----------------------------------------------------------------------------------------------


MAP_UNITS = ["K_RJ", "uK_CMB", "Jy/pixel", "MJy/sr", "K_b", "y"]


def map_pair(kind, units, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "projection":
        data = (1e-4 * rng.standard_normal((1, 2, 1, 16, 24))).astype(np.float32)
        weight = rng.uniform(0.5, 2.0, data.shape).astype(np.float32)
        kw = dict(center=(150.0, 10.0), resolution=0.01, nu=[90e9, 150e9], units=units)
        return (maria_tpu.map.ProjectionMap(data=data.astype(np.float64), weight=weight, dtype=np.float64, **kw),
                ProjectionMap(data=data, weight=weight, **kw))
    data = (1e-4 * rng.standard_normal((3, 2, 1, 12 * 4**2))).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, data.shape).astype(np.float32)
    kw = dict(stokes="IQU", nu=[90e9, 220e9], units=units)
    return (maria_tpu.map.HEALPixMap(data=data.astype(np.float64), weight=weight, dtype=np.float64, **kw),
            HEALPixMap(data=data, weight=weight, **kw))


@pytest.mark.parametrize("kind", ["projection", "healpix"])
@pytest.mark.parametrize("start", ["K_RJ", "uK_CMB", "Jy/pixel"])
@pytest.mark.parametrize("end", MAP_UNITS)
def test_map_to_matches(kind, start, end):
    """Map.to per frequency channel with the map's nu and pixel area, data
    and weights (1/slope^2: a linear chain's factor, else the
    finite-difference slope at each pixel) against maria_tpu's at 1e-6
    relative. maria_tpu is handed float64 data (``dtype=np.float64``),
    so that both take the finite difference in float64."""
    ref, ours = map_pair(kind, start)
    ref_out, out = ref.to(end), ours.to(end)
    assert out.units == end and out.data.dtype == torch.float32 and out.shape == tuple(ref_out.shape)
    r = np.asarray(ref_out.data, dtype=np.float64)
    np.testing.assert_allclose(out.data.double().numpy(), r, rtol=1e-6, atol=1e-6 * np.abs(r).max())
    np.testing.assert_allclose(out.weight.double().numpy(), np.asarray(ref_out.weight, dtype=np.float64), rtol=1e-5)
    if end != "K_b":  # a float32 K_b map of a 1e-4 K_RJ sky keeps ~1e-6 of it
        back = out.to(start)
        np.testing.assert_allclose(back.data.double().numpy(), ours.data.double().numpy(), rtol=1e-5,
                                   atol=1e-5 * float(ours.data.abs().max()))


def test_map_to_with_a_band_and_in_power():
    """A mapper's map in pW converts to K_RJ only with a band, as the
    graph's edge needs one; the pixel area is the map's."""
    m = ProjectionMap(data=np.ones((1, 1, 1, 4, 4), np.float32), center=(0, 0), resolution=0.01, units="pW",
                      nu=[150e9])
    with pytest.raises(MissingCalibrationKwargsError, match="band"):
        m.to("K_RJ")
    band = get_band(BAND)
    factor = 1e-12 / (k_B * band.compute_transmission_integral())
    np.testing.assert_allclose(m.to("K_RJ", band=band).data.numpy(), factor, rtol=1e-6)
    assert m.pixel_area == pytest.approx(np.radians(0.01) ** 2, rel=1e-12)
    with pytest.raises(ValueError, match="Invalid map units"):
        ProjectionMap(data=np.ones((4, 4)), resolution=0.01, units="m")


# -- mappers ---------------------------------------------------------------------------------------------


@pytest.mark.parametrize("units", ["uK_RJ", "uK_CMB", "Jy/pixel"])
def test_bin_mapper_units_match(patch, units):
    """BinMapper(units=...) on the CMB patch's TOD and maria_tpu's pointing:
    a TOD quantity accumulated in its unit, Jy/pixel in K_RJ and the map
    converted; every plane and weight within 1e-5 of its maximum and 1e-5
    relative, as the K_RJ test holds them."""
    from maria_tpu.mappers import BinMapper as RefBinMapper

    from test_torch_polarized import reference_pointing

    kw = dict(patch_grid(patch["tod"]), map_postprocessing={"keep_mean": True}, units=units)
    ref_map = RefBinMapper(patch["ref_tod"], **kw).run()
    mapper = maria_torch.BinMapper(patch["tod"], **kw)
    assert mapper.tod_units == ("K_RJ" if units == "Jy/pixel" else units)
    with reference_pointing(patch["ref_sim"].obs_list[0]):
        ours = mapper.run()
    assert ours.units == ref_map.units == units
    ref_w, w = np.asarray(ref_map.weight), ours.weight.numpy()
    ref_d, d = np.nan_to_num(np.asarray(ref_map.data)), ours.data.numpy()
    for s in range(3):
        for b in range(2):
            np.testing.assert_allclose(w[s, b], ref_w[s, b], rtol=1e-5, atol=1e-5 * np.abs(ref_w[s, b]).max())
            np.testing.assert_allclose(d[s, b], ref_d[s, b], rtol=1e-5, atol=1e-5 * np.abs(ref_d[s, b]).max())


def test_bin_mapper_jy_per_beam_needs_a_beam_area(patch):
    """Jy/beam is accumulated in K_RJ and its conversion needs beam_area,
    which no mapper gives: both packages raise the same error when the
    map is made."""
    from maria_tpu.mappers import BinMapper as RefBinMapper

    kw = dict(patch_grid(patch["tod"]), units="Jy/beam")
    with pytest.raises(maria_tpu.errors.MissingCalibrationKwargsError) as ref_err:
        RefBinMapper(patch["ref_tod"], **kw).run()
    with pytest.raises(MissingCalibrationKwargsError) as err:
        maria_torch.BinMapper(patch["tod"], **kw).run()
    assert str(err.value) == str(ref_err.value)
    with pytest.raises(maria_torch.units.InvalidUnitsError):
        maria_torch.BinMapper(patch["tod"], **dict(patch_grid(patch["tod"]), units="furlongs"))


@pytest.mark.parametrize("units", ["uK_RJ", "uK_CMB", "Jy/pixel"])
def test_ml_mapper_units_match(patch, units):
    """MaximumLikelihoodMapper(units=...) on maria_tpu's blocks (its data
    converted by maria_tpu), 2 epochs x 10 CG steps: each Stokes plane
    within 1e-3 of its maximum of maria_tpu's, the weights within 1e-3
    relative, as the K_RJ fit is held."""
    ref, ours = pair(patch, units=units, n_epochs=2, n_cg_iters=10)
    assert ours.tod_units == ref.tod_units
    out_ref, out = ref.fit(), ours.fit()
    assert out.units == out_ref.units == units
    ref_d = np.nan_to_num(np.asarray(out_ref.data))
    for s in range(3):
        scale = np.abs(ref_d[s]).max()
        assert np.abs(out.data[s].numpy() - ref_d[s]).max() <= 1e-3 * scale, s
    np.testing.assert_allclose(out.weight.numpy(), np.asarray(out_ref.weight), rtol=1e-3)


# -- input skies in other units ----------------------------------------------------------------------------


def test_jy_per_pixel_input_map_through_the_map_stage(caches):
    """A cluster in Jy/pixel reaches the map stage through .to("K_RJ",
    band=band), as in maria_tpu: the map field of the scene without an
    atmosphere equals that of the same sky in K_RJ (1e-5 of its maximum)."""
    from maria_torch.sim.map import sample_maps

    sky = maria_torch.map.get("cluster", center=(150.0, 10.0))
    band = get_band("m2/f093")
    in_jy = sky.to("Jy/pixel")
    ref_sky = maria_tpu.map.get("cluster", center=(150.0, 10.0), fetch_first=False)
    np.testing.assert_allclose(in_jy.data.numpy(), np.asarray(ref_sky.to("Jy/pixel").data), rtol=1e-6)
    plan = maria_torch.Planner(target=(150.0, 10.0), site="GBT").generate_plans(
        start_time=1.75e9, horizon_days=2, total_duration=10.0, chunk_duration=10.0, scan_pattern="daisy",
        scan_options={"radius": 0.083, "speed": 0.017}, sample_rate=50)[0]
    fields = {}
    for name, m in (("K_RJ", sky), ("Jy/pixel", in_jy)):
        sim = maria_torch.Simulation("MUSTANG-2", plans=plan, site="GBT", map=m, noise=False, seed=0, device="cpu")
        fields[name] = sample_maps(sim.map, sim.obs_list[0], device="cpu").double().numpy()
    assert np.abs(fields["K_RJ"]).max() > 0 and band.name == "m2/f093"
    np.testing.assert_allclose(fields["Jy/pixel"], fields["K_RJ"], rtol=0, atol=1e-5 * np.abs(fields["K_RJ"]).max())


def test_uk_cmb_sky_through_the_cmb_stage(caches):
    """A CMB handed in in uK_CMB is converted to K_CMB (initialize_cmb),
    and its stage's field equals that of the same sky in K_CMB."""
    from maria_torch.sim.cmb import initialize_cmb

    from maria_torch.cmb import generate_cmb

    sky = generate_cmb(nside=8, seed=2, device="cpu")
    micro = initialize_cmb(sky.to("uK_CMB"), device="cpu")
    assert micro.units == "K_CMB"
    np.testing.assert_allclose(micro.data.numpy(), sky.data.numpy(), rtol=1e-6, atol=1e-12)
    rj = sky.to("K_RJ")
    back = initialize_cmb(rj, device="cpu")
    np.testing.assert_allclose(back.data.numpy(), sky.data.numpy(), rtol=1e-5, atol=1e-5 * float(sky.data.abs().max()))
