"""The port's units layer (maria_torch.units, maria_torch.errors) against
maria_tpu's, on the CPU: the cases of tests/test_units.py and of the
Quantity parts of tests/test_api_parity.py run on both packages, and
every unit string that the registries and docs/ use parses to the same
factor, dimensions, quantity name and base, and displays the same.
Host numpy on both sides: the comparisons are exact unless a test says
otherwise."""

import numpy as np
import pytest

pytest.importorskip("torch")

import maria_tpu.errors  # noqa: E402
import maria_tpu.sim.params  # noqa: E402
import maria_tpu.units as ref_units  # noqa: E402
from maria_tpu.units import units as ref_units_mod  # noqa: E402
from maria_tpu.units.quantity import lazy_nanquantile as ref_lazy_nanquantile  # noqa: E402

import maria_torch  # noqa: E402
import maria_torch.errors  # noqa: E402
import maria_torch.units as units  # noqa: E402
from maria_torch.units import units as units_mod  # noqa: E402
from maria_torch.units.quantity import lazy_nanquantile  # noqa: E402

PACKAGES = {"maria_tpu": ref_units, "maria_torch": units}

# every unit string of the registries (band NEP/NET, plan limits, map
# units), of docs/ and of docs/units.md's grammar: prefixes, powers, √,
# products and quotients, the named slash units
UNIT_STRINGS = [
    "m", "mm", "km", "cm", "s", "min", "hr", "hours", "day", "g", "kg", "K", "mK", "Kelvin", "rad", "mrad", "deg",
    "degree", "°", "arcmin", "arcsec", "'", '"', "Hz", "kHz", "MHz", "GHz", "THz", "W", "pW", "fW", "J", "sr",
    "K_RJ", "mK_RJ", "uK_RJ", "nK_RJ", "K_CMB", "mK_CMB", "uK_CMB", "K_b", "uK_b", "Jy/pixel", "mJy/pixel",
    "uJy/pixel", "Jy/beam", "mJy/beam", "MJy/sr", "Jy/sr", "y", "compton_y", "pixel", "beam",
    "W√s", "pW√s", "K√s", "K_RJ√s", "uK_RJ√s", "K_CMB√s", "uK_CMB√s", "rad/s", "deg/s", "deg/s^2",
    "deg/s**2",
    "m^2", "m**2", "m^-1", "s^0.5", "√s", "√Hz", "W/Hz", "km/s", "m s^-1", "kg m^2 s^-3", "Hz^-1", "K s",
    "sqrt_s", "W*s", "rad^2",
]
BAD_UNITS = ["furlongs_per_fortnight", "Kx", "qK_RJ_", "m^x", "√", "deg^", "Jy/parsec"]


def unit_signature(u):
    return (u.name, u.factor, u.dims, u.quantity, u.math_name, u.base)


@pytest.mark.parametrize("name", UNIT_STRINGS)
def test_unit_strings_parse_equal(name):
    ref, ours = ref_units.parse_units(name), units.parse_units(name)
    assert unit_signature(ours) == unit_signature(ref)
    assert ours.is_dimensionless == ref.is_dimensionless


@pytest.mark.parametrize("name", UNIT_STRINGS)
def test_quantity_display_and_conversion_equal(name):
    """repr, format, physical_quantity and the round trip through the
    unit's base, on a scalar and an array."""
    for value in (1.5e-3, np.array([2.0, -3.0, 4e5])):
        ref, ours = ref_units.Quantity(value, name), units.Quantity(value, name)
        assert type(ours).__name__ == type(ref).__name__
        if isinstance(ref, np.ndarray):
            np.testing.assert_array_equal(ours, ref)
            continue
        assert repr(ours) == repr(ref) and f"{ours}" == f"{ref}" and f"{ours:.5g}" == f"{ref:.5g}"
        assert ours.physical_quantity == ref.physical_quantity and ours.units == ref.units
        np.testing.assert_array_equal(ours.value, ref.value)
        base = ref.u.base
        if base is not None:
            np.testing.assert_array_equal(ours.to(base).value, ref.to(base).value)


@pytest.mark.parametrize("name", BAD_UNITS)
def test_bad_units_raise_alike(name):
    with pytest.raises(ref_units.InvalidUnitsError):
        ref_units.parse_units(name)
    with pytest.raises(units.InvalidUnitsError):
        units.parse_units(name)


def test_registry_tables_equal():
    assert units.UNITS == ref_units.UNITS
    assert units.PREFIXES == ref_units.PREFIXES
    assert units_mod.QUANTITIES == ref_units_mod.QUANTITIES
    ref_vectors = ref_units_mod.QUANTITY_DIMENSION_VECTORS
    assert sorted(units_mod.QUANTITY_DIMENSION_VECTORS) == sorted(ref_vectors.index)
    for quantity, dims in units_mod.QUANTITY_DIMENSION_VECTORS.items():
        row = {k: v for k, v in ref_vectors.loc[quantity].items() if v != 0}
        assert dims == row, quantity
    for value in (0.0, np.inf, 3e-31, 1.0, 999.0, 1e3, 2.5e14, -7e-7):
        assert units.best_prefix(value) == ref_units.best_prefix(value)


@pytest.mark.parametrize("package", PACKAGES)
def test_parse_simple(package):
    parse_units = PACKAGES[package].parse_units
    assert parse_units("m").dims == (("m", 1),)
    assert parse_units("Hz").dims == (("s", -1),)
    assert np.isclose(parse_units("GHz").factor, 1e9)
    assert np.isclose(parse_units("uK_RJ").factor, 1e-6)
    assert np.isclose(parse_units("mm").factor, 1e-3)


@pytest.mark.parametrize("package", PACKAGES)
def test_parse_compound(package):
    parse_units = PACKAGES[package].parse_units
    assert dict(parse_units("rad/s").dims) == {"rad": 1, "s": -1}
    assert dict(parse_units("W√s").dims) == {"kg": 1, "m": 2, "s": -2.5}
    assert dict(parse_units("K_RJ√s").dims) == {"K_RJ": 1, "s": 0.5}


@pytest.mark.parametrize("package", PACKAGES)
def test_named_slash_units(package):
    parse_units = PACKAGES[package].parse_units
    assert parse_units("Jy/pixel").dims == (("Jy_pixel", 1),)
    assert parse_units("Jy/beam").dims == (("Jy_beam", 1),)
    assert np.isclose(parse_units("mJy/beam").factor, 1e-3)


@pytest.mark.parametrize("package", PACKAGES)
def test_temperature_flavours_are_distinct_quantities(package):
    """K_RJ, K_CMB and K_b are different dimensions, each with the
    quantity name the calibration graph dispatches on."""
    u = PACKAGES[package]
    names = {"K_RJ": "rayleigh_jeans_temperature", "K_CMB": "cmb_temperature_anisotropy",
             "K_b": "brightness_temperature", "Jy/pixel": "spectral_flux_density_per_pixel"}
    for name, quantity in names.items():
        assert u.parse_units(name).quantity == quantity
        assert u.parse_units(f"u{name}").quantity == quantity
    for a in names:
        for b in names:
            assert u.parse_units(a).is_compatible(u.parse_units(b)) == (a == b)
    with pytest.raises(u.InvalidUnitsError):
        u.Quantity(1.0, "K_RJ").to("K_CMB")


@pytest.mark.parametrize("package", PACKAGES)
def test_quantity_conversion(package):
    Quantity = PACKAGES[package].Quantity
    q = Quantity(90e9, "Hz")
    assert np.isclose(q.GHz, 90.0)
    assert np.isclose(Quantity(1.0, "deg").rad, np.pi / 180)
    assert np.isclose(Quantity(1.0, "km").m, 1000.0)
    assert np.isclose(Quantity(2.0, "mm").to("m").value, 2e-3)
    assert np.isclose(Quantity(1.5e-3, "K_RJ").to("uK_RJ").value, 1500.0)
    assert np.isclose(Quantity(0.083, "deg").arcmin, 4.98)


@pytest.mark.parametrize("package", PACKAGES)
def test_quantity_attribute_aliases(package):
    Quantity = PACKAGES[package].Quantity
    assert np.isclose(Quantity(5.0, "m").meters, 5.0)
    assert np.isclose(Quantity(3600.0, "s").hr, 1.0)
    with pytest.raises(AttributeError):
        Quantity(1.0, "m").no_such_unit


@pytest.mark.parametrize("package", PACKAGES)
def test_dimensionless_collapse(package):
    Quantity = PACKAGES[package].Quantity
    assert isinstance(Quantity(np.ones(3), ""), np.ndarray)
    ratio = Quantity(4.0, "m") / Quantity(2.0, "m")
    assert isinstance(ratio, np.ndarray) and np.isclose(ratio, 2.0)


@pytest.mark.parametrize("package", PACKAGES)
def test_quantity_arithmetic(package):
    Quantity = PACKAGES[package].Quantity
    assert np.isclose((Quantity(1.0, "m") + Quantity(50.0, "cm")).m, 1.5)
    assert dict((Quantity(2.0, "m") * Quantity(3.0, "Hz")).u.dims) == {"m": 1, "s": -1}
    assert np.isclose((Quantity(1, "km") / Quantity(1, "s")).to("m/s").value, 1000.0)
    assert np.isclose((Quantity(3.0, "m") - Quantity(1.0, "m")).m, 2.0)
    assert np.isclose((-Quantity(3.0, "m")).m, -3.0) and np.isclose(abs(Quantity(-3.0, "m")).m, 3.0)
    assert np.isclose((Quantity(3.0, "m") ** 2).to("m^2").value, 9.0)


def test_quantity_operations_equal():
    """The same expressions on both packages give the same values, units
    and reprs."""
    def exprs(Q):
        a, b = Q(np.array([1.0, 2.0, 3.0]), "mm"), Q(2.0, "m")
        return [a + b, b - a, a * b, b / a, 2.0 / b, a**2, a.mean(), a.max(), a.min(), a.sum(), a.ptp(), a[1],
                Q(90e9, "Hz") * Q(1.0, "s"), Q(1e-17, "W√s") / Q(1.0, "√s")]

    for ref, ours in zip(exprs(ref_units.Quantity), exprs(units.Quantity)):
        if isinstance(ref, np.ndarray):
            np.testing.assert_array_equal(ours, ref)
        else:
            np.testing.assert_array_equal(ours.value, ref.value)
            assert ours.u.dims == ref.u.dims and ours.u.factor == ref.u.factor and repr(ours) == repr(ref)


@pytest.mark.parametrize("package", PACKAGES)
def test_quantity_comparison(package):
    Quantity = PACKAGES[package].Quantity
    assert Quantity(1.0, "km") > Quantity(500.0, "m")
    assert (Quantity(np.array([1.0, 3.0]), "m") > 2.0).tolist() == [False, True]
    assert Quantity(1.0, "km") == Quantity(1000.0, "m")


@pytest.mark.parametrize("package", PACKAGES)
def test_incompatible_units_raise(package):
    with pytest.raises(PACKAGES[package].InvalidUnitsError):
        PACKAGES[package].Quantity(1.0, "m").to("s")


@pytest.mark.parametrize("package", PACKAGES)
def test_angle_display(package):
    Angle = PACKAGES[package].Angle
    assert "deg" in repr(Angle(np.pi / 4, "rad"))
    assert "arcmin" in repr(Angle(np.radians(0.1), "rad"))
    assert "arcsec" in repr(Angle(np.radians(1 / 3600), "rad"))
    with pytest.raises(PACKAGES[package].InvalidUnitsError):
        Angle(1.0, "m")


def test_angle_reprs_equal():
    for value in (np.pi / 4, np.radians(0.1), np.radians(1 / 3600), np.array([0.1, 0.2])):
        assert repr(units.Angle(value, "rad")) == repr(ref_units.Angle(value, "rad"))
        assert repr(units.Angle(value, "deg")) == repr(ref_units.Angle(value, "deg"))


@pytest.mark.parametrize("package", PACKAGES)
def test_humanize(package):
    Quantity = PACKAGES[package].Quantity
    assert "GHz" in repr(Quantity(90e9, "Hz"))
    assert "mm" in repr(Quantity(2e-3, "m"))
    assert repr(Quantity(5e9, "Hz")) == "5 GHz"


def test_unit_error_alias_and_messages():
    """The exceptions keep maria_tpu's names, base classes and messages
    (the package name in InvalidUnitsError's hint aside)."""
    from maria_torch.units.units import UnitError

    assert UnitError is units.InvalidUnitsError is maria_torch.errors.InvalidUnitsError
    with pytest.raises(UnitError):
        units.Quantity(1.0, "furlongs_per_fortnight")
    for name in ("ShapeError", "MissingCalibrationKwargsError", "IncompatibleQuantityError"):
        ours, ref = getattr(maria_torch.errors, name), getattr(maria_tpu.errors, name)
        assert ours.__name__ == ref.__name__ and ours.__bases__ == ref.__bases__
    assert maria_torch.errors.MissingCalibrationKwargs is maria_torch.errors.MissingCalibrationKwargsError
    assert str(maria_torch.errors.MissingCalibrationKwargsError(["nu"])) == str(
        maria_tpu.errors.MissingCalibrationKwargsError(["nu"]))
    assert units.InvalidUnitsError.__bases__ == ref_units.InvalidUnitsError.__bases__ == (ValueError,)
    assert str(units.InvalidUnitsError("x")) == str(ref_units.InvalidUnitsError("x")).replace(
        "maria_tpu", "maria_torch")
    ours = maria_torch.errors.InvalidSimulationParameterError(["foo"])
    ref = maria_tpu.sim.params.InvalidSimulationParameterError(["foo"])
    assert str(ours) == str(ref) and type(ours).__bases__ == type(ref).__bases__


def test_repr_power_and_dim_vec():
    for fn in ("repr_power", "repr_dim_vec"):
        assert getattr(units_mod, fn).__name__ == fn
    assert units_mod.repr_power("m", 1) == "m"
    assert units_mod.repr_power("m", 0) == ""
    assert units_mod.repr_power("m", 2) == "m^2"
    assert units_mod.repr_power("m", 0.5, math=True) == "m^{1/2}"
    assert units_mod.repr_dim_vec({"m": 1, "s": -2}) == "m s^-2"
    for args in (("K", -1.5), ("s", 0.5), ("W", 3)):
        assert units_mod.repr_power(*args) == ref_units_mod.repr_power(*args)
        assert units_mod.repr_power(*args, math=True) == ref_units_mod.repr_power(*args, math=True)


def test_lazy_nanquantile():
    x = np.arange(10000, dtype=float)
    x[::7] = np.nan
    assert lazy_nanquantile(x, 0.5) == ref_lazy_nanquantile(x, 0.5)
    assert abs(lazy_nanquantile(x, 0.5) - 5000) < 200


def test_physical_quantity():
    assert units.Quantity(1.0, "hr").physical_quantity == "time"
    assert units.Quantity(1.0, "GHz").physical_quantity == "frequency"
    assert units.Quantity(1.0, "m s^-1").physical_quantity == ref_units.Quantity(1.0, "m s^-1").physical_quantity


def test_package_exports():
    assert maria_torch.Quantity is units.Quantity
    assert maria_torch.units.parse_units is units_mod.parse_units
    assert maria_torch.Calibration is maria_torch.calibration.Calibration


def test_quantities_where_maria_tpu_takes_them():
    """A Quantity goes where maria_tpu's tests pass one: smooth(Quantity(
    fwhm, "rad")) (tests/test_mappers.py:48) equals smooth(fwhm), in any
    angle unit; a mapper's width, resolution and centre as angles."""
    fwhm = np.radians(0.01)
    sky = maria_torch.map.get("cluster", center=(150.0, 10.0))
    plain = sky.smooth(fwhm, device="cpu").data
    for q in (units.Quantity(fwhm, "rad"), units.Quantity(0.6, "arcmin"), units.Angle(0.01, "deg")):
        np.testing.assert_allclose(sky.smooth(q, device="cpu").data.numpy(), plain.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(plain.abs().max()))
    from maria_torch.cmb import generate_cmb

    cmb = generate_cmb(nside=8, seed=1, device="cpu")
    np.testing.assert_array_equal(cmb.smooth(units.Quantity(0.2, "rad"), device="cpu").data.numpy(),
                                  cmb.smooth(0.2, device="cpu").data.numpy())
    sim = maria_torch.Simulation("MUSTANG-2", plans=maria_torch.get_plan(
        "daisy_5arcmin_60s", start_time=1.75e9, scan_center=(150.0, 41.0), frame="az/el", duration=2.0,
        sample_rate=20.0), site="GBT", noise=True, seed=0, device="cpu")
    tod = sim.run()[0]
    kw = dict(center=(150.0, 41.0), width=0.25, resolution=0.01, frame="az/el")
    a = maria_torch.BinMapper(tod, **kw)
    b = maria_torch.BinMapper(tod, center=(units.Quantity(150.0, "deg"), units.Quantity(41.0, "deg")),
                              width=units.Quantity(15.0, "arcmin"), resolution=units.Quantity(36.0, "arcsec"),
                              frame="az/el")
    assert (a.n_x, a.n_y) == (b.n_x, b.n_y) and a.res == pytest.approx(b.res, rel=1e-12)
    assert a.center == pytest.approx(b.center, rel=1e-12)
