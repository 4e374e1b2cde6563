"""The rest of maria_tpu's public surface on the port, against maria_tpu
on the CPU: parsing and the io helpers, logging, the errors, the site
getters and regions, the packing and scan wrappers, plans by pattern
name, Coordinates' projection, hull and boresight, the array and
instrument front doors, the observation's and simulation's accessors,
the maps' slice axes and HDF5 files, the mapper class split with
``add_tod``, the TOD's keywords and the keywords of the atmosphere's
process and layers, the beam, the multi-process bring-up and
debug/undebug (mirroring tests/test_api_parity.py, test_features.py and
test_weather.py). Host numpy names are held exact, or at 1e-12.

The last case imports every module of the port in a fresh interpreter
with jax, maria_tpu, pandas, yaml, tqdm, h5py and matplotlib made
unimportable, as on the card's machine.
"""

import logging
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import maria_tpu  # noqa: E402
import maria_tpu.mappers  # noqa: E402
from maria_tpu.io import caching as tpu_caching  # noqa: E402

import maria_torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAN_KW = dict(start_time=1.75e9, scan_center=(150.0, 41.0), frame="az/el", duration=4.0, sample_rate=20.0,
               scan_options={"radius": 0.083, "speed": 0.017, "petals": 3.18}, site="GBT")


def rng(seed=0):
    return np.random.default_rng(seed)


# -- parsing, io and logging -------------------------------------------------------------------------


def test_parse_axes():
    """tests/test_api_parity.py::test_parse_axes on both packages, each
    with its own Quantity."""
    for pkg in (maria_tpu, maria_torch):
        from importlib import import_module

        parsing = import_module(f"{pkg.__name__}.io.parsing")
        Q = pkg.Quantity
        assert np.allclose(parsing.parse_t(Q([1, 2], "min")), [60, 120])
        assert np.allclose(parsing.parse_t([10.0, 20.0]), [10, 20])
        assert np.allclose(parsing.parse_nu(Q(90, "GHz")), [90e9])
        assert np.allclose(parsing.parse_v(Q([1.0], "km/s")), [1000.0])
        assert list(parsing.parse_stokes("IQU")) == ["I", "Q", "U"]
        assert list(parsing.parse_stokes([0, 3])) == ["I", "V"]
        with pytest.raises(ValueError):
            parsing.parse_nu(Q(1.0, "m"))
        with pytest.raises(ValueError):
            parsing.parse_stokes("IXU")
    from maria_torch.io import parsing

    from maria_tpu.io import parsing as tpu_parsing

    for f, x, tpu_x in ((parsing.parse_nu, maria_torch.Quantity([90, 150], "GHz"), maria_tpu.Quantity([90, 150], "GHz")),
                        (parsing.parse_t, [1.75e9, 1.75e9 + 1], [1.75e9, 1.75e9 + 1]),
                        (parsing.parse_v, maria_torch.Quantity(3.0, "km/s"), maria_tpu.Quantity(3.0, "km/s"))):
        np.testing.assert_array_equal(f(x), getattr(tpu_parsing, f.__name__)(tpu_x))


def test_io_helpers(tmp_path):
    import maria_tpu.io as tpu_io

    from maria_torch import io

    assert io.humanize(90, "s") == tpu_io.humanize(90, "s")
    assert io.leftpad("a\nb", n=2, char=" ") == tpu_io.leftpad("a\nb", n=2, char=" ") == "  a\n  b"
    assert io.repr_phi_theta(1.0, 0.5, "ra/dec") == tpu_io.repr_phi_theta(1.0, 0.5, "ra/dec")
    assert io.repr_lat_lon(-0.4, 1.2) == tpu_io.repr_lat_lon(-0.4, 1.2)
    assert io.humanize_time is maria_torch.utils.humanize_time
    path = tmp_path / "c.yml"
    path.write_text("a: 1\nb: [2, 3]\n")
    assert io.read_yaml(str(path)) == tpu_io.read_yaml(str(path)) == {"a": 1, "b": [2, 3]}


def test_caching_helpers(tmp_path):
    """tests/test_api_parity.py::test_caching_helpers on the port; the
    cache directory's getter and setter are io's own objects."""
    from maria_torch import io
    from maria_torch.io.caching import copy_file, get_cache_dir, set_cache_dir, test_file

    assert get_cache_dir is io.get_cache_dir and set_cache_dir is io.set_cache_dir
    src = tmp_path / "x.txt"
    src.write_text("hello")
    dst = tmp_path / "sub" / "y.txt"
    copy_file(str(src), str(dst))
    assert dst.read_text() == "hello" and test_file(str(dst))
    bad = tmp_path / "bad.h5"
    bad.write_text("not an hdf5 file")
    assert not test_file(str(bad)) and not tpu_caching.test_file(str(bad))


def test_logging(tmp_path, caplog):
    from maria_torch.io.logging import log_duration, profiler, progress_bar

    assert list(progress_bar(range(4), desc="x")) == [0, 1, 2, 3]
    with caplog.at_level(logging.DEBUG, logger="maria_torch"), log_duration("a phase"):
        pass
    assert "a phase in" in caplog.text
    with profiler(str(tmp_path / "prof")):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


def test_debug_undebug():
    logger = logging.getLogger("maria_torch")
    maria_torch.debug()
    assert logger.level == logging.DEBUG
    maria_torch.undebug()
    assert logger.level == logging.WARNING


@pytest.mark.parametrize("name, args", [
    ("PointingError", ("x",)), ("IncompatibleMapError", ("x",)), ("ConfigurationError", ("x",)),
    ("InvalidInstrumentError", ("ACT2", ["ACT"])), ("InvalidArrayError", ("a", None)),
    ("InvalidSiteError", ("mars", ["GBT"])), ("InvalidRegionError", ("mars", ["chajnantor"])),
    ("FrequencyOutOfBoundsError", (None, (2e13, 1e12))), ("NoSuitablePlansError", ()),
    ("ShapeError", ("x",)), ("IncompatibleQuantityError", ("x",)), ("MissingCalibrationKwargsError", ({"band"},)),
])
def test_errors(name, args):
    """Every error class of maria_tpu/errors: the same base and message."""
    ours, ref = getattr(maria_torch.errors, name), getattr(maria_tpu.errors, name)
    assert ours.__bases__[0].__name__ == ref.__bases__[0].__name__
    assert str(ours(*args)) == str(ref(*args))


def test_plan_errors():
    from maria_torch.plan import UnsupportedPlanError, validate_pointing_kwargs

    from maria_tpu.plan import UnsupportedPlanError as TpuError

    assert str(UnsupportedPlanError("nope")) == str(TpuError("nope"))
    with pytest.raises(UnsupportedPlanError):
        maria_torch.get_plan("nope")
    validate_pointing_kwargs({"duration": 1})
    with pytest.raises(ValueError, match="end_time"):
        validate_pointing_kwargs({})
    assert maria_torch.plan.NoSuitablePlansError is maria_torch.errors.NoSuitablePlansError


# -- sites, arrays, instruments --------------------------------------------------------------------


@pytest.mark.parametrize("name", ["GBT", "ALMA", "princeton", "chajnantor", "vla"])
def test_get_location(name):
    ours, ref = maria_torch.site.get_location(name), maria_tpu.site.get_location(name)
    assert (ours.lat_deg, ours.lon_deg, ours.height_m) == (ref.lat_deg, ref.lon_deg, ref.height_m)


def test_regions_table():
    """``REGION_COLUMNS`` holds maria_tpu's DataFrame as numpy columns."""
    from maria_torch.site.regions import REGION_COLUMNS, REGIONS, all_regions

    from maria_tpu.site.regions import REGIONS as TPU_REGIONS

    assert all_regions == list(TPU_REGIONS.index) and REGIONS is maria_torch.site.REGIONS
    np.testing.assert_array_equal(REGION_COLUMNS["name"], TPU_REGIONS.index.values)
    for col in TPU_REGIONS.columns:
        np.testing.assert_array_equal(REGION_COLUMNS[col], TPU_REGIONS[col].values, err_msg=col)


def test_site_keywords():
    site = maria_torch.Site("chajnantor", documentation="https://example.org", instruments=["ACT"])
    ref = maria_tpu.site.Site("chajnantor", documentation="https://example.org", instruments=["ACT"])
    assert site.documentation == ref.documentation and site.altitude == float(ref.altitude.m)


@pytest.mark.parametrize("name, args", [("generate_sunflower_packing", dict(n=37)),
                                        ("generate_square_packing", dict(n_row=4, n_col=5)),
                                        ("generate_triangular_packing", dict(n_col=6, n_row=3))])
def test_packings(name, args):
    """maria_tpu's DataFrames of x and y as numpy columns, on the port's packings."""
    from maria_torch.array import generation

    from maria_tpu.array import generation as tpu_generation

    ours, ref = getattr(generation, name)(**args), getattr(tpu_generation, name)(**args)
    assert list(ours) == list(ref.columns)
    for col in ours:
        np.testing.assert_array_equal(ours[col], ref[col].values)


def test_array_front_doors():
    """``Array.from_kwargs`` is from_config of the keywords; the largest
    baseline and the plot as maria_tpu's."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    kw = dict(name="a", n=19, primary_size=6.0, field_of_view=0.5, shape="hexagon", bands=["m2/f093"],
              baseline_x=[0.0, 10.0, 3.0], baseline_y=[0.0, 5.0, -4.0], baseline_z=[0.0, 1.0, 0.0])
    kw_single = {k: v for k, v in kw.items() if not k.startswith("baseline")}
    ours = maria_torch.array.Array.from_kwargs(**kw_single)
    np.testing.assert_array_equal(ours.offsets, maria_torch.array.Array.from_config(kw_single).offsets)
    np.testing.assert_array_equal(ours.offsets, maria_tpu.array.Array.from_kwargs(**kw_single).offsets)
    with_baselines = {k: v for k, v in kw.items() if k not in ("n", "field_of_view", "shape")}
    a, b = maria_torch.array.Array.from_kwargs(**with_baselines), maria_tpu.array.Array.from_kwargs(**with_baselines)
    assert a.max_baseline == b.max_baseline > 0
    ax, ref_ax = ours.plot(), maria_tpu.array.Array.from_kwargs(**kw_single).plot()
    np.testing.assert_allclose(ax.collections[0].get_offsets(), ref_ax.collections[0].get_offsets(), rtol=1e-12)
    plt.close("all")


def test_instrument_front_doors():
    ours, ref = maria_torch.get_instrument("MUSTANG-2"), maria_tpu.get_instrument("MUSTANG-2")
    assert ours.field_of_view == float(ref.field_of_view.rad)
    inst = maria_torch.instrument.Instrument(ours.arrays[0], documentation="doc")
    assert inst.documentation == "doc"


# -- plans, pointing -------------------------------------------------------------------------------


def test_scan_helpers():
    from maria_torch.plan import patterns

    from maria_tpu.plan import patterns as tpu_patterns

    t = np.linspace(0, 60, 601)
    np.testing.assert_array_equal(patterns.daisy_from_phase(t, 1.0, 0.5, 3.18, 0.1),
                                  tpu_patterns.daisy_from_phase(t, 1.0, 0.5, 3.18, 0.1))
    np.testing.assert_array_equal(patterns.smooth_sawtooth(t / 7, delta=0.05),
                                  tpu_patterns.smooth_sawtooth(t / 7, delta=0.05))
    for pattern, kw in (("daisy", {"radius": 0.5, "speed": 0.1}), ("back-and-forth", {"radius": 2.0, "speed": 0.5}),
                        ("lissajous", {"radius": 1.0})):
        np.testing.assert_array_equal(patterns.generate_scan_offsets(t, pattern, **kw),
                                      tpu_patterns.generate_scan_offsets(t, pattern, **kw))


@pytest.mark.parametrize("args, kw", [
    (("daisy",), PLAN_KW),
    (("stare",), dict(start_time=1.75e9, duration=10.0, scan_center=(30.0, 60.0), frame="az/el", site="GBT")),
    ((), dict(scan_pattern="raster", start_time=1.75e9, duration=20.0, scan_center=(150.0, 10.0), site="ALMA")),
    ((), dict(duration=5.0, start_time=1.75e9)),
    ((), dict(scan_pattern="daisy", pointing_frame="az/el", start_time=1.75e9, scan_center=(10.0, 50.0))),
], ids=["pattern-name", "stare", "no-name", "default-overridden", "pointing_frame"])
def test_get_plan_forms(args, kw):
    """``get_plan`` with a bare pattern name or none gives maria_tpu's plan."""
    ours, ref = maria_torch.get_plan(*args, **kw), maria_tpu.get_plan(*args, **kw)
    np.testing.assert_array_equal(ours.time, ref.time)
    np.testing.assert_array_equal(ours.coords._phi, ref.coords._phi)
    np.testing.assert_array_equal(ours.coords._theta, ref.coords._theta)
    assert ours.frame.name == ref.frame.name
    assert float(ours.max_vel.value) == pytest.approx(float(ref.max_vel.value), rel=1e-12)


def test_pattern_plan_is_the_registrys():
    """get_plan("daisy", ...) with daisy_5arcmin_60s's pattern options is
    the registry plan's pointing bit for bit."""
    ours = maria_torch.get_plan("daisy", **PLAN_KW)
    reg = maria_torch.get_plan("daisy_5arcmin_60s", **PLAN_KW)
    np.testing.assert_array_equal(ours.coords._phi, reg.coords._phi)
    np.testing.assert_array_equal(ours.coords._theta, reg.coords._theta)


def test_coordinates_surface():
    from maria_torch.coords import Coordinates
    from maria_torch.coords.transforms import get_center_phi_theta

    from maria_tpu.coords.coordinates import Coordinates as TpuCoordinates
    from maria_tpu.coords.transforms import get_center_phi_theta as tpu_center

    r = rng()
    t = 1.75e9 + np.arange(40) * 0.1
    phi = 1.0 + 0.01 * r.normal(size=(6, 40))
    theta = 0.8 + 0.01 * r.normal(size=(6, 40))
    ours, ref = Coordinates(phi, theta, t), TpuCoordinates(phi, theta, t)
    assert ours.ndim == ref.ndim == 2 and ours.dtype == ref.dtype == np.float64
    np.testing.assert_allclose(ours.project(1500.0), ref.project(1500.0), rtol=1e-12)
    np.testing.assert_allclose(ours.hull(frame="az/el"), ref.hull(frame="az/el"), rtol=1e-12, atol=1e-15)
    b, rb = ours.boresight(), ref.boresight()
    np.testing.assert_allclose(b.az, rb.az, rtol=1e-12)
    np.testing.assert_allclose(b.el, rb.el, rtol=1e-12)
    for keep in ((-1,), (0,), ()):
        for a, c in zip(get_center_phi_theta(phi, theta, keep_dims=keep), tpu_center(phi, theta, keep_dims=keep)):
            np.testing.assert_allclose(a, c, rtol=1e-12)
    low = Coordinates(phi, theta, t, dtype=np.float32)
    assert low.dtype == np.float32 and low._phi.dtype == np.float32
    np.testing.assert_array_equal(low._phi, TpuCoordinates(phi, theta, t, dtype=np.float32)._phi)


# -- observations and simulations ------------------------------------------------------------------


@pytest.fixture(scope="module")
def sims(tmp_path_factory):
    """A 4 s MUSTANG-2 scene with noise alone in both packages, private caches."""
    old_tpu, old_torch = tpu_caching.get_cache_dir(), maria_torch.io._cache_state["base"]
    maria_tpu.set_cache_dir(str(tmp_path_factory.mktemp("maria_tpu_cache")))
    maria_torch.set_cache_dir(str(tmp_path_factory.mktemp("maria_torch_cache")))
    try:
        kw = dict(instrument="MUSTANG-2", site="GBT", noise=True, seed=0)
        ref = maria_tpu.Simulation(plans=maria_tpu.get_plan("daisy", **PLAN_KW), **kw)
        ours = maria_torch.Simulation(plans=maria_torch.get_plan("daisy", **PLAN_KW), device="cpu", **kw)
        yield ours, ref
    finally:
        maria_tpu.set_cache_dir(old_tpu)
        maria_torch.set_cache_dir(old_torch)


def test_observation_and_simulation_accessors(sims):
    ours, ref = sims
    obs, ref_obs = ours.obs_list[0], ref.obs_list[0]
    assert obs.n_samples == ref_obs.n_samples == 217 * 80
    np.testing.assert_allclose(obs.coords.az, ref_obs.coords.az, rtol=1e-12)
    np.testing.assert_allclose(obs.coords.el, ref_obs.coords.el, rtol=1e-12)
    assert ours.min_time == ref.min_time and ours.max_time == ref.max_time


def test_run_obs_takes_the_observation(sims):
    """run_obs(obs) is run_obs of its index, on the same draws, bit for bit."""
    ours, _ = sims
    ours.generator.manual_seed(5)
    a = ours.run_obs(ours.obs_list[0])
    ours.generator.manual_seed(5)
    b = ours.run_obs(0)
    assert a.fields == b.fields
    for f in a.fields:
        assert torch.equal(a.data[f], b.data[f])


def test_add_tod_bins_both(sims):
    """A mapper made with one TOD and given a second by add_tod makes the
    map of both TODs given together, in both packages (bit for bit on the
    CPU, where the binning adds in a fixed order)."""
    ours, ref = sims
    kw = dict(center=(150.0, 41.0), width=0.3, resolution=0.3 / 32, frame="az/el")
    for mapper_class, sim in ((maria_torch.mappers.BinMapper, ours), (maria_tpu.mappers.BinMapper, ref)):
        tods = sim.run() + sim.run()
        mapper = mapper_class(tods[0], **kw)
        mapper.add_tod(tods[1])
        assert len(mapper.tods) == 2
        one = mapper.run()
        both = type(mapper)(tods, **kw).run()
        np.testing.assert_array_equal(np.asarray(one.data), np.asarray(both.data))
        np.testing.assert_array_equal(np.asarray(one.weight), np.asarray(both.weight))
    assert issubclass(maria_torch.mappers.BinMapper, maria_torch.mappers.BaseMapper)


def test_base_mapper_postprocess(sims):
    """BaseMapper alone (no geometry): Stokes, bands, time bins and the
    postprocess as maria_tpu's."""
    from maria_torch.mappers.base import BaseMapper

    from maria_tpu.mappers.base import BaseMapper as TpuBaseMapper

    ours, ref = sims
    m = BaseMapper(ours.run(), t_bins=3, map_postprocessing={"gaussian_filter": {"sigma": 1}}, progress_bars=True)
    r = TpuBaseMapper(ref.run(), t_bins=3, map_postprocessing={"gaussian_filter": {"sigma": 1}})
    assert m.stokes == r.stokes and [b.name for b in m.bands] == [b.name for b in r.bands]
    np.testing.assert_array_equal(m.t_edges, r.t_edges)
    sums = rng().normal(size=(1, 1, 3, 8, 8))
    weights = rng(1).uniform(0, 2, size=(1, 1, 3, 8, 8)) * (rng(2).uniform(size=(1, 1, 3, 8, 8)) > 0.2)
    for a, b in zip(m.postprocess(sums, weights), r.postprocess(sums, weights)):
        np.testing.assert_allclose(a, b, rtol=1e-12, equal_nan=True)


def test_tod_keywords():
    """``abscal`` is kept and, as in maria_tpu, applied to nothing;
    ``dtype`` must be float32."""
    from maria_torch.tod import TOD

    from maria_tpu.tod import TOD as TpuTOD

    x = rng().normal(size=(3, 50)).astype(np.float32)
    ours, ref = TOD(data={"noise": torch.as_tensor(x)}, abscal=2.5), TpuTOD(data={"noise": x}, abscal=2.5)
    assert ours.abscal == ref.abscal == 2.5
    np.testing.assert_array_equal(ours.signal.numpy(), np.asarray(ref.signal))
    with pytest.raises(ValueError, match="float32"):
        TOD(data={"noise": torch.as_tensor(x)}, dtype=np.float64)


# -- maps ------------------------------------------------------------------------------------------


@pytest.mark.parametrize("axis", ["t", "z", "v"])
def test_projection_map_axes(axis, tmp_path):
    """The labelled third axis, the shape properties and the channels'
    bounds as maria_tpu's; an HDF5 file of one package read by the
    other keeps the label (tests/test_features.py::test_map_zv_axes)."""
    from maria_torch.map import ProjectionMap, load

    from maria_tpu.map import load as tpu_load
    from maria_tpu.map.projection import ProjectionMap as TpuMap

    data = rng().standard_normal((1, 2, 3, 16, 16)).astype(np.float32)
    kw = dict(center=(10.0, 5.0), resolution=0.01, nu=[90e9, 150e9], **{axis: [0.1, 0.5, 1.0]})
    ours, ref = ProjectionMap(data, **kw), TpuMap(data, **kw)
    assert ours.axis3_label == ref.axis3_label == axis
    assert ours.shape == ref.shape and ours.n_stokes == ref.n_stokes and ours.n_nu == ref.n_nu
    for name in ("z", "v"):
        if name == axis:
            np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))
        else:
            with pytest.raises(AttributeError):
                getattr(ours, name)
    assert ours.nu_bin_bounds == [(float(a.Hz), float(b.Hz)) for a, b in ref.nu_bin_bounds]
    ours.to_hdf(str(tmp_path / "ours.h5"))
    ref.to_hdf(str(tmp_path / "ref.h5"))
    for loaded in (load(path=str(tmp_path / "ref.h5")), load(filename=str(tmp_path / "ours.h5"))):
        assert loaded.axis3_label == axis
        np.testing.assert_array_equal(loaded.data.numpy(), data)
        np.testing.assert_array_equal(loaded.t, ours.t)
    back = tpu_load(str(tmp_path / "ours.h5"))
    assert back.axis3_label == axis
    with pytest.raises(ValueError, match="float32"):
        ProjectionMap(data, dtype=np.float64, **kw)


@pytest.mark.parametrize("axis", ["t", "z", "v"])
def test_healpix_map_axes(axis, tmp_path, caplog):
    """HEALPixMap with z= or v= round-trips through HDF5 across the
    packages; ``resolution`` (in degrees unless told) is checked against
    nside and otherwise ignored, as maria_tpu does."""
    from maria_torch.map import load
    from maria_torch.map.healpix import HEALPixMap

    from maria_tpu.map import load as tpu_load
    from maria_tpu.map.healpix import HEALPixMap as TpuHEALPixMap

    npix = 12 * 8**2
    data = rng().standard_normal((1, 1, 2, npix)).astype(np.float32)
    kw = {axis: [0.5, 2.0]}
    ours, ref = HEALPixMap(data, **kw), TpuHEALPixMap(data, **kw)
    assert ours.axis3_label == ref.axis3_label == axis and ours.shape == ref.shape
    assert ours.weight is None and ours.resolution == ref.resolution
    ours.to_hdf(str(tmp_path / "ours.h5"))
    ref.to_hdf(str(tmp_path / "ref.h5"))
    for loaded in (load(str(tmp_path / "ref.h5")), tpu_load(str(tmp_path / "ours.h5"))):
        assert loaded.axis3_label == axis
        np.testing.assert_array_equal(np.asarray(loaded.data), data)
        np.testing.assert_array_equal(loaded.t, [0.5, 2.0])
    sub = ours._replace(data=ours.data * 2)
    assert sub.axis3_label == axis
    with caplog.at_level(logging.WARNING, logger="maria_torch"):
        HEALPixMap(data, resolution=np.degrees(ours.resolution), **kw)
        assert "differs" not in caplog.text
        HEALPixMap(data, resolution=10 * ours.resolution, degrees=False, **kw)
    assert "differs" in caplog.text
    phi = torch.as_tensor(rng().uniform(0, 2 * np.pi, 100))
    lat = torch.as_tensor(rng(1).uniform(-1.5, 1.5, 100))
    assert torch.equal(ours.pixel_index(phi, theta_lat=lat), ours.pixel_index(phi, lat))


# -- the atmosphere, the beam, the CMB tables, the mesh ------------------------------------------


def test_autoregressive_process_keywords():
    """``jitter`` starts maria_tpu's retry ladder; ``MIN_SAMPLES_PER_LAYER``
    sets the rings' least samples: the lookback and the operators as
    maria_tpu's."""
    from maria_torch.atmosphere.process import AutoregressiveProcess

    from maria_tpu.atmosphere.process import AutoregressiveProcess as TpuProcess

    cross = np.stack(np.meshgrid(np.linspace(0, 200, 9), np.linspace(0, 100, 4)), -1).reshape(-1, 2)
    ext = np.linspace(0, 300, 16)
    kw = dict(callback_kwargs={"nu": 1 / 3, "r0": 300.0}, jitter=1e-6, MIN_SAMPLES_PER_LAYER=12)
    ours, ref = AutoregressiveProcess(cross, ext, **kw), TpuProcess(cross, ext, **kw)
    np.testing.assert_array_equal(ours.cross_section_sample_index, ref.cross_section_sample_index)
    np.testing.assert_array_equal(ours.extrusion_sample_index, ref.extrusion_sample_index)
    ours.run_setup()
    ref.run_setup()
    assert ours.jitter == ref.jitter == 1e-6
    np.testing.assert_allclose(ours.A.astype(np.float32), np.asarray(ref.A), rtol=1e-6, atol=1e-7)
    default = AutoregressiveProcess(cross, ext, callback_kwargs=kw["callback_kwargs"])
    assert default.jitter == 1e-8 and len(default.cross_section_sample_index) < len(ours.cross_section_sample_index)


def test_generate_layers_keywords(sims):
    """min_res, min_res_per_beam and min_res_per_fov as maria_tpu's."""
    from maria_torch.atmosphere.layers import generate_layers
    from maria_torch.weather import Weather

    from maria_tpu.atmosphere.layers import generate_layers as tpu_layers
    from maria_tpu.weather import Weather as TpuWeather

    ours, ref = sims
    boresight = types.SimpleNamespace(el=np.radians(np.array([40.0, 45.0])))
    kw = dict(mode="2d", min_res=5.0, min_res_per_beam=0.3, min_res_per_fov=0.05)
    a = generate_layers(ours.instrument, boresight, Weather("green_bank", time=1.75e9), ours.site, **kw)
    b = tpu_layers(ref.instrument, boresight, TpuWeather("green_bank", time=1.75e9), ref.site, **kw)
    for col in ("h", "dh", "res", "z", "total_water", "pwv_rms"):
        np.testing.assert_allclose(a[col], b[col].values, rtol=1e-12, err_msg=col)
    default = generate_layers(ours.instrument, boresight, Weather("green_bank", time=1.75e9), ours.site)
    assert (default["res"] <= a["res"]).all()


def test_beam_wavelength():
    from maria_torch.beam import compute_angular_fwhm, compute_physical_fwhm

    from maria_tpu.beam import compute_angular_fwhm as tpu_angular, compute_physical_fwhm as tpu_physical

    z = np.array([1e3, 1e4, np.inf])
    np.testing.assert_allclose(compute_angular_fwhm(6.0, z=z, l=2e-3), tpu_angular(6.0, z=z, l=2e-3), rtol=1e-12)
    np.testing.assert_allclose(compute_physical_fwhm(6.0, z=z[:2], l=2e-3), tpu_physical(6.0, z=z[:2], l=2e-3),
                               rtol=1e-12)
    np.testing.assert_allclose(compute_angular_fwhm(6.0, z=z, l=2e-3),
                               compute_angular_fwhm(6.0, z=z, nu=maria_torch.constants.c / 2e-3), rtol=1e-12)
    with pytest.raises(ValueError, match="frequency"):
        compute_angular_fwhm(6.0)


def test_signal_keywords():
    from maria_torch.utils.signal import decompose, grouper

    x = torch.as_tensor(rng().normal(size=(5, 200)).astype(np.float32))
    for u, v in zip(decompose(x, k=2, mode="uv"), decompose(x, k=2)):
        assert torch.equal(u, v)
    flags = [False, True, True, True, False, True]
    assert list(grouper(flags, overlap=True)) == list(grouper(flags)) == [(1, 4), (5, 6)]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_initialize_multihost_jax_names():
    """maria_tpu's coordinator_address, num_processes and process_id bring
    up the torch world as init_method, world_size and rank do."""
    import torch.distributed as dist

    from maria_torch.parallel.multihost import initialize_multihost

    assert not dist.is_initialized()
    try:
        multi = initialize_multihost(coordinator_address=f"localhost:{free_port()}", num_processes=1, process_id=0,
                                     backend="gloo")
        assert dist.is_initialized() and dist.get_world_size() == 1 and dist.get_rank() == 0 and not multi
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# -- the card's installations ----------------------------------------------------------------------

BLOCKER = r"""
import importlib.abc, pkgutil, sys
BLOCKED = {"jax", "jaxlib", "maria_tpu", "pandas", "yaml", "tqdm", "h5py", "matplotlib"}
class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None
sys.meta_path.insert(0, Blocker())
import maria_torch
names = [m.name for m in pkgutil.walk_packages(maria_torch.__path__, "maria_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names), "modules")
"""


def test_imports_without_optional_packages():
    """Every module of maria_torch imports with jax, maria_tpu, pandas,
    yaml, tqdm, h5py and matplotlib unimportable: a module that needs one
    imports it where it is used."""
    out = subprocess.run([sys.executable, "-c", BLOCKER], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[0]) > 90


def test_reference_constant_surface():
    """tests/test_api_parity.py::test_reference_constant_surface's tables
    on the port, equal to maria_tpu's."""
    import importlib

    names = {
        "array": ["ALLOWED_ARRAY_KWARGS", "DET_COLUMN_TYPES", "PER_DET_KWARGS"], "atmosphere": ["SUPPORTED_MODELS_LIST"],
        "band": ["BAND_FIELD_FORMATS"], "calibration": ["KWARGS_UNITS"],
        "cmb": ["CMB_SOURCES", "CMB_SPECTRUM_SOURCE_URL"], "io.fits": ["FITS_DEFAULT_UNITS", "FITS_FRAMES"],
        "map": ["AXIS_MAPPING", "MAP_SIZE_KWARGS", "VALID_MAP_KWARGS"],
        "plan": ["MAX_ACCELERATION_WARN", "MIN_ELEVATION_WARN", "MIN_ELEVATION_ERROR", "PLAN_FIELDS"],
        "plan.planner": ["CONSTRAINT_KEYS", "SIDEREAL_DAY_SECONDS"], "units.units": ["QUANTITIES"],
        "utils.plotting": ["HEX_CODE_LIST"], "weather": ["WEATHER_SOURCE_BASE"],
        "constants": ["c", "g", "h", "hbar", "k_B", "T_CMB", "EARTH_RADIUS", "DRY_AIR_SPECIFIC_GAS_CONSTANT",
                      "WATER_VAPOR_SPECIFIC_GAS_CONSTANT", "MIN_NU_HZ", "MAX_NU_HZ", "MARIA_MIN_NU_HZ",
                      "MARIA_MAX_NU_HZ"],
    }
    for module, attrs in names.items():
        ours, ref = importlib.import_module(f"maria_torch.{module}"), importlib.import_module(f"maria_tpu.{module}")
        for attr in attrs:
            assert getattr(ours, attr) == getattr(ref, attr), f"{module}.{attr}"
    assert maria_torch.sim.BaseSimulation is maria_torch.Simulation
