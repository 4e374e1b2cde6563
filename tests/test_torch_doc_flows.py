"""tests/test_doc_flows.py's flows of docs/tutorials.md and docs/usage.md,
shrunk the same way, on the port with ``device="cpu"``: the nebula with
the ML mapper and a residual on another grid, the transfer-function flow
(its tf held against maria_tpu's on the carried-across map and TOD), the
custom array over a fetched map, the polarized source, the mapper's
keywords, and the TOD and map products of docs/usage.md. Each Planner is
given a start time, so that both packages plan the same scan; private
cache directories."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

import maria_torch as maria  # noqa: E402
import maria_tpu  # noqa: E402
from maria_tpu.io import caching as tpu_caching  # noqa: E402

from test_torch_map_products import carried  # noqa: E402
from test_torch_products import carry  # noqa: E402

START = 1.766e9  # December 2025: M1 (ra 83.6 deg) is far from the Sun


@pytest.fixture(scope="module", autouse=True)
def caches(tmp_path_factory):
    old_tpu, old_torch = tpu_caching.get_cache_dir(), maria.io._cache_state["base"]
    maria_tpu.set_cache_dir(str(tmp_path_factory.mktemp("maria_tpu_cache")))
    maria.set_cache_dir(str(tmp_path_factory.mktemp("maria_torch_cache")))
    yield
    maria_tpu.set_cache_dir(old_tpu)
    maria.set_cache_dir(old_torch)


def nebula_map(package):
    """mustang-nebula's input: M1 at 256 x 256 in K_RJ, its low-weight
    edge zeroed."""
    input_map = package.map.get("maps/M1.h5", fetch_first=False, n=256).to("K_RJ")
    input_map.data[input_map.weight < 0.2 * input_map.weight.max()] = 0
    return input_map


@pytest.fixture(scope="module")
def nebula_tods():
    """mustang-nebula.ipynb, shrunk: M1, the Planner at Green Bank above 60
    deg, 30 s at 8 Hz, MUSTANG-2, the 2-D atmosphere."""
    input_map = nebula_map(maria)
    planner = maria.Planner(target=input_map, site="green_bank", constraints={"el": (60, 90)}, start_time=START)
    plans = planner.generate_plans(total_duration=30, sample_rate=8)
    sim = maria.Simulation(maria.get_instrument("m2/mustang-2"), plans=plans[:1], site="green_bank",
                           map=input_map, atmosphere="2d", seed=7, device="cpu")
    return input_map, sim.run()


def test_mustang_nebula_flow(nebula_tods):
    """The ML mapper at 8 input pixels a pixel, its map before and after
    fit(), and the residual against the input's first channel on the
    input's finer grid (sampled onto the output's)."""
    input_map, tods = nebula_tods
    from maria_torch.mappers import MaximumLikelihoodMapper, compute_residual_map

    mapper = MaximumLikelihoodMapper(units="K_RJ", tods=tods, resolution=8 * input_map.resolution)
    assert mapper.map.data.shape[0] >= 1
    mapper.map.plot()
    mapper.fit(epochs=1, steps_per_epoch=5)
    residual = compute_residual_map(input_map[:, 0], mapper.map)
    assert residual.shape == mapper.map.shape and bool(torch.isfinite(residual.data).all())
    assert bool((residual.data[mapper.map.weight == 0] == 0).all()) and float(residual.data.abs().max()) > 0
    residual.plot()
    plt.close("all")


BIN_KW = dict(units="uK_RJ", stokes="I", tod_preprocessing={"remove_modes": {"modes_to_remove": 1}},
              map_postprocessing={})


def test_transfer_function_flow(nebula_tods):
    """transfer-functions.ipynb, shrunk: the BinMapper's map carries the
    input map, its windowed transfer function and the tutorial's three
    windows, and the plots."""
    input_map, tods = nebula_tods
    from maria_torch.mappers import BinMapper

    output_map = BinMapper(tods=tods, resolution=8 * input_map.resolution, **BIN_KW).run()
    assert output_map._input_map is input_map and len(output_map._beam_fwhm) == 1
    tf = output_map.transfer_function(window=True)
    assert np.isfinite(tf.T).all() and tf.T.shape[0] == 1
    for kwargs in (dict(window="tukey", taper=0.1), dict(window="hann"), dict(window=False)):
        tf_w = output_map.transfer_function(slices=dict(nu=[0]), **kwargs)
        assert tf_w.T.shape[0] == 1
        tf_w.plot(add_beam=False)
    tf.plot(x_unit="arcmin")
    tf.plot(slices=dict(nu=[0]), x_unit="arcmin", add_beam=False)
    plt.close("all")


@pytest.fixture(scope="module")
def carried_flow():
    """maria_tpu's nebula TOD and input map, and the port's of their
    arrays (the map riding on the TOD's metadata, as a Simulation puts it)."""
    ref_map = nebula_map(maria_tpu)
    planner = maria_tpu.Planner(target=ref_map, site="green_bank", constraints={"el": (60, 90)}, start_time=START)
    plans = planner.generate_plans(total_duration=30, sample_rate=8)
    ref_tod = maria_tpu.Simulation(maria_tpu.get_instrument("m2/mustang-2"), plans=plans[:1], site="green_bank",
                                   map=ref_map, atmosphere="2d", seed=7).run()[0]
    tod = carry(ref_tod)
    tod.metadata["input_map"] = carried(ref_map)
    return ref_map, ref_tod, tod


@pytest.mark.parametrize("preprocessing,map_tol,tf_tol", [({"remove_modes": {"modes_to_remove": 1}}, 3e-2, 5e-2),
                                                          ({}, 5e-3, 5e-3)])
def test_transfer_function_flow_against_maria_tpu(carried_flow, preprocessing, map_tol, tf_tol):
    """The same flow in maria_tpu, its input map and TOD carried into the
    port and mapped there. The maps' hits differ where the packages'
    float32 pointing moves a sample a pixel (at most 2 a pixel); the maps'
    RMS difference is at most ``map_tol`` of maria_tpu's map's RMS and the
    transfer functions differ by at most ``tf_tol`` of their largest bin.
    The mode removal widens both: its common mode comes from maria_tpu's
    float32 SVD and the port's float64 Gram matrix (1.1% RMS and 2.0% of
    the curve measured, against 0.15% and 0.09% without it). On this
    30 s, 8 Hz scene the atmosphere dominates the map, so the curves are
    far from one: the test holds the port to maria_tpu, not to the sky."""
    from maria_tpu.mappers import BinMapper as RefBinMapper

    from maria_torch.mappers import BinMapper

    ref_map, ref_tod, tod = carried_flow
    kw = dict(units="uK_RJ", stokes="I", map_postprocessing={})
    ref_out = RefBinMapper(tods=[ref_tod], resolution=8 * ref_map.resolution,
                           tod_preprocessing=copy.deepcopy(preprocessing), **kw).run()
    out = BinMapper(tods=[tod], resolution=8 * tod.metadata["input_map"].resolution,
                    tod_preprocessing=copy.deepcopy(preprocessing), **kw).run()
    assert out.shape == tuple(ref_out.data.shape)
    assert np.abs(out.weight.numpy() - np.asarray(ref_out.weight)).max() <= 2
    ours, ref = out.data.numpy().astype(float), np.asarray(ref_out.data, dtype=float)
    assert np.sqrt(np.mean((ours - ref) ** 2)) <= map_tol * np.sqrt(np.mean(ref**2))
    for kwargs in (dict(window=True), dict(slices=dict(nu=[0]), window="tukey", taper=0.1)):
        tf, ref_tf = out.transfer_function(**kwargs), ref_out.transfer_function(**kwargs)
        np.testing.assert_allclose(tf.k, ref_tf.k, rtol=1e-12)
        assert np.abs(tf.T - ref_tf.T).max() <= tf_tol * np.abs(ref_tf.T).max()


def test_transfer_function_of_maria_tpu_maps(carried_flow):
    """The port's transfer_function of maria_tpu's own binned map and its
    input, carried across: the input is sampled onto the output's grid by
    float32 gathers in each package, so the curves agree to 1e-5 of
    their largest bin."""
    from maria_tpu.mappers import BinMapper as RefBinMapper

    ref_map, ref_tod, tod = carried_flow
    ref_out = RefBinMapper(tods=[ref_tod], resolution=8 * ref_map.resolution, units="uK_RJ", stokes="I").run()
    for kwargs in (dict(window=True), dict(window=False, pad_factor=2.0)):
        ref_tf = ref_out.transfer_function(input_map=ref_map, **kwargs)
        tf = carried(ref_out).transfer_function(input_map=tod.metadata["input_map"], **kwargs)
        np.testing.assert_allclose(tf.k, ref_tf.k, rtol=1e-12)
        assert np.abs(tf.T - ref_tf.T).max() <= 1e-5 * np.abs(ref_tf.T).max()


def test_custom_array_instrument_flow():
    """custom-map-simulations.ipynb: bands, an inline array, a site's
    altitude, and fetch of the 30dor product (made offline) loaded with
    its frequency and centre."""
    f090 = maria.Band(center=90e9, width=20e9, NET_RJ=40e-6, knee=1e0, gain_error=5e-2)
    f150 = maria.Band(center=150e9, width=30e9, NET_RJ=60e-6, knee=1e0, gain_error=5e-2)
    instrument = maria.get_instrument(
        array={"field_of_view": 0.05, "beam_spacing": 1.5, "primary_size": 50, "bands": [f090, f150]})
    assert instrument.dets.n > 2
    site = maria.get_site("llano_de_chajnantor", altitude=5065)
    assert float(site.altitude) == 5065

    from maria_torch.io import fetch

    path = fetch("maps/30dor.fits")
    input_map = maria.map.load(filename=path, nu=150e9, center=(291.156, -31.23))
    assert input_map.data.shape[-1] > 1 and list(input_map.nu) == [150e9]
    assert input_map.center == pytest.approx((np.radians(291.156), np.radians(-31.23)))


def test_polarized_observation_flow():
    """polarized-observations.ipynb, shrunk: the IQUV einstein map through
    a polarized array; Q/U reach the TOD."""
    input_map = maria.map.get("maps/einstein.h5", fetch_first=False, n=128)
    assert input_map.stokes == "IQUV"
    input_map.data *= 50
    f150 = maria.Band(center=150e9, width=30e9, NET_RJ=60e-6, knee=1e0)
    instrument = maria.get_instrument(
        array={"field_of_view": 0.1, "primary_size": 10, "n": 16, "polarized": True, "bands": [f150]})
    planner = maria.Planner(target=input_map, site="mauna_kea", constraints={"el": (45, 90)}, start_time=START)
    plans = planner.generate_plans(total_duration=20, sample_rate=16)
    sim = maria.Simulation(instrument, plans=plans[:1], site="mauna_kea", map=input_map, seed=11, device="cpu")
    tod = sim.run()[0]
    assert bool(torch.isfinite(tod.signal).all()) and tod.shape[0] == instrument.dets.n


def test_doc_mapper_kwargs(nebula_tods):
    """BinMapper(target=input_map, timestep=30, median filter): the
    target's geometry and at least one time bin."""
    input_map, tods = nebula_tods
    from maria_torch.mappers import BinMapper

    m = BinMapper(tods=tods, target=input_map, timestep=30, map_postprocessing={"median_filter": {"size": 3}}).run()
    assert m.data.shape[-2:] == input_map.data.shape[-2:] and m.data.shape[2] >= 1
    assert m.x_res == pytest.approx(input_map.x_res, rel=1e-12)
    two = BinMapper(tods=tods, target=input_map, timestep=10).run()
    assert two.data.shape[2] == 3


def test_getting_started_aliases():
    sim = maria.Simulation(instrument="apex/saboca", site="cerro_chajnantor", plans="five_second_stare", noise=True,
                           seed=1, device="cpu")
    tod = sim.run()[0]
    assert tod.signal.shape[0] == sim.instrument.dets.n


def test_usage_products(nebula_tods, tmp_path):
    """docs/usage.md's TOD and map-product lines: splits, plot, to_fits
    and tod.load; the binned map's plot and to_fits read back equal;
    compute_transfer_function and its plot."""
    input_map, tods = nebula_tods
    tod = tods[0]
    assert all(0 <= s < e <= tod.shape[-1] for s, e in tod.splits())
    tod.plot()
    tod.to_fits(str(tmp_path / "obs.fits"))
    back = maria.tod.load(str(tmp_path / "obs.fits"), device="cpu")
    np.testing.assert_array_equal(back.signal.numpy(), tod.to("K_RJ").signal.numpy())

    binned = maria.BinMapper(tods, center=tuple(np.degrees(input_map.center)), width=0.25, resolution=6e-3,
                             frame="ra/dec", units="K_RJ", tod_preprocessing={"remove_slope": True}).run()
    binned.plot()
    binned.to_fits(str(tmp_path / "map.fits"))
    np.testing.assert_array_equal(maria.map.load(str(tmp_path / "map.fits")).data.numpy(), binned.data.numpy())
    aligned = binned._replace(data=input_map.sampled_onto(binned), units=input_map.units)
    tf = maria.compute_transfer_function(aligned, binned)
    assert np.isfinite(tf.tf).all()
    tf.plot()
    plt.close("all")
