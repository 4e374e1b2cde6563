"""The port's TOD processing and signal tools against maria_tpu, on the CPU.

Each op takes the same float32 input, made from a numpy seed, through
maria_tpu (jax on the CPU) and through the port (torch on the CPU); each
comparison states its tolerance. The chains run on the 20 s sky scene
(MUSTANG-2 on a Planner-made ra/dec daisy over ``big_cluster``): the
port's simulated signal, held by a maria_tpu TOD with maria_tpu's own
pointing of the same plan and by the port's TOD, with private caches.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import maria_torch  # noqa: E402
import maria_tpu  # noqa: E402
from maria_tpu.io import caching as tpu_caching  # noqa: E402
from maria_tpu.tod import processing as ref_proc  # noqa: E402
from maria_tpu.utils import signal as ref_sig  # noqa: E402

from maria_torch.tod import processing as proc  # noqa: E402
from maria_torch.utils import signal as sig  # noqa: E402

CENTER = (150.0, 10.0)
PLANNER_KW = dict(start_time=1.75e9, horizon_days=2, total_duration=20.0, chunk_duration=20.0, scan_pattern="daisy",
                  scan_options={"radius": 0.083, "speed": 0.017}, sample_rate=50)


def signal_like(n_det=24, n_t=1500, seed=0):
    """White noise, a shared random walk and a drift per row, float32."""
    rng = np.random.default_rng(seed)
    common = np.cumsum(rng.standard_normal(n_t)) * 0.05
    drift = np.linspace(0, 1, n_t)[None] * rng.standard_normal((n_det, 1))
    gains = 1 + 0.1 * rng.standard_normal((n_det, 1))
    return (rng.standard_normal((n_det, n_t)) + gains * common + drift + 3.0).astype(np.float32)


def close(ours, ref, tol):
    """|ours - ref| <= tol x max|ref|, everywhere."""
    ours, ref = np.asarray(ours, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert ours.shape == ref.shape
    err = np.abs(ours - ref).max() / np.abs(ref).max()
    assert err <= tol, err


def within_its_error(ours, ref, exact, scale):
    """|ours - ref| within twice maria_tpu's own distance from the float64
    ``exact``, plus 1e-6 x ``scale``, everywhere."""
    ours, ref, exact = (np.asarray(x, dtype=np.float64) for x in (ours, ref, exact))
    limit = 2 * np.abs(ref - exact).max() + 1e-6 * scale
    assert np.abs(ours - ref).max() <= limit, (np.abs(ours - ref).max(), limit)


@pytest.fixture(scope="module")
def tods(tmp_path_factory):
    """(maria_tpu TOD, port TOD) of one signal: the port's 20 s sky scene
    with the 2-D atmosphere and noise."""
    from maria_tpu.tod.tod import Pointing as RefPointing

    old_tpu, old_torch = tpu_caching.get_cache_dir(), maria_torch.io._cache_state["base"]
    maria_tpu.set_cache_dir(str(tmp_path_factory.mktemp("maria_tpu_cache")))
    maria_torch.set_cache_dir(str(tmp_path_factory.mktemp("maria_torch_cache")))
    try:
        from maria_torch.scenes import sky_simulation

        tod = sky_simulation(20.0, "cpu", atmosphere="2d", noise=True).run()[0]
        ref_map = maria_tpu.map.get("big_cluster", center=CENTER, fetch_first=False)
        ref_plan = maria_tpu.plan.Planner(target=ref_map, site="GBT").generate_plans(**PLANNER_KW)[0]
        ref_sim = maria_tpu.Simulation(instrument="MUSTANG-2", plans=ref_plan, site="GBT", atmosphere=None, seed=0)
        obs = ref_sim.obs_list[0]
        ref_tod = maria_tpu.tod.TOD(data={"signal": tod.signal.numpy()}, pointing=RefPointing(obs.boresight,
                                    obs.offsets, obs.q), dets=ref_sim.instrument.dets, units="K_RJ")
        yield ref_tod, tod
    finally:
        maria_tpu.set_cache_dir(old_tpu)
        maria_torch.set_cache_dir(old_torch)


# -- utils.signal -----------------------------------------------------------------------------


@pytest.mark.parametrize("shape,dim", [((7, 10), -1), ((6, 9), 0), ((5, 1), -1), ((217, 12), 0), ((4, 8), 0)])
def test_median_as_jax_takes_it(shape, dim):
    """The mean of the two middle values of an even count (torch.median
    takes the lower one), bit-equal to jnp.median."""
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ours = sig.median(torch.as_tensor(x), dim=dim).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jnp.median(jnp.asarray(x), axis=dim)))
    assert sig.median(torch.as_tensor(x), dim=dim, keepdim=True).shape[dim] == 1


@pytest.mark.parametrize("k", [1, 2, 3])
def test_decompose_modes_match(k):
    """maria_tpu takes a float32 host SVD, the port the float64 Gram
    matrix's eigenvectors: held by what no sign of a singular vector
    changes, a @ b (1e-5 of its maximum) and the singular values (1e-5
    relative, from the columns' norms); b is orthonormal (1e-5)."""
    data = signal_like()
    a_ref, b_ref = ref_sig.decompose(data, k=k)
    a, b = sig.decompose(torch.as_tensor(data), k=k)
    assert a.shape == (24, k) and b.shape == (k, 1500) and a.dtype == b.dtype == torch.float32
    close((a @ b).numpy(), a_ref @ b_ref, 1e-5)
    np.testing.assert_allclose(a.norm(dim=0).numpy(), np.linalg.norm(a_ref, axis=0), rtol=1e-5)
    np.testing.assert_allclose((b @ b.T).numpy(), np.eye(k), atol=1e-5)


def test_decompose_downsampled_and_rank_deficient():
    """With downsample_rate the modes come from every r-th sample and b is
    the least-squares fit to all samples (maria_tpu's lstsq); asking more
    modes than the rank gives zero modes, not NaN."""
    data = signal_like(n_det=10, n_t=900)
    a_ref, b_ref = ref_sig.decompose(data, k=2, downsample_rate=3)
    a, b = sig.decompose(torch.as_tensor(data), k=2, downsample_rate=3)
    close((a @ b).numpy(), a_ref @ b_ref, 1e-5)
    flat = np.repeat(data[:1], 4, axis=0)  # rank one
    a, b = sig.decompose(torch.as_tensor(flat), k=3)
    assert bool(torch.isfinite(b).all()) and float(a[:, 1:].abs().max()) <= 1e-3 * float(a[:, 0].abs().max())
    close((a @ b).numpy(), flat, 1e-5)


def test_host_bases_are_bit_equal():
    """The B-spline bases and fits are the same numpy and scipy code."""
    np.testing.assert_array_equal(sig.bspline_basis(1000, spacing=130), ref_sig.bspline_basis(1000, spacing=130))
    np.testing.assert_array_equal(sig.bspline_basis(500, n_knots=6, order=2), ref_sig.bspline_basis(500, n_knots=6,
                                                                                                     order=2))
    t = np.linspace(3.0, 47.0, 700)
    np.testing.assert_array_equal(sig.bspline_knots(t, 5.0), ref_sig.bspline_knots(t, 5.0))
    np.testing.assert_array_equal(sig.bspline_basis_domain(t, 5.0), ref_sig.bspline_basis_domain(t, 5.0))
    y = np.sin(t) + 0.1 * t
    np.testing.assert_array_equal(sig.fit_bspline(y, t, 4.0), ref_sig.fit_bspline(y, t, 4.0))
    X = [t, np.cos(t)]
    np.testing.assert_array_equal(sig.cross_basis(X, [10.0, 0.5], [3, 2]), ref_sig.cross_basis(X, [10.0, 0.5], [3, 2]))
    with pytest.raises(ValueError, match="spacing"):
        sig.bspline_basis(100)
    flags = [False, True, True, True, False, True, True, False, True, True, True, True, True]
    for kw in ({}, {"min_length": 3}, {"max_length": 2}):
        assert list(sig.grouper(flags, **kw)) == list(ref_sig.grouper(flags, **kw))


def test_tensor_tools_match():
    """detrend (1e-6 of the maximum; the port projects in float64,
    maria_tpu's lstsq is float64 too), the endpoint remove_slope (1e-6),
    fast_downsample within twice maria_tpu's own error (its float32 cumsum
    drifts; torch's CPU cumsum of float32 accumulates in float64)."""
    data = signal_like()
    x = torch.as_tensor(data)
    for order in (1, 3):
        close(sig.detrend(x, order=order).numpy(), ref_sig.detrend(data, order=order), 1e-6)
    close(sig.remove_slope(x).numpy(), ref_sig.remove_slope(data), 1e-6)
    exact = np.cumsum(data.astype(np.float64), axis=-1)
    for r in (1, 4, 7):
        ours = sig.fast_downsample(x, r)
        assert ours.dtype == torch.float32
        within_its_error(ours.numpy(), ref_sig.fast_downsample(data, r), (exact[..., r::r] - exact[..., :-r:r]) / r,
                         np.abs(data).max())


@pytest.mark.parametrize("kind", ["lowpass", "highpass", "bandpass", "bessel_lowpass", "bessel_highpass"])
def test_filters_match(kind):
    """The FFT filters to 1e-6 of the signal's maximum (float32 FFTs on
    both sides); the Bessel IIR filters are the same scipy call (1e-12)."""
    data = signal_like()
    if kind.startswith("bessel"):
        close(getattr(sig, kind)(data, 2.0, 50.0, order=2), getattr(ref_sig, kind)(data, 2.0, 50.0, order=2), 1e-12)
        return
    args = (0.5, 5.0) if kind == "bandpass" else (2.0,)
    ours = getattr(sig, kind)(torch.as_tensor(data), *args, 50.0, order=3)
    close(ours.numpy(), np.asarray(getattr(ref_sig, kind)(jnp.asarray(data), *args, 50.0, order=3)), 1e-6)


# -- the ops ----------------------------------------------------------------------------------


def test_despike_flags_equal():
    """Spikes, a burst and an edge spike on drifting rows: the flags
    (weights) equal, the repaired data within 1e-6 of its maximum where
    the repair's window holds a good sample. Where it holds none the port
    takes the row's mean; maria_tpu divides its prefix sums' rounding by
    1e-6 there."""
    data = signal_like(n_det=8, n_t=512)
    data[3, 100] += 200.0
    data[5, 300:303] += 150.0
    data[6, 0] -= 90.0
    weight = np.ones_like(data)
    empty_windows = 0
    for kw in ({}, {"threshold": 6.0, "window": 10, "pad": 0}, {"window": 400}):
        ref_d, ref_w = ref_proc.despike(jnp.asarray(data), jnp.asarray(weight), **kw)
        d, w = proc.despike(torch.as_tensor(data), torch.as_tensor(weight), **kw)
        np.testing.assert_array_equal(w.numpy(), np.asarray(ref_w))
        width = min(kw.get("window", 16), 512 // 4)
        good = np.stack([np.convolve(row, np.ones(width), "same") for row in (w.numpy() > 0)]) > 0.5
        empty_windows += int((~good).sum())
        ours, ref = d.numpy(), np.asarray(ref_d)
        assert np.abs(ours - ref)[good].max() <= 1e-6 * np.abs(ref).max()
        np.testing.assert_allclose(ours[~good], np.broadcast_to(data.mean(axis=-1, keepdims=True), data.shape)[~good],
                                   rtol=1e-6)
    assert empty_windows > 0
    assert w[3, 100] == 0 and bool((w[5, 298:305] == 0).all()) and float((w == 0).float().mean()) < 0.05


def test_remove_slope_window_filter_and_modes():
    """Each op on the same rows: remove_slope (1e-6 of the maximum),
    window (bit-equal: the same float64 window cast to float32), the FFT
    filter in its three forms and no band (1e-6), the Bessel filter (the
    same host scipy call, bit-equal), remove_modes (LAPACK's float32 SVD
    on both sides) within twice maria_tpu's own error against a float64
    SVD."""
    data = signal_like()
    x, w = torch.as_tensor(data), torch.ones(data.shape)
    close(proc.remove_slope(x).numpy(), ref_proc.remove_slope(jnp.asarray(data)), 1e-6)
    for kw in ({}, {"name": "hann"}, {"name": "tukey", "kwargs": {"alpha": 0.3}}):
        d, ww = proc.window(x, w, **kw)
        ref_d, ref_ww = ref_proc.window(jnp.asarray(data), jnp.ones(data.shape), **kw)
        np.testing.assert_array_equal(d.numpy(), np.asarray(ref_d))
        np.testing.assert_array_equal(ww.numpy(), np.asarray(ref_ww))
    for kw in ({"f_lower": 0.5}, {"f_upper": 3.0}, {"f_lower": 0.5, "f_upper": 3.0, "order": 2}, {}):
        close(proc.apply_filter(x, 50.0, **kw).numpy(), ref_proc.apply_filter(jnp.asarray(data), 50.0, **kw), 1e-6)
    kw = {"f_lower": 0.5, "f_upper": 3.0, "order": 2, "method": "bessel"}
    np.testing.assert_array_equal(proc.apply_filter(x, 50.0, **kw).numpy(),
                                  np.asarray(ref_proc.apply_filter(jnp.asarray(data), 50.0, **kw)))
    u, sv, vh = np.linalg.svd(data.astype(np.float64), full_matrices=False)
    for n in (0, 1, 3):
        within_its_error(proc.remove_modes(x, n=n).numpy(), ref_proc.remove_modes(jnp.asarray(data), n=n),
                         (u[:, n:] * sv[n:]) @ vh[n:], np.abs(data).max())


def spline_fit64(data, knot_spacing, order, el=None):
    """remove_spline in float64 numpy: the basis, the standardised mean
    elevation's powers, the same ridge."""
    data = np.asarray(data, dtype=np.float64)
    B = ref_sig.bspline_basis(data.shape[-1], spacing=max(int(knot_spacing * 50.0), 2))
    if order and el is not None:
        e = np.asarray(el, dtype=np.float64).mean(axis=0, keepdims=True)
        if e.std() > 0:
            e = (e - e.mean()) / e.std()
            B = np.concatenate([B, *[e**p for p in range(1, order + 1)]], axis=0)
    gram = B @ B.T
    gram += 1e-6 * np.trace(gram) / len(gram) * np.eye(len(gram))
    return data - np.linalg.solve(gram, B @ data.T).T @ B


@pytest.mark.parametrize("knot_spacing,order", [(5.0, 0), (60.0, 0), (5.0, 1), (10.0, 3)])
def test_remove_spline(knot_spacing, order):
    """The port fits in float64: within 1e-6 of the input's maximum of a
    float64 numpy fit, and within twice maria_tpu's own error (a float32
    ridge solve) of maria_tpu; with and without elevation regressors (a
    constant elevation adds none)."""
    data = signal_like()
    scale = np.abs(data).max()
    el = np.radians(60.0 + np.cumsum(np.random.default_rng(3).standard_normal(1500)) * 0.01)
    el = np.broadcast_to(el, data.shape).astype(np.float32)
    kw = dict(knot_spacing=knot_spacing, remove_el_gradient_order=order)
    exact = spline_fit64(data, knot_spacing, order, el)
    ours = proc.remove_spline(torch.as_tensor(data), 50.0, el=torch.as_tensor(el), **kw).numpy()
    assert np.abs(ours - exact).max() <= 1e-6 * scale
    within_its_error(ours, ref_proc.remove_spline(jnp.asarray(data), 50.0, el=el, **kw), exact, scale)
    flat = torch.ones(data.shape)
    ours = proc.remove_spline(torch.as_tensor(data), 50.0, el=flat, remove_el_gradient=True, knot_spacing=knot_spacing)
    assert np.abs(ours.numpy() - spline_fit64(data, knot_spacing, 0)).max() <= 1e-6 * scale


def test_config_keywords_and_aliases():
    """process_operation_kwargs and validate_process_config as maria_tpu's
    (tests/test_api_parity.py): flat aliases regroup, nested alias names
    canonicalise, values coerce, unknown names raise."""
    flat = dict(window="hann", f_upper=2.0, modes_to_remove=2, despike_threshold="7", filter_method="bessel")
    assert proc.process_operation_kwargs(**flat) == ref_proc.process_operation_kwargs(**flat)
    nested = {"remove_modes": {"modes_to_remove": "1"}, "filter": {"f_upper": "2.5"}, "remove_slope": True,
              "remove_spline": {"remove_spline_knot_spacing": 60, "remove_el_gradient": 1}}
    assert proc.validate_process_config(dict(nested)) == ref_proc.validate_process_config(dict(nested))
    assert proc.validate_process_config({"remove_modes": {"modes_to_remove": "1"}}) == {"remove_modes": {"n": 1}}
    assert proc.PROCESS_ORDER == ref_proc.PROCESS_ORDER and proc.OPERATION_KWARGS == ref_proc.OPERATION_KWARGS
    with pytest.raises(ValueError, match="Invalid kwargs"):
        proc.process_operation_kwargs(not_a_kwarg=1)
    with pytest.raises(ValueError, match="Invalid operation"):
        proc.validate_process_config({"not_an_op": {}})
    with pytest.raises(ValueError, match="Invalid param"):
        proc.validate_process_config({"filter": {"bogus": 1}})
    with pytest.raises(TypeError, match="Could not convert"):
        proc.validate_process_config({"filter": {"f_upper": "high"}})


# -- process_tod and the mappers' tod_preprocessing --------------------------------------------


# each chain with its limit against maria_tpu, as a share of the input's
# maximum (the scene's signal is ~360 K_RJ of atmosphere)
CHAINS = [
    ({"remove_slope": True}, 1e-6),
    ({"remove_slope": True, "window": {"name": "hann"}, "filter": {"f_lower": 0.2}}, 1e-6),
    ({"filter": {"f_lower": 0.2, "f_upper": 8.0, "method": "bessel"}, "remove_modes": {"n": 2}}, 1e-5),
    ({"remove_spline": {"knot_spacing": 5, "remove_el_gradient": True}, "remove_modes": {"modes_to_remove": 1}}, 1e-2),
    ({"remove_spline": {"knot_spacing": 4, "remove_el_gradient_order": 2}, "window": {"name": "tukey"}}, 1e-2),
]


@pytest.mark.parametrize("chain", range(len(CHAINS)))
def test_process_tod_chains(tods, chain):
    """TOD.process on the scene's signal: one "signal" field, weights,
    units, dets and pointing carried, the weights within 1e-6 of
    maria_tpu's, the signal within the chain's limit of the input's
    maximum: 1e-6 for float32 ops whose rounding is of the input's size,
    1e-5 with an SVD; 1e-2 with elevation regressors, where maria_tpu's
    float32 spline solve (normal matrix conditioned ~5e4) is off by up to
    6.5e-3 of the input (test_spline_and_despike_on_the_scene holds the
    port's float64 fit tightly)."""
    ref_tod, tod = tods
    config, limit = CHAINS[chain]
    ref = ref_tod.process(**{k: (dict(v) if isinstance(v, dict) else v) for k, v in config.items()})
    ours = tod.process(**{k: (dict(v) if isinstance(v, dict) else v) for k, v in config.items()})
    assert ours.fields == ["signal"] and ours.units == "K_RJ" and ours.dets is tod.dets
    assert ours.pointing is tod.pointing and ours.device.type == "cpu"
    err = np.abs(ours.signal.numpy() - np.asarray(ref.signal)).max() / float(tod.signal.abs().max())
    assert err <= limit, err
    np.testing.assert_allclose(ours.weight.numpy(), np.asarray(ref.weight), rtol=0, atol=1e-6)


def test_spline_and_despike_on_the_scene(tods):
    """remove_spline with elevation regressors on the scene: the port
    within 1e-6 of the input's maximum of a float64 fit on its own
    elevation, maria_tpu within twice its own error of it (its float32
    solve); despike's flags equal maria_tpu's and the repairs agree to
    1e-6 where the repair's window holds a good sample."""
    ref_tod, tod = tods
    data, scale = tod.signal.numpy(), float(tod.signal.abs().max())
    for ks, order in ((5.0, 1), (4.0, 2)):
        config = {"remove_spline": {"knot_spacing": ks, "remove_el_gradient_order": order}}
        exact = spline_fit64(data, ks, order, tod.el.numpy())
        ours = tod.process(**config).signal.numpy()
        assert np.abs(ours - exact).max() <= 1e-6 * scale
        within_its_error(ours, np.asarray(ref_tod.process(**config).signal), exact, scale)
    ref, ours = ref_tod.process(despike={"threshold": 8.0}), tod.process(despike={"threshold": 8.0})
    np.testing.assert_array_equal(ours.weight.numpy(), np.asarray(ref.weight))
    good = np.stack([np.convolve(row, np.ones(16), "same") for row in (ours.weight.numpy() > 0)]) > 0.5
    assert np.abs(ours.signal.numpy() - np.asarray(ref.signal))[good].max() <= 1e-6 * scale


def test_process_tod_rejects_and_converts(tods):
    _, tod = tods
    with pytest.raises(ValueError, match="Invalid processing op"):
        tod.process(smooth=True)
    processed = tod.process(remove_slope=True)
    assert processed.to("pW").units == "pW" and processed.to("pW").fields == ["signal"]
    assert tod.fs == pytest.approx(50.0) and tod.el.shape == tod.shape and tod.el.dtype == torch.float32
    np.testing.assert_allclose(tod.el.numpy(), np.asarray(tod.pointing.det_azel(device="cpu")[1]))


@pytest.mark.parametrize("preprocessing,limit", [({"remove_slope": True}, 1e-6),
                                                  ({"filter": {"f_lower": 0.2}, "remove_modes": {"n": 1}}, 1e-5)])
def test_bin_mapper_with_preprocessing(tods, preprocessing, limit):
    """BinMapper(tod_preprocessing=...) bins the processed TOD: its map
    equals the map of TOD.process(...) binned alone, and against
    maria_tpu's the hits move as in tests/test_torch_map_sim.py (0.5% may
    cross a pixel border, two float32 ra/dec tracks) and 80% of the hit
    pixels agree to the chain's limit of the input's maximum (as in
    test_process_tod_chains)."""
    from maria_tpu.mappers import BinMapper as RefBinMapper

    ref_tod, tod = tods
    kw = dict(center=CENTER, width=0.5, resolution=0.5 / 64, frame="ra/dec", map_postprocessing={"keep_mean": True})
    ref = RefBinMapper(ref_tod, tod_preprocessing=preprocessing, **kw).run()
    mapper = maria_torch.BinMapper(tod, tod_preprocessing=preprocessing, **kw)
    assert mapper.tods[0].fields == ["signal"]
    ours = mapper.run()
    alone = maria_torch.BinMapper(tod.process(**preprocessing), **kw).run()
    np.testing.assert_array_equal(ours.data.numpy(), alone.data.numpy())
    ref_w, w = np.asarray(ref.weight), ours.weight.numpy()
    assert w.sum() == ref_w.sum() == 217 * 1000 and np.abs(w - ref_w).sum() <= 5e-3 * ref_w.sum()
    ref_d, d = np.nan_to_num(np.asarray(ref.data)), ours.data.numpy()
    hit = (w > 0) & (ref_w > 0)
    assert (np.abs(d - ref_d)[hit] <= limit * float(tod.signal.abs().max())).mean() >= 0.8
