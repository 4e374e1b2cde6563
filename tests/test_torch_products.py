"""The port's TOD products against maria_tpu, on the CPU: indexing,
subsets, fields, turnarounds and splits on a TOD carried across by
``convert.tod_from_arrays``, the HDF5 and MUSTANG-2 FITS files (each
package reads the other's), the cases of tests/test_tod_io.py and
tests/test_tod_signal.py on the port, and KC's split tables and a
streamed block under ``torch.inference_mode``. Every tolerance is stated
where it is used; private cache directories."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import maria_torch  # noqa: E402
import maria_tpu  # noqa: E402
from maria_tpu.io import caching as tpu_caching  # noqa: E402

from maria_torch.convert import tod_from_arrays  # noqa: E402
from maria_torch.io.fits import read_fits, write_fits, write_fits_bintable  # noqa: E402

COLUMNS = ("xi", "eta", "gamma", "band_name", "pol_label", "base_det_index", "array_name", "primary_size",
           "bath_temp", "time_constant", "baseline_x", "baseline_y", "baseline_z")


def carry(ref, boresight=None):
    """The port's TOD of a maria_tpu TOD's arrays (its boresight swapped
    for ``boresight``, a maria_tpu Coordinates, where given)."""
    b = boresight if boresight is not None else ref.pointing.boresight
    loc = b.earth_location
    return tod_from_arrays(
        {k: np.asarray(v) for k, v in ref.data.items()}, np.asarray(ref.weight), b._phi, b._theta, b.t,
        ref.pointing.offsets, ref.pointing.q, {k: ref.dets.dets[k].values for k in COLUMNS}, ref.dets.bands.names,
        frame=b.frame.name, earth_location=(loc.lat_deg, loc.lon_deg, loc.height_m), units=ref.units,
        metadata={k: v for k, v in ref.metadata.items() if k != "input_map"}, device="cpu")


def swept(ref):
    """maria_tpu's TOD with its boresight swept back and forth in
    azimuth (2.5 periods, 0.5 deg), so that it has turnarounds."""
    from maria_tpu.coords import Coordinates
    from maria_tpu.tod.tod import TOD as RefTOD, Pointing as RefPointing

    b = ref.pointing.boresight
    t = np.asarray(b.t)
    az = np.radians(180.0) + np.radians(0.5) * np.sin(2 * np.pi * 2.5 * (t - t[0]) / np.ptp(t))
    sweep = Coordinates(phi=az, theta=np.full_like(az, np.radians(60.0)), t=t, earth_location=b.earth_location,
                        frame="az/el")
    return RefTOD(data=ref.data, pointing=RefPointing(sweep, ref.pointing.offsets, ref.pointing.q), dets=ref.dets,
                  units=ref.units, metadata=ref.metadata), sweep


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """tests/test_tod_io.py's TOD (MUSTANG-2, ten_second_zenith_stare at
    Green Bank, 2-D atmosphere, noise, seed 42) and the port's TOD of its
    arrays."""
    old_tpu, old_torch = tpu_caching.get_cache_dir(), maria_torch.io._cache_state["base"]
    maria_tpu.set_cache_dir(str(tmp_path_factory.mktemp("maria_tpu_cache")))
    maria_torch.set_cache_dir(str(tmp_path_factory.mktemp("maria_torch_cache")))
    try:
        ref = maria_tpu.Simulation(instrument="MUSTANG-2", plans="ten_second_zenith_stare", site="green_bank",
                                   atmosphere="2d", noise=True, seed=42).run()[0]
        yield ref, carry(ref)
    finally:
        maria_tpu.set_cache_dir(old_tpu)
        maria_torch.set_cache_dir(old_torch)


def same_tod(ours, ref):
    """Equal fields, weights, time, pointing and detector table, element
    for element."""
    assert ours.shape == tuple(ref.shape) and ours.fields == ref.fields and ours.units == ref.units
    for k in ref.fields:
        np.testing.assert_array_equal(ours.data[k].numpy(), np.asarray(ref.data[k]))
    np.testing.assert_array_equal(ours.weight.numpy(), np.asarray(ref.weight))
    np.testing.assert_array_equal(ours.time, np.asarray(ref.time))
    np.testing.assert_array_equal(ours.pointing.offsets, ref.pointing.offsets)
    np.testing.assert_array_equal(ours.pointing.q, ref.pointing.q)
    np.testing.assert_array_equal(ours.dets.band_name, ref.dets.band_name)
    np.testing.assert_array_equal(ours.dets.offsets, ref.dets.offsets)


def test_carried_tod_and_properties(pair):
    """The carried TOD equals maria_tpu's; duration, sample_rate, azim,
    elev and the materialized coords too (coords to 1e-12 rad: one
    float64 transform each)."""
    ref, ours = pair
    same_tod(ours, ref)
    assert ours.duration == ref.duration and float(ours.sample_rate.Hz) == float(ref.sample_rate.Hz)
    np.testing.assert_array_equal(ours.azim, ref.azim)
    np.testing.assert_array_equal(ours.elev, ref.elev)
    assert ours.coords.shape == tuple(ref.coords.shape) == ours.shape
    np.testing.assert_allclose(ours.coords.az, np.asarray(ref.coords.az), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ours.coords.el, np.asarray(ref.coords.el), rtol=0, atol=1e-12)
    assert ours.pointing.coordinates().shape == ours.shape


@pytest.mark.parametrize("key", ["::2, :half", "::-1", "[0, 0, 1]", "band", "mask", "rows, times", "slice"])
def test_getitem_matches(pair, key):
    """Every index form of maria_tpu's TOD.__getitem__ cuts the same
    detectors and samples, element for element."""
    ref, ours = pair
    n_det, n_t = ours.shape
    mask = np.arange(n_det) % 3 == 1
    idx = {"::2, :half": (slice(None, None, 2), slice(None, n_t // 2)), "::-1": slice(None, None, -1),
           "[0, 0, 1]": [0, 0, 1], "band": "m2/f093", "mask": mask,
           "rows, times": (np.array([5, 2, 9]), np.array([3, 1, 100, 7])), "slice": slice(10, 40)}[key]
    same_tod(ours[idx], ref[idx])
    np.testing.assert_array_equal(ours[idx].pointing.boresight.az, np.asarray(ref[idx].pointing.boresight.az))


def test_get_field_and_subset(pair):
    ref, ours = pair
    np.testing.assert_array_equal(ours.get_field("atmosphere").numpy(), np.asarray(ref.get_field("atmosphere")))
    with pytest.raises(KeyError, match="No field"):
        ours.get_field("nope")
    mask = np.arange(ours.shape[0]) < 50
    same_tod(ours.subset(det_mask=mask, time_range=(10, 300)), ref.subset(det_mask=mask, time_range=(10, 300)))
    same_tod(ours.subset(time_range=(0, 100)), ref.subset(time_range=(0, 100)))
    assert ours.subset() is ours


@pytest.mark.parametrize("target", [None, 0.5, 2.0])
def test_turnarounds_and_splits(pair, target):
    """On an azimuth sweep, the turnarounds and every split equal
    maria_tpu's; the stare (no turnaround) gives the whole TOD in both."""
    ref, _ = pair
    ref_swept, sweep = swept(ref)
    ours = carry(ref, boresight=sweep)
    np.testing.assert_array_equal(ours.turnarounds, ref_swept.turnarounds)
    assert len(ours.turnarounds) == 5
    assert [tuple(map(int, s)) for s in ours.splits(target)] == [tuple(map(int, s)) for s in ref_swept.splits(target)]
    assert [tuple(map(int, s)) for s in carry(ref).splits(target)] == [tuple(map(int, s)) for s in ref.splits(target)]


def test_hdf_round_trip_is_exact(pair, tmp_path):
    """to_hdf then from_hdf: every field, weight, the pointing, the
    detector table and the bands bit for bit; the reloaded TOD converts
    to pW as the original does (exactly)."""
    pytest.importorskip("h5py")
    _, ours = pair
    path = str(tmp_path / "tod.h5")
    ours.to_hdf(path)
    back = maria_torch.TOD.from_hdf(path, device="cpu")
    assert back.fields == ours.fields and back.units == ours.units and back.metadata == ours.metadata
    for k in ours.fields:
        np.testing.assert_array_equal(back.data[k].numpy(), ours.data[k].numpy())
    np.testing.assert_array_equal(back.weight.numpy(), ours.weight.numpy())
    for a, b in ((back.pointing.boresight._phi, ours.pointing.boresight._phi), (back.time, ours.time),
                 (back.pointing.offsets, ours.pointing.offsets), (back.pointing.q, ours.pointing.q)):
        np.testing.assert_array_equal(a, b)
    assert back.pointing.boresight.frame.name == ours.pointing.boresight.frame.name
    assert back.pointing.boresight.earth_location == ours.pointing.boresight.earth_location
    assert back.dets.name == ours.dets.name and sorted(back.dets.dets) == sorted(ours.dets.dets)
    for k, v in ours.dets.dets.items():
        np.testing.assert_array_equal(back.dets.dets[k], v)
    assert back.dets.bands.names == ours.dets.bands.names
    assert [b.NEP for b in back.dets.bands] == [b.NEP for b in ours.dets.bands]
    np.testing.assert_array_equal(back.to("pW").signal.numpy(), ours.to("pW").signal.numpy())


def test_mustang2_fits_cross_read(pair, tmp_path):
    """Each package reads the other's MUSTANG-2 file into equal arrays;
    the written DX/DY of the two agree to 2e-6 rad (the packages'
    float32 det_radec), their FNU and TIME columns equal."""
    ref, ours = pair
    p_ours, p_ref = str(tmp_path / "ours.fits"), str(tmp_path / "ref.fits")
    ours.to_fits(p_ours)
    ref.to_fits(p_ref)
    (h_ours, t_ours), (h_ref, t_ref) = read_fits(p_ours)[1], read_fits(p_ref)[1]
    assert t_ours.dtype == t_ref.dtype and len(t_ours) == len(t_ref) == ours.shape[0] * ours.shape[1]
    for col in ("DX", "DY"):
        assert np.abs(t_ours[col].astype(float) - t_ref[col].astype(float)).max() <= 2e-6
    for col in ("FNU", "TIME", "PIXID"):
        np.testing.assert_array_equal(t_ours[col], t_ref[col])
    ra, dec = ours.pointing.det_radec(device="cpu")
    np.testing.assert_array_equal(t_ours["DX"].reshape(ours.shape), ra.numpy())
    np.testing.assert_array_equal(t_ours["DY"].reshape(ours.shape), dec.numpy())
    for key in ("NDETS", "SITELAT", "SITELONG", "SITEELEV"):
        assert h_ours[key] == h_ref[key]
    assert abs(h_ours["JDSTART"] - h_ref["JDSTART"]) < 1e-9
    for path in (p_ours, p_ref):
        back, ref_back = maria_torch.tod.load(path, device="cpu"), maria_tpu.tod.load(path)
        np.testing.assert_array_equal(back.signal.numpy(), np.asarray(ref_back.signal))
        np.testing.assert_array_equal(back.signal.numpy(), ours.signal.numpy())
        np.testing.assert_array_equal(back.time, ref_back.time)
        np.testing.assert_array_equal(back.pointing.offsets, ref_back.pointing.offsets)
        np.testing.assert_array_equal(back.pointing.boresight.ra, np.asarray(ref_back.pointing.boresight.ra))
        np.testing.assert_array_equal(back.dets.band_name, ref_back.dets.band_name)
        assert back.metadata == {k: v for k, v in ref_back.metadata.items()}
    with pytest.raises(ValueError, match="Unsupported TOD format"):
        ours.to_fits(p_ours, format="ACT")


# -- tests/test_tod_io.py's cases on the port --------------------------------------------------


def test_fits_image_roundtrip(tmp_path):
    p = str(tmp_path / "img.fits")
    data = np.arange(48, dtype=np.float32).reshape(6, 8)
    write_fits(p, [("TESTKEY", 3.5)], data)
    header, back = read_fits(p)[0]
    np.testing.assert_array_equal(back, data)
    assert header["TESTKEY"] == 3.5


def test_fits_bintable_roundtrip(tmp_path):
    p = str(tmp_path / "table.fits")
    x = np.linspace(0, 1, 100).astype(np.float32)
    ids = np.arange(100, dtype=np.int16)
    write_fits_bintable(p, columns=[("X    ", "E", x, "m"), ("ID   ", "I", ids, "")], header_cards=[("FOO", 42)])
    header, rec = read_fits(p)[1]
    assert header["FOO"] == 42
    np.testing.assert_array_equal(rec["X"], x)
    np.testing.assert_array_equal(rec["ID"], ids)


def test_tod_fits_roundtrip(tmp_path, pair):
    _, tod = pair
    p = str(tmp_path / "tod.fits")
    tod.to_fits(p)
    back = maria_torch.TOD.from_fits(p, device="cpu")
    assert back.shape == tod.shape and back.dets.n == tod.dets.n
    np.testing.assert_allclose(back.signal.numpy(), tod.signal.numpy(), rtol=1e-5)
    np.testing.assert_allclose(back.time, tod.time, atol=1e-2)


def test_tod_splits(pair):
    _, tod = pair
    splits = tod.splits(target_split_time=2.0)
    assert len(splits) >= 1
    for s, e in splits:
        assert 0 <= s < e <= tod.shape[-1]


def test_tod_2d_slicing_and_get_field(pair):
    _, tod = pair
    n_det, n_t = tod.shape
    sub = tod[::2, : n_t // 2]
    assert sub.shape == ((n_det + 1) // 2, n_t // 2) and len(sub.pointing.t) == n_t // 2
    np.testing.assert_array_equal(sub.signal.numpy(), tod.signal.numpy()[::2, : n_t // 2])
    np.testing.assert_array_equal(sub.time, tod.time[: n_t // 2])
    assert tuple(tod.get_field("atmosphere").shape) == (n_det, n_t)
    with pytest.raises(KeyError):
        tod.get_field("nope")


def test_tod_fancy_indexing_keeps_dets_aligned(pair):
    _, tod = pair
    rev = tod[::-1]
    np.testing.assert_array_equal(rev.signal.numpy(), tod.signal.numpy()[::-1])
    np.testing.assert_array_equal(rev.dets.offsets, tod.dets.offsets[::-1])
    dup = tod[[0, 0, 1]]
    assert dup.shape[0] == 3 and dup.dets.n == 3
    np.testing.assert_array_equal(dup.dets.offsets[0], dup.dets.offsets[1])


def test_tod_subset_time_range_slices_pointing(pair):
    _, tod = pair
    sub = tod.subset(time_range=(0, 100))
    assert sub.shape[-1] == 100 and len(sub.pointing.t) == 100
    np.testing.assert_array_equal(sub.time, tod.time[:100])


# -- tests/test_tod_signal.py's cases on the port, each equal to maria_tpu's ---------------------


def test_signal_tools_equal_maria_tpu():
    """The port's numpy tools give maria_tpu's arrays exactly, on the same
    seeded inputs, and pass tests/test_tod_signal.py's checks."""
    from maria_tpu.tod import signal as ref_sig

    from maria_torch.tod import signal as sig

    rng = np.random.default_rng(0)
    x = rng.uniform(0, 10, 5000)
    y = 2 * x + rng.normal(0, 0.01, 5000)
    y[::97] = np.nan
    bins = np.linspace(0, 10, 11)
    m = sig.weighted_binned_mean(x, y, bins)
    np.testing.assert_array_equal(m, ref_sig.weighted_binned_mean(x, y, bins))
    assert np.allclose(m, bins[:-1] + bins[1:], atol=0.05)

    k = sig.get_kernel(5)
    np.testing.assert_array_equal(k, ref_sig.get_kernel(5))
    assert len(k) == 9 and np.isclose(k.sum(), 1.0) and np.argmax(k) == 4

    sweep = np.angle(np.exp(1j * np.linspace(np.pi - 0.3, np.pi + 0.3, 100)))
    un = sig.unwrap_angle(sweep)
    np.testing.assert_array_equal(un, ref_sig.unwrap_angle(sweep))
    assert np.abs(np.diff(un)).max() < 0.05

    for method in ("flat", "triangle"):
        data = 3.0 + rng.normal(0, 1, (4, 1000))
        out = sig.downsample(data, rate=5, method=method)
        np.testing.assert_array_equal(out, ref_sig.downsample(data, rate=5, method=method))
        assert 150 < out.shape[1] <= 200 and np.allclose(out.mean(), 3.0, atol=0.05)

    phase = (2 * np.pi * 0.011 * np.arange(2000)) % (2 * np.pi)
    data = np.outer(rng.uniform(0.5, 2.0, 8), np.cos(phase)) + rng.normal(0, 0.05, (8, 2000))
    template = sig.get_phase_template(data, phase, n_phase_bins=32)
    np.testing.assert_array_equal(template, ref_sig.get_phase_template(data, phase, n_phase_bins=32))
    assert (data - template).std() < 0.3 * data.std()

    mask = np.zeros(20, dtype=bool)
    mask[3:6], mask[7:9], mask[15] = True, True, True
    assert sig.contiguous_runs(mask, tol=1) == ref_sig.contiguous_runs(mask, tol=1) == [(3, 8), (15, 15)]
    assert sig.contiguous_runs(np.zeros(5, dtype=bool)) == []

    walk = np.cumsum(rng.normal(0, 1e-3, (3, 4000)), axis=1)
    walk[1, 2000:2012] += 50.0
    cuts = sig.make_cuts(walk)
    assert cuts == ref_sig.make_cuts(walk) and len(cuts[1]) >= 1
    s, e = cuts[1][0]
    assert s < 2012 and e > 2000
    for method in ("splice", "flatten"):
        fixed = sig.apply_cuts(walk, cuts, method=method)
        np.testing.assert_array_equal(fixed, ref_sig.apply_cuts(walk, cuts, method=method))
        assert np.isfinite(fixed[1]).all() and np.nanmax(np.abs(fixed[1])) < 10.0


def test_field_offset_factorization():
    from maria_torch.tod import Field

    raw = 150.0 + 1e-4 * np.random.default_rng(0).normal(0, 1, (4, 256))
    f = Field(raw)
    assert f.residual.dtype == np.float32 and f.offset.dtype == np.float64
    np.testing.assert_allclose(f.data, raw, rtol=0, atol=1e-9)
    np.testing.assert_allclose(f[1:3].data, raw[1:3], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(f.residual, maria_tpu.tod.Field(raw).residual)


# -- F1: KC's split tables and a streamed block under inference_mode ------------------------------


def test_split_tables_under_inference_mode():
    """Tensors made under inference_mode have no version counter: the
    tables are keyed by value there, and equal those of ordinary tensors."""
    from maria_torch.ops.pink_cascade import split_tables

    rng = np.random.default_rng(3)
    p_np, a_np = rng.uniform(0.5, 0.99, (2, 13)).astype(np.float32), rng.standard_normal((2, 13)).astype(np.float32)
    with torch.inference_mode():
        p, a = torch.as_tensor(p_np), torch.as_tensor(a_np)
        assert p.is_inference()
        inside = split_tables(p, a, 5, "cpu")
        again = split_tables(torch.as_tensor(p_np), torch.as_tensor(a_np), 5, "cpu")
    outside = split_tables(torch.as_tensor(p_np), torch.as_tensor(a_np), 5, "cpu")
    assert inside is again
    np.testing.assert_array_equal(inside.numpy(), outside.numpy())


def test_streamed_block_under_inference_mode(tmp_path):
    """A streamed block of tests/test_streaming_ml.py's scene (the
    streamed ML slice's), with a fresh cascade inside inference_mode,
    equals the same block outside it bit for bit."""
    from maria_torch.map import ProjectionMap
    from maria_torch.noise import streaming as noise_streaming
    from maria_torch.ops.program import build_tod_program
    from maria_torch.ops.streaming_exec import StreamingExecutor

    old = maria_torch.io._cache_state["base"]
    maria_torch.set_cache_dir(str(tmp_path))
    try:
        plan = maria_torch.get_plan("daisy_5arcmin_60s", start_time=1.75e9, scan_center=(150.0, 41.0),
                                    frame="az/el", duration=30.0, sample_rate=20.0)
        sim = maria_torch.Simulation(instrument="MUSTANG-2", plans=plan, site="GBT", atmosphere="2d", noise=True,
                                     seed=11, device="cpu")
        program = build_tod_program(sim.obs_list[0], noise_kwargs=sim.noise_kwargs, device="cpu")
        n = 48
        yy, xx = np.mgrid[:n, :n]
        blob = np.exp(-((xx - n / 2) ** 2 + (yy - n / 2) ** 2) / (2 * (n / 8) ** 2))
        sky = ProjectionMap(data=(2e-3 * blob).astype(np.float32)[None, None, None], center=(150.0, 41.0),
                            width=0.2, frame="az/el", units="K_RJ", degrees=True)

        def block(index):
            ex = StreamingExecutor(program, sim.obs_list[0], block_tc=16, n_x=n, n_y=n, res=np.radians(0.2) / n,
                                   input_map=sky, device="cpu")
            state = ex.init_state(0)
            return ex.block(state, index)

        noise_streaming._fit_cascade.cache_clear()
        outside = block(1)
        noise_streaming._fit_cascade.cache_clear()
        with torch.inference_mode():
            inside = block(1)
    finally:
        maria_torch.set_cache_dir(old)
    flat_out, flat_in = torch.utils._pytree.tree_flatten(outside)[0], torch.utils._pytree.tree_flatten(inside)[0]
    tensors = [(a, b) for a, b in zip(flat_out, flat_in) if isinstance(a, torch.Tensor)]
    assert tensors and len(flat_out) == len(flat_in)
    for a, b in tensors:
        assert torch.equal(a, b)
