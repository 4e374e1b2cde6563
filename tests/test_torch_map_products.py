"""The port's map products against maria_tpu, on the CPU: indexing,
padding, recentring, trimming, reduction, resampling, sampling onto
another grid and the slice-dim operations (1e-6 of the map's maximum),
transfer functions (the same bins, tf to 1e-10 relative in float64), map
files read across the packages, residuals on another grid, and the
offline ``fetch``. The maps are the synthetic families, bit-equal in both
packages (``get(..., fetch_first=False)`` in maria_tpu); private cache
directories. maria_tpu's own ``fetch`` is never called: it would try a
download first."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import maria_torch  # noqa: E402
import maria_tpu  # noqa: E402

from maria_torch.convert import map_from_arrays  # noqa: E402
from maria_torch.map.transfer import compute_transfer_function  # noqa: E402

CENTER = (150.0, 10.0)


def ref_get(name, **kw):
    return maria_tpu.map.get(name, fetch_first=False, **kw)


def carried(ref):
    """The port's map of a maria_tpu map's arrays."""
    return map_from_arrays(np.asarray(ref.data), ref.center, float(ref.width.rad), float(ref.height.rad),
                           frame=ref.frame, stokes=ref.stokes, nu=ref.nu, units=ref.units,
                           weight=np.asarray(ref.weight), **{ref.axis3_label: ref.t})


def close(ours, ref, tol=1e-6):
    """|ours - ref| <= tol x max|ref| everywhere, of the same shape."""
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    assert np.abs(ours.astype(float) - ref).max() <= tol * np.abs(ref).max()


def same_map(ours, ref, tol=1e-6):
    close(ours.data, ref.data, tol)
    close(ours.weight, ref.weight, tol)
    assert ours.stokes == ref.stokes and ours.frame == ref.frame and ours.units == ref.units
    np.testing.assert_array_equal(ours.nu, ref.nu)
    np.testing.assert_array_equal(ours.t, ref.t)
    assert ours.axis3_label == ref.axis3_label
    np.testing.assert_allclose(ours.center, ref.center, rtol=1e-12)
    for q in ("width", "height", "resolution", "xi_res", "eta_res"):
        assert float(getattr(ours, q).rad) == pytest.approx(float(getattr(ref, q).rad), rel=1e-12)


@pytest.fixture(scope="module")
def maps():
    """Two channels of the cluster (64 x 64) and the IQUV source: each
    package's, bit-equal."""
    ref1 = ref_get("cluster", center=CENTER, n=64)
    ref2 = ref1._replace(nu=[270e9], data=2 * np.asarray(ref1.data))
    ours1 = maria_torch.map.get("cluster", center=CENTER, n=64)
    ours2 = ours1._replace(nu=[270e9], data=2 * ours1.data)
    pol_ref, pol = ref_get("polarized_source", n=64), maria_torch.map.get("polarized_source", n=64)
    dust_ref, dust = ref_get("dust", center=CENTER, n=64, width=0.25), maria_torch.map.get("dust", center=CENTER, n=64,
                                                                                          width=0.25)
    return {"two": (maria_tpu.map.concatenate([ref1, ref2], dim="nu"), maria_torch.map.concatenate([ours1, ours2], dim="nu")),
            "pol": (pol_ref, pol),
            "dust": (maria_tpu.map.concatenate([dust_ref, dust_ref._replace(nu=[270e9])], dim="nu"),
                     maria_torch.map.concatenate([dust, dust._replace(nu=[270e9])], dim="nu"))}


def test_concatenate_and_dims(maps):
    ref, ours = maps["two"]
    same_map(ours, ref, 0.0)
    assert ours.dims == ref.dims == {"stokes": 1, "nu": 2, "t": 1, "eta": 64, "xi": 64}
    pol_ref, pol = maps["pol"]
    assert pol.dims == pol_ref.dims
    stacked = maria_torch.map.concatenate([pol[:, :, 0], pol[:, :, 0]], dim="t")
    same_map(stacked, maria_tpu.map.concatenate([pol_ref[:, :, 0], pol_ref[:, :, 0]], dim="t"), 0.0)
    same_map(maria_torch.map.concatenate([pol[0], pol[1]], dim="stokes"),
             maria_tpu.map.concatenate([pol_ref[0], pol_ref[1]], dim="stokes"), 0.0)
    with pytest.raises(ValueError, match="labeled 'z'"):
        maria_torch.map.concatenate([ours, ours], dim="z")


@pytest.mark.parametrize("key", [(slice(None), 0), (slice(None), -1), 0, (0, slice(None), 0), (slice(None), slice(0, 1))])
def test_getitem(maps, key):
    ref, ours = maps["two"]
    same_map(ours[key], ref[key], 0.0)
    pol_ref, pol = maps["pol"]
    same_map(pol[key], pol_ref[key], 0.0)


def test_getitem_keeps_map_dims_whole(maps):
    _, ours = maps["two"]
    with pytest.raises(NotImplementedError, match="trim/reduce"):
        ours[0, 0, 0, 3]
    with pytest.raises(IndexError):
        ours[0, 0, 0, :, :, 0]


def test_squeeze_unsqueeze_parity(maps):
    ref, ours = maps["two"]
    one_ref, one = ref[:, 0], ours[:, 0]
    assert one.squeeze("nu") is one and one.squeeze("stokes") is one
    with pytest.raises(ValueError, match="Cannot squeeze"):
        ours.squeeze("nu")
    assert one.unsqueeze("nu") is one
    same_map(one.unsqueeze("nu", 90e9), one_ref.unsqueeze("nu", 90e9), 0.0)
    same_map(one.unsqueeze("z", 0.5), one_ref.unsqueeze("z", 0.5), 0.0)
    same_map(one.unsqueeze("stokes", "Q"), one_ref.unsqueeze("stokes", "Q"), 0.0)
    with pytest.raises(ValueError, match="Cannot assign"):
        ours.unsqueeze("nu", 90e9)
    with pytest.raises(ValueError, match="relabel"):
        one.unsqueeze("z", 0.5).unsqueeze("v", 1.0)
    pol_ref, pol = maps["pol"]
    for signs in ({"xi": -1}, {"eta": -1}, {"xi": -1, "eta": -1}, {}):
        flipped, flipped_ref = pol[:, :, :].apply_parity(**signs), pol_ref[:, :, :].apply_parity(**signs)
        same_map(flipped, flipped_ref, 0.0)


@pytest.mark.parametrize("factor", [1.5, 2.0, 1.3])
def test_zero_pad(maps, factor):
    pol_ref, pol = maps["pol"]
    same_map(pol.zero_pad(factor), pol_ref.zero_pad(factor), 0.0)


@pytest.mark.parametrize("center", [(150.01, 10.005), (149.98, 9.99)])
def test_recenter(maps, center):
    """The grid moved to ``center``: the bilinear gather of both packages
    at float32 offsets (1e-6 of the map's maximum)."""
    ref, ours = maps["two"]
    same_map(ours.recenter(center), ref.recenter(center))


def test_trim(maps):
    ref, _ = maps["two"]
    w = np.zeros(ref.data.shape, dtype=np.float32)
    w[..., 10:50, 5:40] = 1.0
    ref_w = ref._replace(weight=w)
    same_map(carried(ref_w).trim(), ref_w.trim(), 0.0)
    empty = carried(ref._replace(weight=0 * w))
    assert empty.trim() is empty


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_reduce(maps, factor):
    pol_ref, pol = maps["pol"]
    same_map(pol.reduce(factor), pol_ref.reduce(factor))


@pytest.mark.parametrize("kw", [dict(shape=(40, 50)), dict(shape=(128, 96)), "res"])
def test_resample(maps, kw):
    ref, ours = maps["two"]
    if kw == "res":
        kw = dict(resolution=1.7 * ours.x_res)
    same_map(ours.resample(**kw), ref.resample(**kw))


@pytest.mark.parametrize("grid", ["shifted", "finer", "same"])
def test_sampled_onto(maps, grid):
    """The map at another map's pixel centres, float32 gathers of both
    (1e-6 of the map's maximum); on the device asked for."""
    ref, ours = maps["two"]
    other_kw = {"shifted": dict(center=(150.02, 10.01), width=0.2, n=48), "finer": dict(center=CENTER, width=0.1, n=80),
                "same": dict(center=CENTER, n=64)}[grid]
    other_ref, other = ref_get("dust", **other_kw), maria_torch.map.get("dust", **other_kw)
    out = ours.sampled_onto(other)
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    close(out, ref.sampled_onto(other_ref))
    assert ours.sampled_onto(other, device="cpu").shape == (1, 2, 1, other.n_y, other.n_x)


def test_quantity_geometry(maps):
    ref, ours = maps["two"]
    assert float(ours.resolution.arcmin) == pytest.approx(float(ref.resolution.arcmin), rel=1e-12)
    assert float(ours.width.deg) == pytest.approx(0.25, rel=1e-12)
    assert ours.x_res == pytest.approx(float(ref.resolution.rad), rel=1e-12)


# -- transfer functions -----------------------------------------------------------------------
# The input is the dust family, a power law with power at every scale.
# Where an input has almost none in a bin (the cluster's steep profile
# leaves bins at ~1e-12 of its peak power), the two packages' FFT
# rounding (3e-16 of the peak, numpy's pocketfft against torch's) moves
# that bin's tf by ~1e-10 relative in either package.


def observed(ref, seed=0):
    """A maria_tpu map standing in for a mapper's output of ``ref``: the
    sky smoothed, a seeded noise added, weight zero on a border."""
    rng = np.random.default_rng(seed)
    smooth = np.asarray(ref.smooth(fwhm=maria_tpu.units.Quantity(3 * float(ref.resolution.rad), "rad")).data)
    data = (0.9 * smooth + 0.1 * np.abs(np.asarray(ref.data)).max() * rng.standard_normal(smooth.shape))
    w = np.ones(smooth.shape, dtype=np.float32)
    w[..., :4, :] = 0
    w[..., :, -6:] = 0
    return ref._replace(data=data.astype(np.float32), weight=w)


@pytest.mark.parametrize("kw", [dict(), dict(window=True), dict(window=False), dict(window="hann", n_bins=20),
                                dict(window="tukey", taper=0.1, pad_factor=2.0), dict(nu_index=1, n_bins=12)])
def test_compute_transfer_function(maps, kw):
    """The same bins and tf to 1e-10 relative (float64 both)."""
    ref_in, ours_in = maps["dust"]
    ref_out = observed(ref_in)
    ref_tf = maria_tpu.map.transfer.compute_transfer_function(ref_in, ref_out, **kw)
    tf = compute_transfer_function(ours_in, carried(ref_out), **kw)
    np.testing.assert_allclose(tf.k, ref_tf.k, rtol=1e-12)
    np.testing.assert_allclose(tf.tf, ref_tf.tf, rtol=1e-10, atol=0)
    assert np.isfinite(tf.tf).all() and len(tf.k) > 5


@pytest.mark.parametrize("kw", [dict(), dict(window=True), dict(slices=dict(nu=[0])), dict(slices=dict(nu=[1])),
                                dict(window="tukey", taper=0.1), dict(window=False, pad_factor=1.5)])
def test_map_transfer_function(maps, kw):
    """ProjectionMap.transfer_function on the same grid: bins and curves
    to 1e-10 relative, the channels' frequencies and beams carried."""
    ref_in, ours_in = maps["dust"]
    ref_out = observed(ref_in, seed=1)
    ref_out._beam_fwhm = [1e-4, 2e-4]
    ours_out = carried(ref_out)
    ours_out._beam_fwhm = [1e-4, 2e-4]
    ref_tf, tf = ref_out.transfer_function(input_map=ref_in, **kw), ours_out.transfer_function(input_map=ours_in, **kw)
    np.testing.assert_allclose(tf.k, ref_tf.k, rtol=1e-12)
    np.testing.assert_allclose(tf.T, ref_tf.T, rtol=1e-10, atol=0)
    np.testing.assert_array_equal(tf.nu, ref_tf.nu)
    assert tf.beam_fwhm == ref_tf.beam_fwhm
    assert tf(tf.k[3]) == pytest.approx(float(tf.T[0, 3]))


def test_map_transfer_function_on_another_grid(maps):
    """An input on another grid is sampled onto the output's (float32
    gathers in both packages: the curves to 1e-5 relative), in the
    output's units; without an input map it raises."""
    ref_in, ours_in = maps["dust"]
    big_ref, big = ref_get("dust", center=CENTER, n=96, width=0.3), maria_torch.map.get("dust", center=CENTER, n=96,
                                                                                        width=0.3)
    ref_out = observed(ref_in, seed=2)._replace(units="uK_RJ")
    ours_out = carried(ref_out)
    ref_tf, tf = ref_out.transfer_function(input_map=big_ref), ours_out.transfer_function(input_map=big)
    np.testing.assert_allclose(tf.k, ref_tf.k, rtol=1e-12)
    np.testing.assert_allclose(tf.T, ref_tf.T, rtol=1e-5)
    with pytest.raises(ValueError, match="No input map"):
        ours_out.transfer_function()


# -- files ------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["cluster", "polarized_source", "spectral_line_cube"])
def test_map_hdf_cross_read(tmp_path, name):
    """Each package reads the other's HDF5 map: data, weight and every
    coordinate equal."""
    pytest.importorskip("h5py")
    ref, ours = ref_get(name, n=32) if name != "spectral_line_cube" else ref_get(name), maria_torch.map.get(
        name, n=32) if name != "spectral_line_cube" else maria_torch.map.get(name)
    p_ours, p_ref = str(tmp_path / "ours.h5"), str(tmp_path / "ref.h5")
    ours.to_hdf(p_ours)
    ref.to_hdf(p_ref)
    for path in (p_ours, p_ref):
        same_map(maria_torch.map.load(path), maria_tpu.map.load(path), 0.0)
        same_map(maria_torch.map.load(path), ref, 0.0)


def test_map_fits_cross_read(tmp_path, maps):
    """Each package reads the other's FITS map (one channel: maria_tpu's
    reader takes one frequency); the port's own two-channel file reads
    back whole, element for element."""
    ref, ours = maps["two"]
    p_ours, p_ref, p_two = (str(tmp_path / f) for f in ("ours.fits", "ref.fits", "two.fits"))
    ours[:, 1].to_fits(p_ours)
    ref[:, 1].to_fits(p_ref)
    for path in (p_ours, p_ref):
        back, ref_back = maria_torch.map.load(path), maria_tpu.map.load(path)
        np.testing.assert_array_equal(back.data.numpy(), np.asarray(ref_back.data))
        np.testing.assert_array_equal(back.data.numpy(), ours[:, 1].data.numpy())
        np.testing.assert_array_equal(back.nu, ref_back.nu)
        assert back.center == pytest.approx(ref_back.center, rel=1e-12) and back.units == ref_back.units
        assert back.x_res == pytest.approx(float(ref_back.resolution.rad), rel=1e-12)
    ours.to_fits(p_two)
    two = maria_torch.map.load(filename=p_two)
    np.testing.assert_array_equal(two.data.numpy(), ours.data.numpy())
    np.testing.assert_array_equal(two.nu, ours.nu)
    resized = maria_torch.map.load(filename=p_two, nu=[90e9, 100e9], width=20 / 60, units="uK_RJ")
    assert float(resized.width.deg) == pytest.approx(20 / 60) and resized.units == "uK_RJ"
    with pytest.raises(ValueError, match="Cannot infer"):
        maria_torch.map.load(str(tmp_path / "x.npz"))


def test_healpix_to_hdf_cross_read(tmp_path):
    pytest.importorskip("h5py")
    from maria_torch.convert import healpix_map_from_arrays

    rng = np.random.default_rng(0)
    data = rng.standard_normal((3, 1, 1, 12 * 16**2)).astype(np.float32)
    ours = healpix_map_from_arrays(data, "IQU")
    path = str(tmp_path / "hp.h5")
    ours.to_hdf(path)
    for back in (maria_torch.map.load(path), maria_tpu.map.load(path)):
        np.testing.assert_array_equal(np.asarray(back.data), data)
        assert back.stokes == "IQU" and back.frame == "galactic" and back.units == "K_CMB"


# -- fetch ------------------------------------------------------------------------------------


@pytest.fixture()
def cache(tmp_path):
    old = maria_torch.io._cache_state["base"]
    maria_torch.set_cache_dir(str(tmp_path))
    yield tmp_path
    maria_torch.set_cache_dir(old)


@pytest.mark.parametrize("source", ["maps/cluster2.fits", "maps/30dor.fits", "maps/M1.h5", "maps/sun.h5"])
def test_fetch_makes_the_stand_in_offline(cache, source):
    """fetch writes the family's stand-in, as maria_tpu's generator writes
    it (read by both packages: equal arrays), through no temporary file
    left behind; a second fetch is a hit."""
    from maria_torch.io import fetch

    if source.endswith(".h5"):
        pytest.importorskip("h5py")
    path = fetch(source)
    assert path == str(cache / source) and sorted(p.name for p in (cache / "maps").iterdir()) == [source[5:]]
    ref_path = str(cache / "ref" / source[5:])
    (cache / "ref").mkdir()
    maria_tpu.map._generate_map_file(source, ref_path)
    ours, ref = maria_torch.map.load(path), maria_tpu.map.load(ref_path)
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(ours.nu, ref.nu)
    assert ours.center == pytest.approx(ref.center, rel=1e-12)
    mtime = (cache / source).stat().st_mtime_ns
    assert fetch(source) == path and (cache / source).stat().st_mtime_ns == mtime


@pytest.mark.parametrize("damage", ["empty", "truncated", "garbage"])
def test_fetch_regenerates_a_bad_cache_file(cache, damage):
    """An empty, cut or corrupt cache file is made anew, not taken as a hit."""
    from maria_torch.io import fetch

    path = fetch("maps/cluster2.fits")
    good = open(path, "rb").read()
    bad = {"empty": b"", "truncated": good[:2880 * 3], "garbage": b"\x00" * 2880 * 2}[damage]
    with open(path, "wb") as f:
        f.write(bad)
    assert fetch("maps/cluster2.fits") == path and open(path, "rb").read() == good


def test_fetch_without_a_generator_raises(cache):
    from maria_torch.io import fetch

    with pytest.raises(FileNotFoundError, match="download of https://example.org/x.fits"):
        fetch("spectra/unknown.fits", url="https://example.org/x.fits")
    with pytest.raises(FileNotFoundError, match="No synthetic family"):
        fetch("maps/andromeda.fits")
    assert not list((cache / "maps").iterdir())


def test_get_fetch_first(cache):
    """get(fetch_first=True) loads the product's file (as maria_tpu's get
    does offline), its keywords but n overriding the file's metadata."""
    m = maria_torch.map.get("cluster2", fetch_first=True)
    direct = maria_torch.map.get("cluster2")
    np.testing.assert_array_equal(m.data.numpy(), direct.data.numpy())
    assert m.center == pytest.approx(direct.center, rel=1e-12) and float((m.weight == 1).all())
    wide = maria_torch.map.get("maps/cluster2.fits", fetch_first=True, width=0.5, n=7)
    assert float(wide.width.deg) == pytest.approx(0.5) and wide.n_x == direct.n_x
    assert maria_torch.map.get("big_cluster", fetch_first=True).n_x == 512  # no product file: synthesized


# -- residuals --------------------------------------------------------------------------------


def test_compute_residual_map_on_another_grid(maps):
    """An input on another grid: sampled onto the output's pixels, the
    residual equals maria_tpu's (1e-6 of the output's maximum)."""
    ref_in, ours_in = maps["two"]
    other_ref, other = ref_get("dust", center=(150.01, 10.0), width=0.2, n=48), maria_torch.map.get(
        "dust", center=(150.01, 10.0), width=0.2, n=48)
    out_ref = observed(other_ref)
    from maria_tpu.mappers import compute_residual_map

    resid_ref = compute_residual_map(ref_in, out_ref)
    resid = maria_torch.compute_residual_map(ours_in, carried(out_ref))
    same_map(resid, resid_ref)
    assert resid.shape == (1, 1, 1, 48, 48)
    assert other.n_x == 48
