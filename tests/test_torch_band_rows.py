"""A band's detector rows, decided in one place (``maria_torch/array/rows.py``):
``band_rows`` against ``np.where`` on the instruments the port runs,
``device_rows``' slice-or-index choice, ``Array.band_rows_on``'s cache,
and the index path that no named instrument takes.

Every named instrument's table is sorted by band, so its bands are
contiguous and the port reads them as slices. A table whose bands
interleave takes the int64 index instead. The equivalence tests permute a
small two-band scene's detectors so that the bands alternate row by row,
each band keeping its own order, and hold every band stage on that table
to the row permutation of the same stage on the sorted one: the program's
fields with every draw handed in, the vacuum noise, ``TOD.to`` and
BinMapper's map. No JAX here: the port is held against itself, and the
sorted two-band table against maria_tpu elsewhere
(``tests/test_torch_polarized.py``: the program's CMB and map fields,
the noise, ``TOD.to``'s polarized factor and BinMapper's IQU map on a
sorted two-band polarized array). The interleaved table goes through
maria_tpu itself in ``tests/test_torch_calibration.py::
test_tod_to_on_an_interleaved_table``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import maria_torch  # noqa: E402
from maria_torch.array import Array  # noqa: E402
from maria_torch.array.rows import band_rows, device_rows  # noqa: E402
from maria_torch.atmosphere.fourier import good_fft_size  # noqa: E402
from maria_torch.instrument import Instrument  # noqa: E402
from maria_torch.scenes import SCENES, cmb_patch_instrument  # noqa: E402

BANDS = ("act/pa5/f090", "act/pa5/f150")


@pytest.fixture(scope="module", autouse=True)
def private_cache(tmp_path_factory):
    """The module's own data cache (the spectra it generates), the
    previous setting restored as it was."""
    old = maria_torch.io._cache_state["base"]
    maria_torch.set_cache_dir(str(tmp_path_factory.mktemp("maria_torch_cache")))
    yield
    maria_torch.io._cache_state["base"] = old


def two_band_instrument():
    """40 polarized detectors a band, sorted by band (rows 0-39, 40-79)."""
    return maria_torch.get_instrument(array={
        "n": 20, "field_of_view": 0.2, "primary_size": 6, "polarized": True, "bands": list(BANDS)})


def interleave(n_det: int) -> np.ndarray:
    """The permutation whose new row 2k is band 0's k-th detector and row
    2k + 1 band 1's: the bands alternate, each in its own order."""
    half = n_det // 2
    return np.stack([np.arange(half), half + np.arange(half)], axis=1).ravel()


def alternating_array() -> Array:
    dets = two_band_instrument().dets
    return dets.take(interleave(dets.n))


# -- band_rows and device_rows -------------------------------------------------------------------


@pytest.mark.parametrize("make", [
    lambda: maria_torch.get_instrument("MUSTANG-2").dets,
    lambda: maria_torch.get_instrument("ACT").dets,
    lambda: maria_torch.get_instrument(SCENES["atlast"]["instrument"]).dets,
    lambda: cmb_patch_instrument().dets,
    alternating_array,
], ids=["mustang2", "act", "atlast-50k", "cmb-patch", "alternating"])
def test_band_rows_equal_np_where(make):
    """Each band's rows are np.where's, increasing int64, in bands' order;
    the cached table's are the function's."""
    dets = make()
    rows = dets.band_rows()
    assert len(rows) == len(dets.bands) and rows is dets.band_rows()
    for band, r in zip(dets.bands, rows):
        np.testing.assert_array_equal(r, np.where(dets.band_name == band.name)[0])
        assert r.dtype == np.int64 and np.all(np.diff(r) > 0)
    for r, s in zip(band_rows(dets.band_name, dets.bands), rows):
        np.testing.assert_array_equal(r, s)
    assert len(band_rows(dets.band_name, ["no-such-band"])[0]) == 0


@pytest.mark.parametrize("index, expected", [
    ([], slice(0, 0)),
    ([5], slice(5, 6)),
    ([0, 1, 2, 3], slice(0, 4)),
    ([7, 8, 9], slice(7, 10)),
    ([0, 2, 3], None),
    ([3, 2, 1], None),
    ([1, 1, 2], None),
    ([-2, -1], None),
])
def test_device_rows_is_a_slice_iff_contiguous(index, expected):
    out = device_rows(np.asarray(index, dtype=np.int64), "cpu")
    if expected is None:
        assert torch.is_tensor(out) and out.dtype == torch.int64 and out.tolist() == list(index)
    else:
        assert out == expected
    x = torch.arange(12.0)
    assert x[out].tolist() == x[torch.as_tensor(index, dtype=torch.int64)].tolist()


def test_band_rows_on_is_built_once():
    """band_rows_on(device) hands back the same objects on a second call:
    slices for ACT's six contiguous bands, int64 tensors where they alternate."""
    act = maria_torch.get_instrument("ACT").dets
    first = act.band_rows_on("cpu")
    assert first is act.band_rows_on(torch.device("cpu"))
    assert len(first) == 6 and all(isinstance(s, slice) and s.stop - s.start == 1500 for s in first)
    alt = alternating_array()
    on = alt.band_rows_on("cpu")
    assert on is alt.band_rows_on("cpu") and all(torch.is_tensor(r) for r in on)
    assert all(a is b for a, b in zip(on, alt.band_rows_on("cpu")))


def test_band_rows_follow_a_new_band_column():
    """The cache is keyed on the band_name column: assigning a new column
    (nothing in the package does) rebuilds it."""
    dets = two_band_instrument().dets
    before = dets.band_rows()
    dets.dets["band_name"] = dets.band_name[interleave(dets.n)]
    after = dets.band_rows()
    assert after is not before
    np.testing.assert_array_equal(after[0], np.arange(0, dets.n, 2))


# -- the index path: the interleaved table against the sorted one ------------------------------------


def simulation(instrument, atmosphere="2d", cmb=None):
    plan = maria_torch.Plan.generate(duration=10, sample_rate=20, start_time="2026-03-05T12:00:00",
                                     scan_center=(45, 45), scan_pattern="back-and-forth",
                                     scan_options={"x_throw": 1, "y_throw": 0, "speed": 0.5}, frame="az/el",
                                     site="cerro_toco")
    return maria_torch.Simulation(instrument, plans=[plan], site="cerro_toco", atmosphere=atmosphere, cmb=cmb,
                                  cmb_kwargs={"nside": 64}, noise=True, seed=0, device="cpu")


def noise_draws(sim, n_det: int, gen) -> dict:
    """The per-band white and mode draws and the gains' normals."""
    dets = sim.instrument.dets
    n_f = good_fft_size(sim.obs_list[0].shape[-1]) // 2 + 1
    return {
        "noise": [torch.randn((len(r), n_f, 2), generator=gen) for r in dets.band_rows()],
        "modes": [torch.randn((5, n_f, 2), generator=gen) for _ in dets.bands],
        "gains": torch.randn((n_det,), generator=gen),
    }


@pytest.fixture(scope="module")
def pair():
    """The sorted scene and its interleaved permutation, with a CMB, each
    run on the same draws (the gains' normals permuted with the rows)."""
    sorted_instrument = two_band_instrument()
    perm = interleave(sorted_instrument.n_dets)
    sims = {"sorted": simulation(sorted_instrument, cmb="generate")}
    sims["interleaved"] = simulation(Instrument([sorted_instrument.dets.take(perm)]), cmb=sims["sorted"].cmb)
    assert all(isinstance(r, slice) for r in sims["sorted"].instrument.dets.band_rows_on("cpu"))
    assert all(torch.is_tensor(r) for r in sims["interleaved"].instrument.dets.band_rows_on("cpu"))
    program = sims["sorted"].program()
    gen = torch.Generator().manual_seed(0)
    draws = {"screens": [torch.randn((s.ny, s.nx // 2 + 1, 2), generator=gen) for s in program.screens],
             **noise_draws(sims["sorted"], len(perm), gen)}
    out = {"perm": perm, "sims": sims}
    for name, sim in sims.items():
        d = dict(draws, gains=draws["gains"][perm] if name == "interleaved" else draws["gains"])
        out[name] = {"fields": sim.program().fields(draws=d, device="cpu"), "tod": sim.run_obs(0, draws=d)}
    return out


def assert_permuted(ours, ref, perm):
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref)[perm])


def test_program_fields_interleaved(pair):
    """TODProgram.fields with every draw handed in: each field (the
    atmosphere, the CMB, the noise) and the fine pwv are the sorted
    scene's rows, permuted."""
    p = pair["sims"]["interleaved"].program()
    assert p.band_order is None and p.band_bounds() is None
    assert all(torch.is_tensor(r) for r in p._tensors(torch.device("cpu"))["det_index"])
    (fields, pwv), (ref, ref_pwv) = pair["interleaved"]["fields"], pair["sorted"]["fields"]
    assert sorted(fields) == sorted(ref) == ["atmosphere", "cmb", "noise"]
    for k in ref:
        assert_permuted(fields[k], ref[k], pair["perm"])
    assert_permuted(pwv, ref_pwv, pair["perm"])


@pytest.mark.parametrize("units", ["K_RJ", "uK_CMB"])
def test_tod_to_interleaved(pair, units):
    """TOD.to through the atmosphere on the interleaved TOD: the sorted
    TOD's conversion, permuted, field by field."""
    ours = pair["interleaved"]["tod"].to(units)
    ref = pair["sorted"]["tod"].to(units)
    assert ours.fields == ref.fields
    for k in ref.fields:
        assert_permuted(ours.data[k], ref.data[k], pair["perm"])
    np.testing.assert_array_equal(pair["interleaved"]["tod"]["act/pa5/f150"].signal,
                                  pair["sorted"]["tod"]["act/pa5/f150"].signal)


def test_bin_mapper_interleaved(pair):
    """BinMapper's IQU map of the interleaved TOD is the sorted TOD's map."""
    maps = {}
    for name in ("sorted", "interleaved"):
        tod = pair[name]["tod"].to("K_RJ")
        center = tuple(float(c) for c in np.degrees(tod.boresight.center()))
        maps[name] = maria_torch.BinMapper(tod, center=center, width=1.5, resolution=0.05, frame="az/el",
                                           stokes="IQU", map_postprocessing={"keep_mean": True}).run()
    np.testing.assert_array_equal(maps["interleaved"].data, maps["sorted"].data)
    np.testing.assert_array_equal(maps["interleaved"].weight, maps["sorted"].weight)
    assert float(np.asarray(maps["sorted"].weight).sum()) > 0


def test_vacuum_noise_interleaved():
    """The vacuum Simulation.run() on handed-in draws: its noise on the
    interleaved table is the sorted table's, permuted."""
    sorted_instrument = two_band_instrument()
    perm = interleave(sorted_instrument.n_dets)
    sims = {"sorted": simulation(sorted_instrument, atmosphere=None),
            "interleaved": simulation(Instrument([sorted_instrument.dets.take(perm)]), atmosphere=None)}
    draws = noise_draws(sims["sorted"], len(perm), torch.Generator().manual_seed(1))
    out = {name: sim.run(units="pW", draws=[dict(draws, gains=draws["gains"][perm] if name == "interleaved"
                                                  else draws["gains"])])[0]
           for name, sim in sims.items()}
    assert out["sorted"].fields == ["noise"]
    assert_permuted(out["interleaved"].data["noise"], out["sorted"].data["noise"], perm)


def test_tod_band_is_a_copy(pair):
    """TOD["band"] of a contiguous band is read through a slice; the TOD
    it returns owns its rows, as one gathered by an index does."""
    tod = pair["sorted"]["tod"]
    before = {k: v.clone() for k, v in (*tod.data.items(), ("weight", tod.weight))}
    sub = tod["act/pa5/f090"]
    assert sub.dets.n == 40 and torch.equal(sub.signal, tod.signal[:40])
    for v in (*sub.data.values(), sub.weight):
        v.add_(1.0)
    for k, v in (*tod.data.items(), ("weight", tod.weight)):
        assert torch.equal(v, before[k])
