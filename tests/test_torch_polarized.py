"""The port's polarized path against maria_tpu, on the CPU: Stokes weights
of polarized arrays, the program's CMB and map stages with polarized
detectors of two bands, ``TOD.to``'s polarized factor, BinMapper in IQU,
the ML mapper at S = 3 (its blocks, P, P^T, N^-1, the diagonal and the
fit on maria_tpu's own blocks, carried by ``convert.ml_state_from_arrays``),
and the recovery scenes: tests/test_ml_mapper.py's pure-Q source,
tests/test_doc_flows.py's custom-array and polarized flows, and the CMB
patch of docs/tutorials.md at nside 256 and 60 s.

Both packages build the same instruments (the arrays' names, which seed
their polarization angles, included) and plans, with private data caches.
Where two float32 pointings would put a sample in the neighbouring pixel,
maria_tpu's is handed to the port (``reference_pointing``). Each
comparison states its tolerance.
"""

import contextlib
import os
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import maria_torch  # noqa: E402
import maria_tpu  # noqa: E402
import maria_tpu.cmb  # noqa: E402
from maria_tpu.io import caching as tpu_caching  # noqa: E402
from maria_tpu.mappers import MaximumLikelihoodMapper as RefML  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_slice import jax_draws, to_torch  # noqa: E402

from maria_torch import scenes  # noqa: E402
from maria_torch.convert import healpix_map_from_arrays, ml_state_from_arrays  # noqa: E402

T0 = 1.75e9
SEED = 0
CENTER = (150.0, 10.0)
PATCH_SECONDS = 20.0
# two bands, 19 positions, polarized: 76 detectors
SMALL_ARRAY = {"name": "pol2", "n": 19, "field_of_view": 0.05, "primary_size": 10, "polarized": True,
               "bands": ["act/pa5/f090", "act/pa5/f150"]}
PLANNER_KW = dict(start_time=T0, horizon_days=2, total_duration=10.0, chunk_duration=10.0, scan_pattern="daisy",
                  scan_options={"radius": 0.083, "speed": 0.017}, sample_rate=50)


def ref_patch_instrument():
    """docs/tutorials.md's instrument built by maria_tpu."""
    bands = []
    for name in ("act/pa5/f090", "act/pa5/f150"):
        band = maria_tpu.band.get_band(name)
        band.NET_RJ = 10e-6
        band.knee = 1e1
        bands.append(band)
    return maria_tpu.get_instrument(array={
        "field_of_view": 0.7, "beam_spacing": 1.5, "primary_size": 10, "packing": "sunflower", "shape": "circle",
        "polarized": True, "bands": bands})


def ref_patch_plan(duration):
    return maria_tpu.Plan.generate(duration=duration, sample_rate=20, start_time=scenes.CMB_PATCH_START,
                                   scan_center=(45, 45), scan_pattern="back-and-forth",
                                   scan_options={"x_throw": 2, "y_throw": 0, "speed": 1.0}, frame="az/el",
                                   site="cerro_toco")


@contextlib.contextmanager
def reference_pointing(ref_obs, ref_map=None, port_map=None):
    """Hand the port maria_tpu's float32 pointing of the same detectors:
    its ra/dec to ``Pointing.det_radec`` (for any subset of rows, found by
    their offsets) and, with a map, its offsets from the map's centre to
    the map stage."""
    from maria_tpu.sim.map import map_offsets as ref_offsets
    from maria_tpu.tod.tod import Pointing as RefPointing

    import maria_torch.sim.map as port_stage
    from maria_torch.tod import tod as port_tod

    ref = RefPointing(ref_obs.boresight, ref_obs.offsets, ref_obs.q)
    ra, dec = (torch.as_tensor(np.array(x)) for x in ref.det_radec())
    full = np.asarray(ref_obs.offsets)
    own_radec, own_offsets = port_tod.Pointing.det_radec, port_stage.map_offsets

    def given_radec(self, device=None, idx=None):
        offsets = self.offsets if idx is None else self.offsets[idx]
        rows = torch.as_tensor((offsets[:, None, :] == full[None]).all(-1).argmax(1))
        assert np.array_equal(full[rows.numpy()], offsets) and self.shape[1] == ra.shape[1]
        return ra[rows].to(device), dec[rows].to(device)

    port_tod.Pointing.det_radec = given_radec
    if ref_map is not None:
        map_off = torch.as_tensor(np.array(ref_offsets(ref_map, ref)))

        def given_offsets(input_map, pointing, device=None, idx=None):
            assert input_map.center == port_map.center
            return map_off if idx is None else map_off[torch.as_tensor(idx)]

        port_stage.map_offsets = given_offsets
    try:
        yield
    finally:
        port_tod.Pointing.det_radec = own_radec
        port_stage.map_offsets = own_offsets


def rel_max(ours, ref):
    ours, ref = np.asarray(ours, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert ours.shape == ref.shape
    return np.abs(ours - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    old_tpu, old_torch = tpu_caching.get_cache_dir(), maria_torch.io._cache_state["base"]
    maria_tpu.set_cache_dir(str(tmp_path_factory.mktemp("maria_tpu_cache")))
    maria_torch.set_cache_dir(str(tmp_path_factory.mktemp("maria_torch_cache")))
    yield
    maria_tpu.set_cache_dir(old_tpu)
    maria_torch.set_cache_dir(old_torch)


@pytest.fixture(scope="module")
def patch(caches):
    """The tutorial's instrument on a 20 s cut of its plan, observing one
    CMB that maria_tpu draws at nside 64 and hands to the port, without
    noise and with the gains' draw handed in as zeros, each band's CMB
    monopole (its mean) taken off: the port's TOD, and maria_tpu's TOD of
    the same data on maria_tpu's pointing."""
    from maria_tpu.tod.tod import Pointing as RefPointing

    ref_cmb = maria_tpu.cmb.generate_cmb(nside=64, seed=3)
    cmb = healpix_map_from_arrays(np.array(ref_cmb.data), stokes=ref_cmb.stokes, frame=ref_cmb.frame,
                                  units=ref_cmb.units, nu=ref_cmb.nu, cmb=True)
    ref_sim = maria_tpu.Simulation(ref_patch_instrument(), plans=[ref_patch_plan(PATCH_SECONDS)],
                                   site="cerro_toco", cmb=ref_cmb, noise=False, seed=SEED)
    sim = scenes.cmb_patch_simulation(PATCH_SECONDS, "cpu", cmb=cmb, noise=False)
    ref_obs = ref_sim.obs_list[0]
    with reference_pointing(ref_obs):
        tod = scenes.without_band_means(sim.run(draws=[{"gains": torch.zeros(sim.instrument.n_dets)}])[0])
    ref_tod = maria_tpu.tod.TOD(data={"signal": tod.signal.numpy()},
                                pointing=RefPointing(ref_obs.boresight, ref_obs.offsets, ref_obs.q),
                                dets=ref_obs.instrument.dets, units="K_RJ")
    return {"ref_sim": ref_sim, "sim": sim, "ref_cmb": ref_cmb, "cmb": cmb, "tod": tod, "ref_tod": ref_tod}


# -- the instrument and its Stokes weights ------------------------------------------------------


def test_patch_instrument_and_stokes_weights(patch):
    """1,052 detectors (263 positions x 2 polarizations x 2 bands), maria_tpu's
    table and Stokes weights (1, cos 2 gamma, sin 2 gamma, 0) / 2 bit-equal,
    the NEPs from NET_RJ through the setter."""
    ref, ours = patch["ref_sim"].instrument, patch["sim"].instrument
    assert ours.n_dets == ref.n_dets == 1052 and ours.name == ref.name == "array"
    sw = ours.dets.stokes_weight()
    np.testing.assert_array_equal(sw, ref.dets.stokes_weight())
    g = ours.dets.gamma
    np.testing.assert_allclose(sw, 0.5 * np.stack([np.ones_like(g), np.cos(2 * g), np.sin(2 * g), 0 * g], -1),
                               rtol=0, atol=1e-15)
    for a, b in zip(ours.bands, ref.bands):
        assert a.name == b.name and a.NEP == pytest.approx(b.NEP, rel=1e-12) and a.knee == b.knee == 10


def test_cmb_samples_with_polarized_detectors(patch):
    """The Stokes-weighted CMB samples along maria_tpu's ra/dec: within
    1e-6 of their maximum, but for a pixel edge that the two rotations'
    last bits put on opposite sides (at most 1 sample in 10^4); Q and U
    reach them: with I alone they differ by more than 0.5% of the
    samples' spread (the CMB's polarization is a few percent of T)."""
    from maria_tpu.tod.tod import Pointing as RefPointing

    from maria_torch.tod import Pointing

    ref_obs, obs = patch["ref_sim"].obs_list[0], patch["sim"].obs_list[0]
    sw = np.asarray(obs.instrument.dets.stokes_weight(), dtype=np.float32)
    ref = np.asarray(patch["ref_cmb"].sample_stokes(RefPointing(ref_obs.boresight, ref_obs.offsets, ref_obs.q), sw))
    with reference_pointing(ref_obs):
        pointing = Pointing(obs.boresight, obs.offsets, obs.q)
        ours = patch["cmb"].sample_stokes(pointing, torch.as_tensor(sw)).numpy()
        i_only = patch["cmb"].sample_stokes(pointing, torch.as_tensor(sw * [1, 0, 0, 0])).numpy()
    assert ours.shape == ref.shape == (1052, 400)
    assert (np.abs(ours - ref) > 1e-6 * np.abs(ref).max()).mean() <= 1e-4
    assert np.abs(ours - i_only).max() > 0.005 * np.abs(ours - ours.mean()).max()


@pytest.fixture(scope="module")
def program_runs(caches):
    """A polarized two-band array at the GBT on a Planner-made 10 s daisy,
    with the 2-D atmosphere, a CMB (maria_tpu's at nside 32) and the IQUV
    polarized_source widened to 0.5 deg: both packages' K_RJ TODs on
    maria_tpu's draws and pointing."""
    ref_cmb = maria_tpu.cmb.generate_cmb(nside=32, seed=3)
    cmb = healpix_map_from_arrays(np.array(ref_cmb.data), stokes=ref_cmb.stokes, frame=ref_cmb.frame,
                                  units=ref_cmb.units, nu=ref_cmb.nu, cmb=True)
    ref_map = maria_tpu.map.get("polarized_source", center=CENTER, width=0.5, fetch_first=False)
    our_map = maria_torch.map.get("polarized_source", center=CENTER, width=0.5)
    ref_plan = maria_tpu.plan.Planner(target=CENTER, site="GBT").generate_plans(**PLANNER_KW)[0]
    plan = maria_torch.Planner(target=CENTER, site="GBT").generate_plans(**PLANNER_KW)[0]
    ref_inst = maria_tpu.instrument.Instrument(arrays=[maria_tpu.array.Array.from_config(SMALL_ARRAY)])
    inst = maria_torch.Instrument(arrays=[maria_torch.array.Array.from_config(SMALL_ARRAY)])
    kw = dict(site="GBT", atmosphere="2d", seed=SEED)
    ref_sim = maria_tpu.Simulation(ref_inst, plans=ref_plan, cmb=ref_cmb, map=ref_map, **kw)
    sim = maria_torch.Simulation(inst, plans=plan, cmb=cmb, map=our_map, device="cpu", **kw)
    from maria_tpu.ops.program import build_tod_program

    ref_obs = ref_sim.obs_list[0]
    draws = to_torch(jax_draws(build_tod_program(ref_obs, noise_kwargs=ref_sim.noise_kwargs), SEED))
    ref_tod = ref_sim.run()[0]
    with reference_pointing(ref_obs, ref_map, our_map):
        tod = sim.run(draws=[draws])[0]
    return ref_tod, tod, sim


def test_program_cmb_and_map_fields_with_polarized_detectors(program_runs):
    """The program's stages with finite gammas, in K_RJ: the map field
    (an IQUV map sampled as sum_s w_s map_s) within 1e-5 of its maximum,
    the CMB field as the unpolarized one is held (2e-6 relative, 1e-4 of
    its std), atmosphere and noise as the az/el slice holds them."""
    ref_tod, tod, sim = program_runs
    assert tod.fields == ref_tod.fields == ["atmosphere", "cmb", "map", "noise"]
    assert np.isfinite(sim.instrument.dets.gamma).all() and sim.instrument.n_dets == 76
    ref, ours = np.asarray(ref_tod.data["map"]), tod.data["map"].numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    for k in ("atmosphere", "noise", "cmb"):
        ref, ours = np.asarray(ref_tod.data[k]), tod.data[k].numpy()
        np.testing.assert_allclose(ours, ref, rtol=2e-6, atol=1e-4 * (ref - ref.mean()).std(), err_msg=k)


def test_polarized_map_stage_carries_q_and_u(program_runs):
    """The static samples of each band: sum_s w_s map_s of the smoothed
    IQUV map, not its I alone (the ring's 10% tangential polarization)."""
    _, _, sim = program_runs
    program = sim.program()
    dets = sim.instrument.dets
    for band in program.bands:
        ((_, samples),) = band.map_stages
        sw = torch.as_tensor(dets.stokes_weight()[band.det_index], dtype=torch.float32)
        assert samples.shape == (38, 500) and float((sw[:, 1:] ** 2).sum()) > 0
        assert float(samples.abs().max()) > 0


def test_noise_of_net_rj_bands_matches(patch):
    """Per-band noise of bands given by NET_RJ, in pW, on maria_tpu's
    draws (tests/test_torch_map_sim.py's ``vacuum_draws``): each band's
    rows within 1e-4 of the std of maria_tpu's, polarized detectors
    included."""
    from test_torch_map_sim import vacuum_draws

    ref_sim = maria_tpu.Simulation(ref_patch_instrument(), plans=[ref_patch_plan(PATCH_SECONDS)],
                                   site="cerro_toco", noise=True, seed=SEED)
    sim = scenes.cmb_patch_simulation(PATCH_SECONDS, "cpu", cmb=None, noise=True)
    draws = vacuum_draws(ref_sim)
    ref, ours = ref_sim.run(units="pW")[0], sim.run(units="pW", draws=[draws])[0]
    ref, ours = np.asarray(ref.data["noise"]), ours.data["noise"].numpy()
    dets = sim.instrument.dets
    for band in dets.bands:
        rows = dets.band_name == band.name
        np.testing.assert_allclose(ours[rows], ref[rows], rtol=0, atol=1e-4 * ref[rows].std())


def test_several_arrays_reach_the_pointing(caches):
    """AdvACT (act/pa4, pa5, pa6 from the array registry, each with its
    focal_plane_offset): the observation's detector offsets, and so the
    pointing, are maria_tpu's, and each array sits at its offset."""
    ref_inst, inst = maria_tpu.get_instrument("AdvACT"), maria_torch.get_instrument("AdvACT")
    kw = dict(duration=2.0, sample_rate=20, start_time=T0, scan_center=(45, 45), frame="az/el", scan_pattern="stare")
    ref_sim = maria_tpu.Simulation(ref_inst, plans=maria_tpu.Plan.generate(**kw), site="ACT", noise=False, seed=0,
                                   map="polarized_source")
    sim = maria_torch.Simulation(inst, plans=maria_torch.Plan.generate(**kw), site="ACT", noise=False, seed=0,
                                 device="cpu", map="polarized_source")
    obs, ref_obs = sim.obs_list[0], ref_sim.obs_list[0]
    np.testing.assert_array_equal(obs.offsets, np.asarray(ref_obs.offsets))
    for name, fpo in (("act/pa4", (-0.8, -0.5)), ("act/pa5", (0.0, 1.0)), ("act/pa6", (0.8, -0.5))):
        rows = inst.dets.array_name == name
        np.testing.assert_allclose(obs.offsets[rows].mean(0), np.radians(fpo), atol=1e-3)
    from maria_torch.tod import Pointing

    az, el = Pointing(obs.boresight, obs.offsets, obs.q).det_azel(device="cpu")
    ref_az, ref_el = (np.asarray(x) for x in maria_tpu.tod.tod.Pointing(ref_obs.boresight, ref_obs.offsets,
                                                                         ref_obs.q).det_azel())
    np.testing.assert_allclose(el.numpy(), ref_el, rtol=0, atol=1e-6)


# -- TOD.to's polarized factor --------------------------------------------------------------------


@pytest.mark.parametrize("gamma", ["polarized", "unpolarized", "mixed"])
def test_tod_to_polarized_factor(caches, gamma):
    """K_RJ <-> pW in a vacuum, per band, as maria_tpu's TOD.to: the
    factor is 1/2 k_B ∫ passband for a band with any polarized detector
    and k_B ∫ passband without. ROADMAP queue 3, hazard 8: a band that
    mixes polarized and unpolarized detectors is called polarized whole
    in maria_tpu (tod/tod.py:237, ``~isnan(gamma).all()`` is "not all
    NaN"), so its unpolarized detectors are calibrated at half their
    factor; the port does the same, so both agree."""
    from maria_tpu.tod.tod import TOD as RefTOD

    from maria_torch.tod import TOD

    g = {"polarized": [0.0, 30.0, 60.0, 90.0], "unpolarized": [np.nan] * 4, "mixed": [np.nan, 30.0, np.nan, 60.0]}
    cfg = {"name": "mix", "xi": [0.0, 0.01, 0.02, 0.03], "eta": [0.0] * 4, "gamma": g[gamma], "primary_size": 6,
           "band_name": ["act/pa5/f090", "act/pa5/f090", "act/pa5/f150", "act/pa5/f150"],
           "bands": ["act/pa5/f090", "act/pa5/f150"]}
    ref_dets, dets = maria_tpu.array.Array.from_config(cfg), maria_torch.array.Array.from_config(cfg)
    data = np.random.default_rng(0).standard_normal((4, 50)).astype(np.float32)
    ref = RefTOD(data={"x": data}, dets=ref_dets, units="pW").to("K_RJ")
    ours = TOD(data={"x": torch.as_tensor(data)}, dets=dets, units="pW").to("K_RJ")
    np.testing.assert_allclose(ours.data["x"].numpy(), np.asarray(ref.data["x"]), rtol=1e-6)
    back = ours.to("pW").data["x"].numpy()
    np.testing.assert_allclose(back, data, rtol=1e-6)
    ratio = ours.data["x"].numpy() / data
    unpol = TOD(data={"x": torch.as_tensor(data)}, dets=maria_torch.array.Array.from_config(
        {**cfg, "gamma": [np.nan] * 4}), units="pW").to("K_RJ").data["x"].numpy() / data
    np.testing.assert_allclose(ratio, (1.0 if gamma == "unpolarized" else 2.0) * unpol, rtol=1e-6)


# -- BinMapper in IQU -----------------------------------------------------------------------------


def patch_grid(tod):
    """A 64 x 64 ra/dec grid over the whole field the TOD covers (the
    geometry a mapper infers, widened by 2%)."""
    inferred = maria_torch.BinMapper(tod, frame="ra/dec", resolution=0.1)
    width = np.degrees(inferred.n_x * inferred.res) * 1.02
    return dict(center=tuple(np.degrees(inferred.center)), width=width, resolution=width / 64, frame="ra/dec")


def test_bin_mapper_iqu_matches(patch):
    """BinMapper with its Stokes auto-detected (IQU) on the same TOD and
    maria_tpu's pointing (handed to the port by ``reference_pointing``, so
    both bin every sample into the same pixel): every plane's data and
    weight element for element, within 1e-5 of the plane's maximum and
    1e-5 relative."""
    from maria_tpu.mappers import BinMapper as RefBinMapper

    kw = dict(patch_grid(patch["tod"]), map_postprocessing={"keep_mean": True})
    ref_map = RefBinMapper(patch["ref_tod"], **kw).run()
    mapper = maria_torch.BinMapper(patch["tod"], **kw)
    assert mapper.stokes == ref_map.stokes == "IQU"
    with reference_pointing(patch["ref_sim"].obs_list[0]):
        ours = mapper.run()
    assert ours.shape == tuple(ref_map.shape) == (3, 2, 1, 64, 64)
    ref_w, w = np.asarray(ref_map.weight), ours.weight.numpy()
    ref_d, d = np.nan_to_num(np.asarray(ref_map.data)), ours.data.numpy()
    for s in range(3):
        for b in range(2):
            np.testing.assert_allclose(w[s, b], ref_w[s, b], rtol=1e-5, atol=1e-5 * np.abs(ref_w[s, b]).max(),
                                       err_msg=f"weight {s} {b}")
            np.testing.assert_allclose(d[s, b], ref_d[s, b], rtol=1e-5, atol=1e-5 * np.abs(ref_d[s, b]).max(),
                                       err_msg=f"data {s} {b}")


def test_bin_mapper_iqu_is_k2_on_six_channels(patch):
    """BinMapper bins each band in one call of K2 with six channels
    (w sw_s d and w |sw_s| for I, Q, U): the map equals np.add.at of the
    same sums at the mapper's own ids."""
    from maria_torch.mappers.bin_mapper import radec_pixel_ids
    from maria_torch.ops.bin_map import bin_map

    tod = patch["tod"]
    kw = dict(patch_grid(tod), map_postprocessing={"keep_mean": True})
    mapper = maria_torch.BinMapper(tod, **kw)
    launches = bin_map.launches
    out = mapper.run()
    assert bin_map.launches == launches  # the plain version on the CPU: no kernel launch
    ids = radec_pixel_ids(tod.pointing, mapper.center, mapper.res, mapper.n_x, mapper.n_y, device="cpu").numpy()
    sw = tod.dets.stokes_weight()[:, :3]
    for b, band in enumerate(mapper.bands):
        rows = np.where(tod.dets.band_name == band.name)[0]
        sums, wts = np.zeros((3, mapper.n_x * mapper.n_y)), np.zeros((3, mapper.n_x * mapper.n_y))
        d, i = tod.signal[rows].double().numpy(), ids[rows]
        for s in range(3):
            ok = i >= 0
            np.add.at(sums[s], i[ok], (sw[rows, s, None] * d)[ok])
            np.add.at(wts[s], i[ok], np.broadcast_to(np.abs(sw[rows, s, None]), d.shape)[ok])
        np.testing.assert_allclose(out.weight[:, b, 0].numpy().reshape(3, -1), wts, rtol=1e-5)
        with np.errstate(invalid="ignore", divide="ignore"):
            m = np.where(wts > 0, sums / wts, 0.0)
        np.testing.assert_allclose(out.data[:, b, 0].numpy().reshape(3, -1), m, rtol=1e-4,
                                   atol=1e-5 * np.abs(m).max())


# -- the ML mapper at S = 3 -------------------------------------------------------------------------


def block_arrays(ref, i=0, noise_model=False):
    block = ref.blocks[i]
    keys = ("pix", "sw", "data") + (("A_inv", "U", "core") if noise_model else ())
    return {k: (None if block.get(k) is None else np.array(block[k])) for k in keys} | {"fs": block["fs"]}


def pair(patch, noise_model=False, **kw):
    """(maria_tpu's IQU mapper, the port's with maria_tpu's blocks), every
    sample on the 64 x 64 grid."""
    grid = patch_grid(patch["tod"])
    ref = RefML([patch["ref_tod"]], **grid, **kw)
    ours = maria_torch.MaximumLikelihoodMapper([patch["tod"]], **grid, **kw)
    if noise_model:
        ref._update_noise_model(ref.naive_map)
    return ref, ml_state_from_arrays(ours, [block_arrays(ref, noise_model=noise_model)])


def test_ml_blocks_at_s3(patch):
    """IQU from the polarized detectors, two bands: n_s = 3, the Stokes
    weights and data equal maria_tpu's, ids but for a float32 ulp of
    ra/dec (at most 0.05% of the samples), no sample off the grid."""
    grid = patch_grid(patch["tod"])
    ref = RefML([patch["ref_tod"]], **grid)
    ours = maria_torch.MaximumLikelihoodMapper([patch["tod"]], **grid)
    assert ours.stokes == ref.stokes == "IQU" and ours.n_s == 3 and ours.n_nu == 2
    assert (ours.n_cpix, ours.n_m) == (ref.n_cpix, ref.n_m) == (2 * (64 * 64 + 1), 3 * 2 * (64 * 64 + 1))
    pix, ref_pix = ours.blocks[0]["pix"].numpy(), np.asarray(ref.blocks[0]["pix"])
    assert (pix == ref_pix).mean() >= 0.9995 and not ((ref_pix % ref.n_pix1) == ref.n_pix).any()
    np.testing.assert_array_equal(ours.blocks[0]["sw"].numpy(), np.asarray(ref.blocks[0]["sw"]))
    assert ours.blocks[0]["sw"].shape == (1052, 3)
    np.testing.assert_array_equal(ours.blocks[0]["data"].numpy(), np.asarray(ref.blocks[0]["data"]))


def test_ml_pointing_operators_at_s3(patch):
    """On maria_tpu's blocks: P (the three Stokes planes gathered and
    weighted) equal to maria_tpu's; P^T (one K2 call, three channels;
    its plain version here) within 1e-5 of the maximum of maria_tpu's
    sums; the hits equal; the naive map and the per-Stokes white-noise
    diagonal within 1e-5 of their maxima."""
    ref, ours = pair(patch)
    block, ref_block = ours.blocks[0], ref.blocks[0]
    rng = np.random.default_rng(0)
    m = rng.standard_normal(ref.n_m).astype(np.float32)
    mask = np.asarray(ref._overflow_mask())
    np.testing.assert_array_equal(ours._project(torch.as_tensor(m), block).numpy(),
                                  np.asarray(ref._project(jnp.asarray(m * mask), ref_block)))
    v = rng.standard_normal(patch["tod"].shape).astype(np.float32)
    assert rel_max(ours._project_T(torch.as_tensor(v), block).numpy(), ref._project_T(jnp.asarray(v), ref_block)) <= 1e-5
    np.testing.assert_array_equal(ours.hits.numpy(), np.asarray(ref.hits))
    assert rel_max(ours.naive_map.numpy(), ref.naive_map) <= 1e-5
    ref._update_noise_model(ref.naive_map)
    ml_state_from_arrays(ours, [block_arrays(ref, noise_model=True)])
    diag, ref_diag = ours._white_diag().numpy(), np.asarray(ref._white_diag())
    for s in range(3):
        part = slice(s * ours.n_cpix, (s + 1) * ours.n_cpix)
        assert rel_max(diag[part], ref_diag[part]) <= 1e-5


@pytest.mark.parametrize("k", [0, 2])
def test_ml_noise_model_at_s3(patch, k):
    """From the same IQU map on maria_tpu's blocks: A_inv within 1e-4
    relative, N^-1 v within 1e-4 of its maximum."""
    ref, ours = pair(patch, k=k)
    m0 = np.array(ref.naive_map)
    ref._update_noise_model(jnp.asarray(m0))
    ours._update_noise_model(torch.as_tensor(m0))
    np.testing.assert_allclose(ours.blocks[0]["A_inv"].numpy(), np.asarray(ref.blocks[0]["A_inv"]), rtol=1e-4)
    v = np.random.default_rng(1).standard_normal(patch["tod"].shape).astype(np.float32)
    assert rel_max(ours._apply_inverse_N(ours.blocks[0], torch.as_tensor(v)).numpy(),
                   ref._apply_inverse_N(ref.blocks[0], jnp.asarray(v))) <= 1e-4


@pytest.mark.parametrize("k,method", [(0, "conjugate_gradient"), (2, "conjugate_gradient"), (0, "gradient_descent")])
def test_ml_fit_at_s3(patch, k, method):
    """fit() from maria_tpu's blocks, 2 epochs x 10 steps, IQU: each
    Stokes plane within 1e-3 of its maximum of maria_tpu's, the weights
    within 1e-3 relative."""
    ref, ours = pair(patch, k=k, n_epochs=2, n_cg_iters=10)
    out_ref, out = ref.fit(method=method), ours.fit(method=method)
    assert out.shape == (3, 2, 1, 64, 64) and out.stokes == "IQU"
    ref_d = np.nan_to_num(np.asarray(out_ref.data))
    for s in range(3):
        assert rel_max(out.data[s].numpy(), ref_d[s]) <= 1e-3, s
    np.testing.assert_allclose(out.weight.numpy(), np.asarray(out_ref.weight), rtol=1e-3)


# -- recovery on the port's own scenes ---------------------------------------------------------------


def test_ml_recovers_polarized_source(caches):
    """tests/test_ml_mapper.py's pure-Q source: an IQU ML fit of a Q-only
    az/el sky through a polarized array brings it back in Q (correlation
    above 0.7) and Q's std is more than twice I's rms (the reference's
    thresholds)."""
    n = 32
    data = np.zeros((3, 1, 1, n, n), dtype=np.float32)
    yy, xx = np.mgrid[:n, :n]
    data[1] = 2e-3 * np.exp(-((xx - n / 2) ** 2 + (yy - n / 2) ** 2) / (2 * (n / 7) ** 2))
    input_map = maria_torch.map.ProjectionMap(data=data, center=(150.0, 41.0), width=2.0, frame="az/el",
                                              stokes="IQU", units="K_RJ", degrees=True)
    arr = maria_torch.array.Array.from_config({"name": "pol", "n": 60, "field_of_view": 1.0, "primary_size": 10,
                                               "polarized": True, "bands": ["test/f150"]})
    plan = maria_torch.get_plan("five_second_stare", start_time=T0, sample_rate=20, scan_center=(150.0, 41.0),
                                frame="az/el", scan_pattern="daisy", scan_options={"radius": 0.4, "speed": 0.25})
    sim = maria_torch.Simulation(instrument=maria_torch.Instrument(arrays=[arr]), plans=plan, site="chajnantor",
                                 atmosphere=None, noise=False, map=input_map, seed=0, device="cpu")
    tod = sim.run()[0]
    out = maria_torch.MaximumLikelihoodMapper([tod], center=(150.0, 41.0), width=2.0, resolution=2.0 / n,
                                              frame="az/el", units="K_RJ", n_epochs=1, n_cg_iters=60).fit()
    assert out.stokes == "IQU"
    q, w = out.data[1, 0, 0].numpy(), out.weight[1, 0, 0].numpy()
    mask = w > 0
    a, b = q[mask] - q[mask].mean(), data[1, 0, 0][mask] - data[1, 0, 0][mask].mean()
    assert (a * b).sum() / np.sqrt((a**2).sum() * (b**2).sum() + 1e-30) > 0.7
    assert q[mask].std() > 2 * out.data[0, 0, 0].numpy()[mask].std()


def test_custom_array_instrument_flow(caches):
    """tests/test_doc_flows.py:71-87 without its map download: Bands of
    NET_RJ on an inline array, and a site with its altitude overridden."""
    f090 = maria_torch.band.Band(center=90e9, width=20e9, NET_RJ=40e-6, knee=1e0, gain_error=5e-2)
    f150 = maria_torch.band.Band(center=150e9, width=30e9, NET_RJ=60e-6, knee=1e0, gain_error=5e-2)
    instrument = maria_torch.get_instrument(
        array={"field_of_view": 0.05, "beam_spacing": 1.5, "primary_size": 50, "bands": [f090, f150]})
    assert instrument.dets.n > 2 and instrument.bands.names == ["f090", "f150"]
    ref = maria_tpu.get_instrument(array={"field_of_view": 0.05, "beam_spacing": 1.5, "primary_size": 50, "bands": [
        maria_tpu.band.Band(center=90e9, width=20e9, NET_RJ=40e-6), maria_tpu.band.Band(center=150e9, width=30e9,
                                                                                      NET_RJ=60e-6)]})
    np.testing.assert_array_equal(instrument.dets.offsets, ref.dets.offsets)
    site = maria_torch.get_site("llano_de_chajnantor", altitude=5065)
    assert site.altitude == 5065 and site.region == "chajnantor"


def test_polarized_observation_flow(caches):
    """tests/test_doc_flows.py:90-108 on the polarized_source family in
    place of the einstein download: the IQUV map x 50 through a 16-position
    polarized array at mauna_kea on the Planner's first 20 s; the TOD is
    finite, and Q and U reach it (with I alone it differs)."""
    input_map = maria_torch.map.get("polarized_source", n=128)
    assert input_map.stokes == "IQUV"
    input_map = input_map._replace(data=input_map.data * 50)
    f150 = maria_torch.band.Band(center=150e9, width=30e9, NET_RJ=60e-6, knee=1e0)
    instrument = maria_torch.get_instrument(
        array={"field_of_view": 0.1, "primary_size": 10, "n": 16, "polarized": True, "bands": [f150]})
    planner = maria_torch.Planner(target=input_map, site="mauna_kea", constraints={"el": (45, 90)})
    plans = planner.generate_plans(start_time=T0, total_duration=20, sample_rate=16)
    tods = {}
    for label, m in (("IQUV", input_map), ("I", input_map._replace(data=input_map.data[:1], weight=None, stokes="I"))):
        sim = maria_torch.Simulation(instrument, plans=plans[:1], site="mauna_kea", map=m, seed=11, device="cpu")
        tods[label] = sim.run()[0]
    assert bool(torch.isfinite(tods["IQUV"].signal).all()) and tods["IQUV"].shape == (32, 320)
    diff = (tods["IQUV"].data["map"] - tods["I"].data["map"]).abs().max()
    assert float(diff) > 1e-3 * float(tods["IQUV"].data["map"].abs().max())


@pytest.fixture(scope="module")
def cmb_patch_60s(caches):
    """docs/tutorials.md's CMB patch at nside 256 and 60 s, noise off, the
    gains' draw handed in as zeros, each band's CMB monopole (its mean)
    taken off: the sky term alone."""
    sim = scenes.cmb_patch_simulation(60.0, "cpu", cmb_kwargs={"nside": 256}, noise=False)
    tod = sim.run(draws=[{"gains": torch.zeros(sim.instrument.n_dets)}])[0]
    return sim, scenes.without_band_means(tod)


def test_cmb_patch_recovers_iqu(cmb_patch_60s):
    """The tutorial's IQU ML fit (2 epochs x 25 steps, ra/dec at 2 arcmin)
    without processing: each band's I, Q and U planes correlate with the
    input CMB's T, Q and U at the hit pixel centres above 0.95 (I) and 0.8
    (Q, U), in the simulator's own convention."""
    sim, tod = cmb_patch_60s
    mapper = scenes.cmb_patch_mapper([tod], tod_preprocessing={})
    assert mapper.stokes == "IQU" and mapper.n_nu == 2
    out = mapper.fit(epochs=2, steps_per_epoch=25)
    for b in range(2):
        corr = scenes.stokes_recovery(sim.cmb, out, nu_index=b)
        assert corr["I"] >= 0.95 and corr["Q"] >= 0.8 and corr["U"] >= 0.8, (b, corr)


def test_cmb_patch_tutorial_chain_runs(cmb_patch_60s):
    """The tutorial's mapper as written (remove_spline with the elevation
    gradient to order 3) gives finite IQU maps of both bands."""
    sim, tod = cmb_patch_60s
    out = scenes.cmb_patch_mapper([tod]).fit(epochs=1, steps_per_epoch=5)
    assert out.shape[:2] == (3, 2) and bool(torch.isfinite(out.data).all()) and float(out.weight.max()) > 0


def test_act_camera_scene_builds(caches):
    """scenes.act_simulation: ACT's 9,000 polarized detectors in six
    bands at the ACT site on back_and_forth_10deg_45el (a 2 s cut, no
    atmosphere here), and BinMapper's IQU auto-detection on its TOD."""
    sim = scenes.act_simulation(2.0, "cpu", cmb=None, atmosphere=None)
    assert sim.instrument.n_dets == 9000 and len(sim.instrument.bands) == 6 and sim.site.region == "chajnantor"
    tod = sim.run()[0]
    assert tod.shape == (9000, 40) and bool(torch.isfinite(tod.signal).all())
    assert maria_torch.BinMapper(tod, frame="ra/dec", resolution=1 / 30).stokes == "IQU"
