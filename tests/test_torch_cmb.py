"""The port's CMB against maria_tpu, on the CPU: the spectra, the skies,
HEALPixMap, the CMB's loading tables, the program's CMB stage and the
CMB in scenes with and without an atmosphere.

One module-scoped scene is built by both packages with private data
caches: MUSTANG-2 at the GBT on a Planner-made 10 s ra/dec daisy at
(150, 10) deg, with the 2-D atmosphere and without any, both observing
one CMB sky that maria_tpu generates at nside 32 and hands to the port
(``healpix_map_from_arrays``). maria_tpu's draws are reproduced with
jax.random and handed to the port, and its detectors' float32 ra/dec to
the port's sampling (``reference_pointing``), so the fields compare
sample by sample. Each comparison states its tolerance.
"""

import contextlib
import os
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import maria_torch  # noqa: E402
import maria_torch.cmb  # noqa: E402
import maria_tpu  # noqa: E402
import maria_tpu.cmb  # noqa: E402
from maria_tpu.io import caching as tpu_caching  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_slice import jax_draws, to_torch  # noqa: E402

from maria_torch.convert import healpix_map_from_arrays  # noqa: E402
from maria_torch.map import HEALPixMap  # noqa: E402

T0 = 1.75e9
SEED = 0
CENTER = (150.0, 10.0)
PLANNER_KW = dict(start_time=T0, horizon_days=2, total_duration=10.0, chunk_duration=10.0, scan_pattern="daisy",
                  scan_options={"radius": 0.083, "speed": 0.017}, sample_rate=50)


def carried(ref_map, cmb=True):
    """A maria_tpu HEALPixMap or CMB as the port's, through its arrays."""
    return healpix_map_from_arrays(np.array(ref_map.data), stokes=ref_map.stokes, frame=ref_map.frame,
                                   units=ref_map.units, nu=ref_map.nu, cmb=cmb)


@contextlib.contextmanager
def reference_pointing(ref_obs):
    """Hand the port's Pointing.det_radec maria_tpu's float32 ra/dec of
    the same detectors, so that the samples compare on the same inputs
    (the two float32 ra tracks differ by an ulp for a few samples in a
    hundred, which at a pixel edge picks the neighbouring pixel)."""
    from maria_tpu.tod.tod import Pointing as RefPointing

    from maria_torch.tod import tod as port_tod

    ref = RefPointing(ref_obs.boresight, ref_obs.offsets, ref_obs.q)
    ra, dec = (torch.as_tensor(np.array(x)) for x in ref.det_radec())
    own = port_tod.Pointing.det_radec

    def given(self, device=None, idx=None):
        assert self.shape == tuple(ra.shape) and idx is None
        return ra.to(device), dec.to(device)

    port_tod.Pointing.det_radec = given
    try:
        yield
    finally:
        port_tod.Pointing.det_radec = own


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    old_tpu, old_torch = tpu_caching.get_cache_dir(), maria_torch.io._cache_state["base"]
    maria_tpu.set_cache_dir(str(tmp_path_factory.mktemp("maria_tpu_cache")))
    maria_torch.set_cache_dir(str(tmp_path_factory.mktemp("maria_torch_cache")))
    try:
        ref_cmb = maria_tpu.cmb.generate_cmb(nside=32, seed=3)
        cmb = carried(ref_cmb)
        ref_plan = maria_tpu.plan.Planner(target=CENTER, site="GBT").generate_plans(**PLANNER_KW)[0]
        plan = maria_torch.Planner(target=CENTER, site="GBT").generate_plans(**PLANNER_KW)[0]
        kw = dict(instrument="MUSTANG-2", site="GBT", seed=SEED)
        out = {"ref_cmb": ref_cmb, "cmb": cmb, "ref_plan": ref_plan, "plan": plan}
        for key, atmosphere in (("atm", "2d"), ("vac", None)):
            out[f"ref_{key}"] = maria_tpu.Simulation(plans=ref_plan, atmosphere=atmosphere, cmb=ref_cmb, **kw)
            out[key] = maria_torch.Simulation(plans=plan, atmosphere=atmosphere, cmb=cmb, device="cpu", **kw)
        yield out
    finally:
        maria_tpu.set_cache_dir(old_tpu)
        maria_torch.set_cache_dir(old_torch)


# -- the device policy ---------------------------------------------------------------------------


def test_entry_points_need_a_device_without_a_card():
    """Without a card, device=None raises (it never falls back to the CPU):
    resolve_device itself and a Simulation made without device=."""
    from maria_torch.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        resolve_device(None)
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        maria_torch.Simulation("MUSTANG-2", plans="ten_second_zenith_stare", site="GBT")


# -- spectra and skies -----------------------------------------------------------------------------


def test_get_cmb_spectrum_is_exact():
    ref = maria_tpu.cmb.get_cmb_spectrum(lmax=3000)
    ours = maria_torch.cmb.get_cmb_spectrum(lmax=3000)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])


@pytest.mark.parametrize("kw", [dict(width=1.0, seed=4), dict(width=2.0, resolution=0.01, center=(30.0, -20.0),
                                                             frame="az/el", nu=90e9, seed=5, pad_factor=2.0)])
def test_generate_cmb_patch_is_bit_equal(kw):
    ref = maria_tpu.cmb.generate_cmb_patch(**kw)
    ours = maria_torch.cmb.generate_cmb_patch(**kw)
    np.testing.assert_array_equal(ours.data.numpy(), np.asarray(ref.data))
    assert ours.units == ref.units == "K_CMB" and ours.frame == ref.frame
    assert ours.center == ref.center and ours.width == pytest.approx(float(ref.width.rad), rel=1e-12)
    np.testing.assert_array_equal(ours.nu, ref.nu)


def test_generate_cmb_recovers_its_spectra():
    """A generated IQU sky at nside 64 analysed at lmax 128: the TT, EE
    and BB power over l in [30, 90) within 15% of the input spectra, and
    the TE correlation within 0.2 of the input's (maria_tpu's bounds,
    tests/test_sht_spin.py)."""
    from maria_torch.healpix import map2alm, map2alm_spin

    nside, lmax = 64, 128
    cmb = maria_torch.cmb.generate_cmb(nside=nside, lmax=lmax, seed=1, device="cpu")
    assert isinstance(cmb, maria_torch.cmb.CMB) and cmb.stokes == "IQU" and cmb.units == "K_CMB"
    assert cmb.frame == "galactic" and cmb.shape == (3, 1, 1, 12 * nside**2) and list(cmb.nu) == [150e9]
    T, Q, U = cmb.data[:, 0, 0]
    assert float(Q.std()) > 0 and float(U.std()) > 0
    spec = maria_torch.cmb.get_cmb_spectrum(lmax=lmax)
    aT = map2alm(T, lmax).numpy()
    aE, aB = (x.numpy() for x in map2alm_spin(Q, U, lmax))
    ells = np.arange(lmax + 1)
    band = slice(30, 90)
    for name, a in (("TT", aT), ("EE", aE), ("BB", aB)):
        cl = ((np.abs(a) ** 2).sum(1) * 2 - np.abs(a[:, 0]) ** 2) / (2 * ells + 1)
        assert abs(cl[band].sum() / spec[name][band].sum() - 1) < 0.15, name
    r = np.sum((aT[band] * np.conj(aE[band])).real) / np.sqrt(np.sum(np.abs(aT[band]) ** 2) * np.sum(np.abs(aE[band]) ** 2))
    r_in = spec["TE"][band].sum() / np.sqrt(spec["TT"][band].sum() * spec["EE"][band].sum())
    assert abs(r - r_in) < 0.2


def test_get_cmb_is_the_seeded_stand_in(monkeypatch):
    """get_cmb synthesizes its stand-in directly: generate_cmb at nside
    256 with seed 777, labelled 143 GHz."""
    calls = []

    def fake(**kw):
        calls.append(kw)
        return maria_torch.cmb.CMB(data=np.ones((3, 1, 1, 12), np.float32), stokes="IQU")

    monkeypatch.setattr(maria_torch.cmb, "generate_cmb", fake)
    sky = maria_torch.cmb.get_cmb(device="cpu")
    assert calls == [dict(nside=256, seed=777, device="cpu")]
    assert isinstance(sky, maria_torch.cmb.CMB) and list(sky.nu) == [143e9] and sky.units == "K_CMB"


# -- HEALPixMap ------------------------------------------------------------------------------------


def test_healpix_map_basics(scene, tmp_path):
    cmb, ref = scene["cmb"], scene["ref_cmb"]
    assert cmb.nside == ref.nside == 32 and cmb.npix == ref.npix and cmb.resolution == ref.resolution
    assert cmb.stokes == "IQU" and cmb.frame == "galactic" and isinstance(cmb, maria_torch.cmb.CMB)
    np.testing.assert_array_equal(cmb.data.numpy(), np.asarray(ref.data))
    assert cmb.to("uK_CMB").units == "uK_CMB"
    np.testing.assert_allclose(cmb.to("uK_CMB").data.numpy(), 1e6 * cmb.data.numpy(), rtol=1e-6)
    rj, ref_rj = cmb.to("K_RJ"), ref.to("K_RJ")
    assert rj.units == "K_RJ" and rj.weight is None
    np.testing.assert_allclose(rj.data.numpy(), np.asarray(ref_rj.data), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(ref_rj.data)).max())
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ax = cmb.plot(n_grid=40)
    assert ax.name == "mollweide" and len(ax.collections) == 1
    plt.close("all")
    pytest.importorskip("h5py")
    path = str(tmp_path / "cmb.h5")
    cmb.to_hdf(path)
    back = maria_torch.map.load(path)
    np.testing.assert_array_equal(back.data.numpy(), cmb.data.numpy())
    assert back.stokes == cmb.stokes and back.frame == cmb.frame and back.units == cmb.units
    with pytest.raises(ValueError, match="not a valid HEALPix"):
        HEALPixMap(np.zeros(100))
    rng = np.random.default_rng(0)
    phi, lat = rng.uniform(-np.pi, np.pi, 1000), np.arcsin(rng.uniform(-1, 1, 1000))
    ref_pix = np.asarray(ref.pixel_index(phi.astype(np.float32), lat.astype(np.float32)))
    ours = cmb.pixel_index(torch.as_tensor(phi, dtype=torch.float32), torch.as_tensor(lat, dtype=torch.float32))
    assert (ours.numpy() != ref_pix).sum() <= 1


def test_sample_stokes_matches_with_the_reference_pointing(scene):
    """The Stokes-weighted samples of the sky along maria_tpu's float32
    ra/dec, rotated to galactic on both sides: within 1e-6 of the
    samples' maximum, but for a pixel edge that the two rotations' last
    bits put on opposite sides, at most 1 sample in 10^4."""
    from maria_tpu.tod.tod import Pointing as RefPointing

    from maria_torch.tod import Pointing

    ref_obs, obs = scene["ref_vac"].obs_list[0], scene["vac"].obs_list[0]
    sw = np.asarray(obs.instrument.dets.stokes_weight(), dtype=np.float32)
    ref = np.asarray(scene["ref_cmb"].sample_stokes(RefPointing(ref_obs.boresight, ref_obs.offsets, ref_obs.q), sw))
    with reference_pointing(ref_obs):
        ours = scene["cmb"].sample_stokes(Pointing(obs.boresight, obs.offsets, obs.q), torch.as_tensor(sw)).numpy()
    assert ours.shape == ref.shape == (217, 500) and ours.dtype == np.float32
    off = np.abs(ours - ref) > 1e-6 * np.abs(ref).max()
    assert off.mean() <= 1e-4, off.sum()


@pytest.mark.parametrize("stokes", ["I", "IQU"])
def test_smooth_matches(scene, stokes):
    """Harmonic smoothing (I by the scalar transform, Q/U by the spin-2
    one) against maria_tpu's, 1e-5 of each Stokes map's maximum."""
    from maria_tpu.map.healpix import HEALPixMap as RefHEALPixMap

    fwhm = np.radians(5.0)
    ref_map = scene["ref_cmb"] if stokes == "IQU" else RefHEALPixMap(
        data=np.asarray(scene["ref_cmb"].data)[:1], stokes="I", units="K_CMB")
    ref = np.asarray(ref_map.smooth(fwhm=maria_tpu.units.Quantity(fwhm, "rad")).data)
    ours = carried(ref_map, cmb=False).smooth(fwhm, device="cpu").data.numpy()
    assert ours.shape == ref.shape
    for s in range(len(stokes)):
        np.testing.assert_allclose(ours[s], ref[s], rtol=0, atol=1e-5 * np.abs(ref[s]).max())
    assert ours[0].std() < 0.9 * np.asarray(ref_map.data)[0].std()


# -- the CMB's loading ------------------------------------------------------------------------------


def test_cmb_power_tables_match(scene):
    from maria_tpu.sim.cmb import cmb_power_tables as ref_tables

    from maria_torch.sim.cmb import cmb_power_tables

    ref_obs, obs = scene["ref_atm"].obs_list[0], scene["atm"].obs_list[0]
    T_base = float(obs.atmosphere.weather.temperature[0])
    ref = ref_tables(ref_obs.instrument.dets.bands[0], ref_obs.atmosphere.spectrum, T_base)
    ours = cmb_power_tables(obs.instrument.dets.bands[0], obs.atmosphere.spectrum, T_base)
    for a, b in zip(ours, ref):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_allclose(a, b, rtol=2e-7, atol=0)


def test_initialize_cmb():
    from maria_torch.sim.cmb import DEFAULT_CMB_SIM_KWARGS, initialize_cmb

    assert DEFAULT_CMB_SIM_KWARGS == {"nside": 1024}
    sky = initialize_cmb("generate", seed=2, device="cpu", nside=8)
    assert sky.nside == 8 and sky.units == "K_CMB"
    with pytest.raises(ValueError, match="Invalid value for cmb"):
        initialize_cmb("nonsense", device="cpu")
    micro = initialize_cmb(sky.to("uK_CMB"), device="cpu")
    assert micro.units == "K_CMB"
    np.testing.assert_allclose(micro.data.numpy(), sky.data.numpy(), rtol=1e-6, atol=1e-12)


def test_simulation_honours_cmb_kwargs(monkeypatch, scene):
    """The default nside is 1024, and cmb_kwargs override it."""
    import maria_torch.cmb as port_cmb

    seen = []

    def fake(**kw):
        seen.append(kw)
        return scene["cmb"]

    monkeypatch.setattr(port_cmb, "generate_cmb", fake)
    kw = dict(instrument="MUSTANG-2", plans=scene["plan"], site="GBT", seed=7, device="cpu")
    maria_torch.Simulation(cmb="generate", **kw)
    maria_torch.Simulation(cmb="generated", cmb_kwargs={"nside": 16}, **kw)
    assert seen == [dict(seed=7, device=torch.device("cpu"), nside=1024),
                    dict(seed=7, device=torch.device("cpu"), nside=16)]


@pytest.fixture(scope="module")
def atm_fields(scene):
    """Both programs' fields on the same draws: maria_tpu's fused program
    at the key Simulation.run() gives it, and the port's with those draws
    and maria_tpu's pointing for the CMB's samples."""
    from maria_tpu.ops.program import build_tod_program

    ref_sim = scene["ref_atm"]
    ref_obs = ref_sim.obs_list[0]
    ref_program = build_tod_program(ref_obs, noise_kwargs=ref_sim.noise_kwargs, cmb=ref_sim.cmb)
    _, prog_key = jax.random.split(jax.random.key(SEED))
    ref_fields, ref_pwv = jax.jit(ref_program.fields_fn())(prog_key, *ref_program.example_args(prog_key)[1:])
    draws = to_torch(jax_draws(ref_program, SEED))
    sim = scene["atm"]
    sim._programs.clear()
    with reference_pointing(ref_obs):
        program = sim.program()
    fields, pwv = program.fields(draws=draws, device="cpu")
    fields_np = {k: np.asarray(v) for k, v in ref_fields.items()}
    return fields_np, np.asarray(ref_pwv), fields, pwv, program, draws, ref_program


def test_program_cmb_field_matches_maria_tpu(atm_fields):
    """The program's CMB stage, sample by sample: its static sky samples
    within 1e-6 of their maximum, its (pwv, el) tables within float32
    rounding, and the "cmb" field as the atmosphere is held (2e-6
    relative: the two table evaluators round differently), every field
    present and the pwv the same."""
    ref, ref_pwv, fields, pwv, program, _, ref_program = atm_fields
    assert sorted(fields) == sorted(ref) == ["atmosphere", "cmb", "noise"]
    np.testing.assert_allclose(pwv.numpy(), ref_pwv, rtol=2e-6)
    band, ref_band = program.bands[0], ref_program.bands[0]
    samples, ref_samples = band.cmb_samples.numpy(), np.asarray(ref_band.cmb_samples)
    assert samples.shape == ref_samples.shape == (217, 500)
    np.testing.assert_allclose(samples, ref_samples, rtol=0, atol=1e-6 * np.abs(ref_samples).max())
    xs, ys = band.pwv_side, band.el_side
    i0 = int(np.searchsorted(np.asarray(ref_band.pwv_side, np.float32), xs[0]))
    j0 = int(np.searchsorted(np.asarray(ref_band.el_side, np.float32), ys[0]))
    for ours, theirs in ((band.cmb_P0_table, ref_band.cmb_P0_table), (band.cmb_dPdT_table, ref_band.cmb_dPdT_table)):
        np.testing.assert_allclose(ours, np.asarray(theirs)[i0:i0 + len(xs), j0:j0 + len(ys)], rtol=2e-7)
    ours, theirs = fields["cmb"].numpy(), ref["cmb"]
    assert ours.shape == theirs.shape == (217, 500)
    np.testing.assert_allclose(ours, theirs, rtol=2e-6, atol=1e-4 * (theirs - theirs.mean()).std())


def test_program_cmb_field_matches_compute_cmb_loading(scene, atm_fields):
    """The in-program stage against the chain outside it on the same fine
    pwv (tests/test_fused_program.py's bounds): the difference's std
    under 5% of the field's, its max under half of it. The residual is
    the program's elevation upsampled from the coarse rate."""
    from maria_torch.sim.cmb import compute_cmb_loading

    _, _, fields, pwv, _, _, _ = atm_fields
    obs = scene["atm"].obs_list[0]
    obs.zenith_scaled_pwv = pwv
    with reference_pointing(scene["ref_atm"].obs_list[0]):
        mixin = compute_cmb_loading(scene["cmb"], obs, device="cpu")
    diff = (fields["cmb"] - mixin).double()
    std = float(mixin.double().std())
    assert float(diff.std()) < 0.05 * std and float(diff.abs().max()) < 0.5 * std


def test_simulation_with_atmosphere_carries_the_cmb(scene, atm_fields):
    """run() through the program: the "cmb" field is the program's times
    the gains, in pW."""
    _, _, fields, _, program, draws, _ = atm_fields
    with reference_pointing(scene["ref_atm"].obs_list[0]):
        tod = scene["atm"].run(units="pW", draws=[draws])[0]
    gains = program.draw_gains(draw=draws["gains"], device="cpu")
    assert tod.fields == ["atmosphere", "cmb", "noise"]
    np.testing.assert_array_equal(tod.data["cmb"].numpy(), (gains * fields["cmb"]).numpy())


def test_vacuum_scene_matches_maria_tpu(scene):
    """Without an atmosphere the CMB is sampled and calibrated by the
    passband alone every run(). maria_tpu's _compute_cmb_loading (its
    sim/cmb.py:106-114) takes dP/dT as the float32 difference of two
    powers 1e-6 K apart, which keeps one or two significant digits; the
    port takes it in float64, as the program's tables do. So P0 is held
    to maria_tpu's at float32 rounding, dP/dT to within what one float32
    ulp of P0 over eps allows, and the field, in pW and through run()
    with maria_tpu's gain draw, to P0 w_I + dP/dT x maria_tpu's own
    samples of the same sky along its own pointing."""
    from maria_tpu.tod.tod import Pointing as RefPointing

    from maria_torch.sim.cmb import cmb_power_grids

    ref_sim, sim = scene["ref_vac"], scene["vac"]
    ref_obs, obs = ref_sim.obs_list[0], sim.obs_list[0]
    ref_P0, ref_dPdT = (float(np.asarray(x).ravel()[0]) for x in ref_sim._cmb_power_grids(ref_obs, ref_obs.instrument.dets.bands[0]))
    P0, dPdT = (float(x.ravel()[0]) for x in cmb_power_grids(obs, obs.instrument.dets.bands[0], "cpu"))
    assert P0 == pytest.approx(ref_P0, rel=2e-7)
    assert abs(dPdT - ref_dPdT) <= 2 * np.spacing(np.float32(P0)) / 1e-6
    sw = np.asarray(obs.instrument.dets.stokes_weight(), dtype=np.float32)
    ref_samples = np.asarray(scene["ref_cmb"].sample_stokes(RefPointing(ref_obs.boresight, ref_obs.offsets, ref_obs.q), sw))
    sky = np.float32(dPdT) * ref_samples
    expected = np.float32(P0) * sw[:, :1] + sky
    with reference_pointing(ref_obs):
        ours = sim._compute_cmb_loading(obs).numpy()
        draws = to_torch({"gains": np.asarray(jax.random.normal(jax.random.split(jax.random.key(SEED))[1], (217,)))})
        sim.noise = False
        try:
            tod = sim.run(units="pW", draws=[draws])[0]
        finally:
            sim.noise = True
    tol = dict(rtol=2e-7, atol=1e-5 * np.abs(sky).max())
    np.testing.assert_allclose(ours, expected, **tol)
    gains = np.exp(np.asarray(obs.instrument.dets.gain_error, np.float32) * draws["gains"].numpy())[:, None]
    assert tod.fields == ["cmb"] and tod.metadata["atmosphere"] is False
    np.testing.assert_allclose(tod.data["cmb"].numpy(), gains * expected, **tol)


# -- the small AtLAST total ---------------------------------------------------------------------------


def test_total_power_carries_the_cmb_with_gains(tmp_path):
    """total_power_fn in both forms (the matrix-product noise and the
    fields route) on a small AtLAST (the nine atlast bands, 19 detectors
    each, 10 s) with a CMB sky 1e6 times brighter: the total minus a
    CMB-free total on the same draws is gains x the "cmb" field, to 1e-5
    of its maximum. At its natural brightness the field's anisotropy lies
    under the float32 rounding of the totals."""
    from maria_torch.ops.program import build_tod_program

    old = maria_torch.io._cache_state["base"]
    maria_torch.set_cache_dir(str(tmp_path))
    try:
        bands = [f"atlast/f{b}" for b in ("042", "093", "150", "220", "280", "350", "400", "650", "850")]
        inst = maria_torch.get_instrument(array={"primary_size": 50, "n": 19, "field_of_view": 2.0,
                                                 "shape": "circle", "bands": bands})
        plan = maria_torch.get_plan("daisy_5arcmin_60s", start_time=T0, scan_center=(150.0, 41.0), frame="az/el",
                                    duration=10.0, sample_rate=50.0, scan_options={"radius": 0.5, "speed": 0.25})
        sim = maria_torch.Simulation(instrument=inst, plans=plan, site="ALMA", atmosphere="3d", seed=0, device="cpu",
                                     cmb="generate", cmb_kwargs={"nside": 16})
        bright = sim.cmb._replace(data=sim.cmb.data * 1e6)
        obs = sim.obs_list[0]
        kw = dict(noise_kwargs=sim.noise_kwargs, device="cpu")
        program, bare = build_tod_program(obs, cmb=bright, **kw), build_tod_program(obs, **kw)
        assert sim.program().bands[0].cmb_samples is not None and bare.bands[0].cmb_samples is None
        g = torch.Generator().manual_seed(11)
        draws = {"groups": [torch.randn((2 * gr.W.shape[0], gr.ny, gr.nx // 2 + 1, 2), generator=g)
                            for gr in program.groups],
                 "gains": torch.randn((program.n_det,), generator=g)}
        m = program._noise_matmul_specs()[2] // 2
        draws["v"] = torch.randn((program.n_det, 2, m + 1), generator=g)
        draws["modes"] = [torch.randn((b.noise_basis.shape[1], 2, m + 1), generator=g) if b.corr_prop else None
                          for b in program.bands]
        signal = program.fields(draws=draws, device="cpu", upto="signal")
        assert sorted(signal) == ["atmosphere", "cmb"]
        expected = (program.draw_gains(draw=draws["gains"], device="cpu") * signal["cmb"]).double()
        scale = float(expected.abs().max())
        for form in ("matmul", "fields"):
            if form == "fields":
                program.with_noise = bare.with_noise = False
            assert program.use_noise_matmul() == (form == "matmul")
            with_cmb = program.total_power_fn()(draws=draws, device="cpu").double()
            without = bare.total_power_fn()(draws=draws, device="cpu").double()
            assert float((with_cmb - without - expected).abs().max()) <= 1e-5 * scale, form
    finally:
        maria_torch.set_cache_dir(old)
