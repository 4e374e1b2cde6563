"""The port's frames, plans and Planner against maria_tpu, on the CPU.

Both packages compute the frame transforms on the host in float64 from
the same closed-form ephemeris, so the comparisons are tight (1e-12 rad
unless a test says otherwise); inputs are made with numpy from a seed.
The device-side pointing (``Pointing.det_radec``) is float32 on both
sides and is held to 2e-6 rad.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import maria_torch  # noqa: E402
import maria_tpu  # noqa: E402
from maria_torch import coords as tc  # noqa: E402
from maria_torch.coords import ephemeris as teph  # noqa: E402
from maria_tpu import coords as rc  # noqa: E402
from maria_tpu.coords import ephemeris as reph  # noqa: E402

T0 = 1.75e9
SITES = ["GBT", "ALMA"]
TOL = 1e-12  # rad, float64 on both sides
DAISY = dict(scan_pattern="daisy", scan_options={"radius": 0.083, "speed": 0.017})


def day_times(n=97, seed=0):
    """n sorted times over one day from T0, seeded."""
    return T0 + np.sort(np.random.default_rng(seed).uniform(0, 86400.0, n))


def locations(site):
    ref, ours = maria_tpu.get_site(site).earth_location, maria_torch.get_site(site).earth_location
    assert (ours.lat_deg, ours.lon_deg, ours.height_m) == (ref.lat_deg, ref.lon_deg, ref.height_m)
    assert ours.lat == ref.lat and ours.lon == ref.lon
    return ref, ours


def both_coords(site, frame, seed=1, shape=(3,)):
    """The same seeded pointing over a day as both packages' Coordinates."""
    rng = np.random.default_rng(seed)
    t = day_times(seed=seed)
    phi = rng.uniform(0, 2 * np.pi, shape + t.shape)
    theta = rng.uniform(np.radians(20), np.radians(85), shape + t.shape)
    ref_loc, loc = locations(site)
    return (rc.Coordinates(phi=phi, theta=theta, t=t, earth_location=ref_loc, frame=frame),
            tc.Coordinates(phi, theta, t, earth_location=loc, frame=frame))


def angle_diff(a, b):
    return np.abs((np.asarray(a) - np.asarray(b) + np.pi) % (2 * np.pi) - np.pi).max()


# -- ephemeris ----------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["earth_rotation_angle", "gmst", "gast", "icrs_to_tod_matrix",
                                "earth_velocity_over_c"])
def test_ephemeris_functions_of_time(fn):
    t = day_times()
    np.testing.assert_allclose(getattr(teph, fn)(t), getattr(reph, fn)(t), rtol=0, atol=TOL)


@pytest.mark.parametrize("fn", ["mean_obliquity", "precession_matrix", "nutation_matrix"])
def test_ephemeris_functions_of_centuries(fn):
    T = reph.julian_centuries_tt(day_times())
    np.testing.assert_array_equal(teph.julian_centuries_tt(day_times()), T)
    np.testing.assert_allclose(getattr(teph, fn)(T), getattr(reph, fn)(T), rtol=0, atol=TOL)


@pytest.mark.parametrize("site", SITES)
def test_enu_to_tod_matrix(site):
    ref_loc, loc = locations(site)
    t = day_times()
    ours = teph.enu_to_tod_matrix(t, loc.lat, loc.lon)
    np.testing.assert_allclose(ours, reph.enu_to_tod_matrix(t, ref_loc.lat, ref_loc.lon), rtol=0, atol=TOL)
    # a rotation at every timestamp
    np.testing.assert_allclose(np.einsum("tij,tkj->tik", ours, ours), np.broadcast_to(np.eye(3), ours.shape),
                               atol=1e-14)


def test_ephemeris_constants():
    np.testing.assert_array_equal(teph.ICRS_TO_GAL, reph.ICRS_TO_GAL)
    np.testing.assert_array_equal(teph.FRAME_BIAS, reph.FRAME_BIAS)
    assert teph.TT_MINUS_UTC == reph.TT_MINUS_UTC and teph.UNIX_J2000 == reph.UNIX_J2000


def test_frames_and_aliases():
    assert tc.FRAMES == rc.FRAMES
    for name, config in rc.FRAMES.items():
        for alias in (name, *config["aliases"]):
            assert tc.parse_frame(alias) == rc.parse_frame(alias) == name
            assert tc.Frame(alias) == name and tc.Frame(alias).phi_name == config["phi_name"]
    with pytest.raises(ValueError, match="Invalid frame"):
        tc.parse_frame("ecliptic")


# -- Coordinates ------------------------------------------------------------------------


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("frame", ["az/el", "ra/dec", "galactic"])
def test_coordinates_frames_match(site, frame):
    """From each native frame, every frame's angles over a day."""
    ref, ours = both_coords(site, frame)
    for attr in ("az", "el", "ra", "dec", "l", "b"):
        assert getattr(ours, attr).shape == (3, 97)
        assert angle_diff(getattr(ours, attr), getattr(ref, attr)) <= TOL, attr


@pytest.mark.parametrize("site", SITES)
def test_coordinates_round_trip(site):
    """az/el -> ra/dec -> az/el and -> galactic -> ra/dec come back. The
    aberration step is inverted to first order in the Earth's v/c (1e-4),
    so the az/el round trip closes to 1e-7 rad, as maria_tpu's does; the
    galactic rotation closes to rounding."""
    ref, ours = both_coords(site, "az/el", seed=2)
    loc = ours.earth_location
    back = tc.Coordinates(ours.ra, ours.dec, ours.t, earth_location=loc, frame="ra/dec")
    assert angle_diff(back.az, ours.az) * np.cos(ours.el).min() <= 1e-7 and angle_diff(back.el, ours.el) <= 1e-7
    ref_back = rc.Coordinates(phi=ref.ra, theta=ref.dec, t=ref.t, earth_location=ref.earth_location, frame="ra/dec")
    assert angle_diff(back.az, ref_back.az) <= TOL and angle_diff(back.el, ref_back.el) <= TOL
    gal = tc.Coordinates(ours.l, ours.b, ours.t, earth_location=loc, frame="galactic")
    assert angle_diff(gal.ra, ours.ra) <= 1e-13 and angle_diff(gal.dec, ours.dec) <= 1e-13


@pytest.mark.parametrize("frame", ["az/el", "ra/dec", "galactic"])
def test_coordinates_center_offsets_broadcast(frame):
    ref, ours = both_coords("GBT", "az/el", seed=3, shape=())
    c_ref, c = ref.center(frame=frame), ours.center(frame=frame)
    np.testing.assert_allclose(c, [float(np.asarray(x)) for x in c_ref], rtol=0, atol=TOL)
    np.testing.assert_allclose(ours.offsets(frame=frame), ref.offsets(frame=frame), rtol=0, atol=TOL)
    np.testing.assert_allclose(ours.offsets(frame=frame, center=(1.0, 0.5)),
                               ref.offsets(frame=frame, center=(1.0, 0.5)), rtol=0, atol=TOL)
    offsets = np.random.default_rng(4).uniform(-0.01, 0.01, (5, 2))
    b_ref, b = ref.broadcast(offsets, frame=frame), ours.broadcast(offsets, frame=frame)
    assert b.shape == (5, 97) and b.frame == frame
    for attr in ("az", "el", "ra", "dec"):
        assert angle_diff(getattr(b, attr), getattr(b_ref, attr)) <= TOL
    assert angle_diff(b[1:3].ra, b_ref[1:3].ra) <= TOL and b[1:3].shape == (2, 97)


def test_coordinates_downsample_and_infer_geometry():
    t = T0 + np.arange(0, 60.0, 0.02)
    rng = np.random.default_rng(5)
    az = np.radians(150) + 1e-3 * np.cumsum(rng.standard_normal(len(t))) / 30
    el = np.radians(41) + 1e-3 * np.cumsum(rng.standard_normal(len(t))) / 30
    ref_loc, loc = locations("GBT")
    ref = rc.Coordinates(phi=az, theta=el, t=t, earth_location=ref_loc, frame="az/el")
    ours = tc.Coordinates(az, el, t, earth_location=loc, frame="az/el")
    assert ours.timestep == ref.timestep
    d_ref, d = ref.downsample(timestep=0.5), ours.downsample(timestep=0.5)
    np.testing.assert_array_equal(d.t, d_ref.t)
    for attr in ("az", "el", "ra", "dec"):
        assert angle_diff(getattr(d, attr), getattr(d_ref, attr)) <= TOL
    np.testing.assert_array_equal(ours.downsample(factor=25).t, ref.downsample(factor=25).t)
    for frame in ("az/el", "ra/dec"):
        (c_ref, w_ref, h_ref) = rc.infer_center_width_height([ref, d_ref], frame=frame)
        (c, w, h) = tc.infer_center_width_height([ours, d], frame=frame)
        np.testing.assert_allclose([*c, w, h], [*c_ref, w_ref, h_ref], rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="last axis"):
        tc.Coordinates(np.zeros((2, 3)), np.zeros((2, 3)), T0 + np.arange(6.0).reshape(2, 3))


# -- plans and the Planner ----------------------------------------------------------------


def both_plans(site="GBT", frame="ra/dec", duration=20.0, center=(150.0, 10.0), start=T0, **kw):
    args = dict(start_time=start, duration=duration, sample_rate=50.0, frame=frame, scan_center=center, **DAISY, **kw)
    return maria_tpu.Plan.generate(site=site, **args), maria_torch.Plan.generate(site=site, **args)


@pytest.mark.parametrize("frame", ["az/el", "ra/dec", "galactic"])
def test_plan_generate_in_every_frame(frame):
    ref, ours = both_plans(frame=frame, center=(150.0, 41.0))
    assert ours.frame == frame and ours.n == ref.n == 1000
    np.testing.assert_array_equal(ours.time, ref.time)
    for attr in ("az", "el", "ra", "dec"):
        assert angle_diff(getattr(ours, attr), getattr(ref, attr)) <= TOL
    assert ours.duration == float(ref.duration.s) and ours.sample_rate == float(ref.sample_rate.Hz)
    assert (ours.start_time, ours.end_time) == (ref.start_time, ref.end_time)
    np.testing.assert_allclose(ours.offsets(), ref.offsets(), rtol=0, atol=TOL)


def test_plan_jitter_and_date_strings():
    ref, ours = both_plans(jitter=0.001, start="2025-06-01T03:00:00")
    assert ours.start_time == ref.start_time == maria_torch.plan.parse_time("2025-06-01T03:00:00Z")
    assert angle_diff(ours.ra, ref.ra) <= TOL and angle_diff(ours.dec, ref.dec) <= TOL
    assert maria_torch.plan.parse_time(12) == 12.0
    with pytest.raises(ValueError, match="Cannot parse"):
        maria_torch.plan.parse_time([1])
    ref, ours = maria_tpu.Plan.generate(scan_pattern="raster", start_time=T0), \
        maria_torch.Plan.generate(scan_pattern="raster", start_time=T0)  # every pattern is ported
    assert angle_diff(ours.ra, ref.ra) <= TOL and angle_diff(ours.dec, ref.dec) <= TOL
    with pytest.raises(ValueError, match="Invalid scan pattern"):
        maria_torch.Plan.generate(scan_pattern="spiral")


def test_plan_add_and_plan_list():
    from maria_tpu.plan import PlanList as RefPlanList

    starts = (T0, T0 + 30.0, T0 + 400.0)
    pairs = [both_plans(start=s, duration=10.0) for s in starts]
    ref_sum, ours_sum = pairs[0][0] + pairs[1][0], pairs[0][1] + pairs[1][1]
    assert ours_sum.n == ref_sum.n == 1000 and ours_sum.frame == "ra/dec"
    np.testing.assert_array_equal(ours_sum.time, ref_sum.time)
    assert angle_diff(ours_sum.az, ref_sum.az) <= TOL
    with pytest.raises(ValueError, match="overlap"):
        pairs[1][1] + pairs[0][1]
    ref_list, ours_list = RefPlanList([p[0] for p in pairs]), maria_torch.PlanList([p[1] for p in pairs])
    assert ours_list.plan_groups() == ref_list.plan_groups() == [[0, 1], [2]]
    assert len(ours_list.group_plans()) == 2 and ours_list.group_plans()[0].n == 1000
    assert (ours_list.start_time, ours_list.end_time) == (ref_list.start_time, ref_list.end_time)


@pytest.mark.parametrize("site,target,frame,constraints", [
    ("GBT", (150.0, 10.0), "ra/dec", None),
    ("ALMA", (150.0, -30.0), "ra/dec", {"el": (40.0, 80.0), "min_sun_distance": 30.0}),
    ("GBT", (250.0, 30.0), "ra/dec", {"az": (90.0, 270.0), "hour": (20.0, 6.0)}),
    ("ALMA", (280.0, -10.0), "galactic", {"min_sun_distance": 45.0}),
])
def test_planner_feasible_and_plans(site, target, frame, constraints):
    from maria_tpu.plan import Planner as RefPlanner
    from maria_tpu.plan.planner import sun_ra_dec as ref_sun

    from maria_torch.plan.planner import sun_ra_dec

    ref = RefPlanner(target=target, site=site, frame=frame, constraints=constraints)
    ours = maria_torch.Planner(target=target, site=site, frame=frame, constraints=constraints)
    assert ours.constraints == ref.constraints
    t = T0 + np.arange(0, 2 * 86400.0, 600.0)
    np.testing.assert_allclose(sun_ra_dec(t), ref_sun(t), rtol=0, atol=TOL)
    mask = ours.feasible(t)
    np.testing.assert_array_equal(mask, ref.feasible(t))
    assert 0 < mask.sum() < len(t)
    kw = dict(start_time=T0, horizon_days=2, total_duration=90.0, chunk_duration=30.0, sample_rate=50, **DAISY)
    ref_plans, plans = ref.generate_plans(**kw), ours.generate_plans(**kw)
    assert len(plans) == len(ref_plans) == 3
    for a, b in zip(plans, ref_plans):
        np.testing.assert_array_equal(a.time, b.time)
        assert a.frame == frame
        for attr in ("az", "el", "ra", "dec"):
            assert angle_diff(getattr(a, attr), getattr(b, attr)) <= TOL
    one_ref, one = ref.generate_plan(total_duration=40.0, **{k: kw[k] for k in ("start_time", "sample_rate")}, **DAISY), \
        ours.generate_plan(total_duration=40.0, **{k: kw[k] for k in ("start_time", "sample_rate")}, **DAISY)
    np.testing.assert_array_equal(one.time, one_ref.time)


def test_planner_on_a_map_and_no_plans():
    from maria_tpu.plan import Planner as RefPlanner

    ref_map = maria_tpu.map.get("big_cluster", fetch_first=False, center=(150.0, 10.0))
    our_map = maria_torch.map.get("big_cluster", center=(150.0, 10.0))
    ref, ours = RefPlanner(target=ref_map, site="GBT"), maria_torch.Planner(target=our_map, site="GBT")
    np.testing.assert_allclose(ours.target, ref.target, rtol=0, atol=1e-15)
    assert ours.frame == ref.frame == "ra/dec"
    never = maria_torch.Planner(target=(150.0, -80.0), site="GBT")
    with pytest.raises(maria_torch.plan.NoSuitablePlansError):
        never.generate_plans(start_time=T0, horizon_days=1, total_duration=60.0)


# -- the observation's pointing ----------------------------------------------------------


@pytest.fixture(scope="module", params=[("GBT", "ra/dec", (150.0, 10.0)), ("ALMA", "az/el", (150.0, 41.0))],
                ids=["gbt-radec", "alma-azel"])
def observations(request):
    """Both packages' Observation of MUSTANG-2 on the same Planner-made
    (ra/dec) or generated (az/el) 20 s plan."""
    from maria_tpu.sim.observation import Observation as RefObservation

    from maria_torch.sim.observation import Observation

    site, frame, center = request.param
    if frame == "ra/dec":
        kw = dict(start_time=T0, horizon_days=2, total_duration=20.0, chunk_duration=20.0, sample_rate=50, **DAISY)
        ref_plan = maria_tpu.plan.Planner(target=center, site=site).generate_plans(**kw)[0]
        plan = maria_torch.Planner(target=center, site=site).generate_plans(**kw)[0]
    else:
        ref_plan, plan = both_plans(site=site, frame=frame, center=center)
    ref = RefObservation(maria_tpu.get_instrument("MUSTANG-2"), ref_plan, maria_tpu.get_site(site))
    ours = Observation(maria_torch.get_instrument("MUSTANG-2"), plan, maria_torch.get_site(site))
    return ref, ours


def test_observation_boresight_and_q(observations):
    """q(t) comes from a 1e-5 rad probe, which divides the transforms'
    rounding (1e-16) by 1e-5: held to 1e-9 rad."""
    ref, ours = observations
    assert ours.boresight.frame == ref.boresight.frame.name
    for attr in ("az", "el", "ra", "dec"):
        assert angle_diff(getattr(ours.boresight, attr), getattr(ref.boresight, attr)) <= TOL
    np.testing.assert_allclose(ours.offsets, ref.offsets, rtol=0, atol=1e-15)
    assert ours.q.shape == ref.q.shape == (1000,)
    assert angle_diff(ours.q, ref.q) <= 1e-9
    assert np.ptp(ours.q) > 1e-5  # the sky rotates over the scan


def test_det_radec_and_det_azel(observations):
    """Detector pointing in float32: 2e-6 rad (an ulp at ra 2.6 rad is
    2.4e-7). ``idx`` selects detectors."""
    from maria_tpu.tod.tod import Pointing as RefPointing

    from maria_torch.tod import Pointing

    ref, ours = observations
    ref_p, p = RefPointing(ref.boresight, ref.offsets, ref.q), Pointing(ours.boresight, ours.offsets, ours.q)
    ra, dec = p.det_radec(device="cpu")
    ref_ra, ref_dec = (np.asarray(x) for x in ref_p.det_radec())
    assert ra.shape == (217, 1000) and ra.dtype == torch.float32
    assert angle_diff(ra.numpy(), ref_ra) <= 2e-6 and angle_diff(dec.numpy(), ref_dec) <= 2e-6
    az, el = p.det_azel(device="cpu")
    ref_az, ref_el = (np.asarray(x) for x in ref_p.det_azel())
    assert angle_diff(az.numpy(), ref_az) <= 2e-6 and angle_diff(el.numpy(), ref_el) <= 2e-6
    np.testing.assert_allclose(p.offsets_radec(device="cpu").numpy(), ref_p.offsets_radec(), rtol=0, atol=1e-9)
    idx = np.array([3, 50, 216])
    np.testing.assert_array_equal(p.det_radec(device="cpu", idx=idx)[0].numpy(), ra.numpy()[idx])
    # the known fault this port shares with maria_tpu (ROADMAP queue 3, hazard 3): az/el and ra/dec have
    # opposite handedness on the sky, so the exact map of the offsets is R(q) after a mirror of x. The
    # rotation alone places each detector where its mirror image belongs: exact to 3e-6 rad for the
    # mirrored focal plane, off by the offsets themselves (1e-3 rad) for the true one.
    mirrored = ours.boresight.broadcast(ours.offsets[idx] * np.array([-1.0, 1.0]), frame="az/el")
    assert angle_diff(ra.numpy()[idx], mirrored.ra) * np.cos(mirrored.dec).min() <= 3e-6
    assert angle_diff(dec.numpy()[idx], mirrored.dec) <= 3e-6
    true = ours.boresight.broadcast(ours.offsets[idx], frame="az/el")
    assert angle_diff(dec.numpy()[idx], true.dec) > 1e-4
    with pytest.raises(ValueError, match="without the frame-rotation"):
        Pointing(ours.boresight, ours.offsets).det_radec()


def test_convert_plan_from_arrays(observations):
    """A maria_tpu plan carried over as arrays gives the port the same
    boresight."""
    from maria_torch.convert import plan_from_arrays

    ref, ours = observations
    rp = ref.plan
    plan = plan_from_arrays(time=np.asarray(rp.time), phi=np.asarray(getattr(rp, rp.frame.phi_name)),
                            theta=np.asarray(getattr(rp, rp.frame.theta_name)), frame=rp.frame.name,
                            site=rp.site.name, roll=rp.roll)
    assert plan.frame == ours.plan.frame
    for attr in ("az", "el", "ra", "dec"):
        assert angle_diff(getattr(plan, attr), getattr(ref.plan, attr)) <= TOL
