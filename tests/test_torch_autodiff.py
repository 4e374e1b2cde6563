"""The port's program as a differentiable function of the pointing, on CPU.

maria_torch's ``TODProgram.total_power_fn()``, ``fields`` and
``fields_fn`` take the detector offsets and the coarse boresight track as
tensors and a seed as the realization's handle, as maria_tpu's
``(key, offsets, bs_az_c, bs_el_c)`` functions do (docs/differentiability.md).

- (i) tests/test_autodiff.py's three cases on the port's own scene (the
  test/1deg camera on a mid-elevation daisy, the 2-D atmosphere): finite
  nonzero gradients, a directional derivative against a central
  difference, and the pointing-calibration descent, at that test's
  gates;
- (ii) the port's gradient against ``jax.grad`` on the same draws (the
  JAX key stream reproduced by tests/torch_jax_stream.py): the 2-D
  Fourier scene, the 2-D AR scene of tests/test_torch_ar.py with the
  extrusion's normals handed in, and a 3-D screen group at the stage
  level against maria_tpu's exact sampler (``bs_px=None``);
- (iii) ``NEP_per_loading`` on the fields route, whose gradient flows
  through the noise scale, against maria_tpu's fields route;
- (iv) a detector at the array centre, (0, 0), keeps the gradient finite;
- (v) the program's own pointing handed in gives the bits of a call given
  none, and ``rows=`` the rows of the whole;
- (vi) one seed gives one realization, inside ``torch.enable_grad()``
  and out of it; and a backward through every stage (atmosphere, CMB,
  input map, noise) on both routes.

The gradients are those of sum(w * output) for fixed random weights w,
compared as the relative L2 norm of their difference over every detector
and coordinate. The samplers are piecewise linear, and their slope jumps
at a cell's edge. Computed in float32 at ~3 km, a line of sight's
position in a screen is quantized to ~1e-4 of a cell, so ~1e-3 of the
samples lie exactly on an edge, where the packages take different
one-sided slopes (the port's floor takes the cell above; maria_tpu's hat
weights average the two cells), and an ulp of pointing can move a sample
across an edge. So the weights are zero on the samples whose line of
sight lies within EDGE_CELLS of an edge of any screen or layer (and on
the fine samples that interpolate them): over the rest the gradients are
held to GRAD_RTOL, and the share left out is held under MAX_EDGE_SHARE.
Each test states its tolerance.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import maria_torch  # noqa: E402
import maria_tpu  # noqa: E402
from maria_tpu.io import caching as tpu_caching  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_jax_stream import program_key_draws, to_torch  # noqa: E402

GRAD_RTOL = 1e-3  # the relative L2 norm of the difference of two gradients
EDGE_CELLS = 1e-4  # a line of sight this close to a cell's edge (in cells) is left out of the comparison
MAX_EDGE_SHARE = 0.1  # the largest share of the samples left out so
TINY_PLAN = dict(scan_pattern="daisy", start_time=1.75e9, scan_center=(150.0, 50.0), frame="az/el", duration=10,
                 sample_rate=20, scan_options={"radius": 0.25, "speed": 0.1})
TINY_KW = dict(instrument="test/1deg", site="green_bank", atmosphere="2d", noise=False, seed=7)
M2_PLAN = dict(start_time=1.75e9, scan_center=(150.0, 41.0), frame="az/el", duration=10.0, sample_rate=50.0,
               scan_options={"radius": 0.083, "speed": 0.017})
ATLAST_ARRAY = {"primary_size": 50, "n": 19, "field_of_view": 2.0, "shape": "circle",
                "bands": ["atlast/f150", "atlast/f850"]}


def rel_l2(ours, ref):
    ours, ref = np.asarray(ours, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    return float(np.linalg.norm(ours - ref) / np.linalg.norm(ref))


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    old_tpu, old_torch = tpu_caching.get_cache_dir(), maria_torch.io._cache_state["base"]
    maria_tpu.set_cache_dir(str(tmp_path_factory.mktemp("maria_tpu_cache")))
    maria_torch.set_cache_dir(str(tmp_path_factory.mktemp("maria_torch_cache")))
    yield
    maria_tpu.set_cache_dir(old_tpu)
    maria_torch.set_cache_dir(old_torch)


@pytest.fixture(scope="module")
def tiny(caches):
    """tests/test_autodiff.py's scene: maria_tpu's program, the same
    program carried into the port, and the port's own build."""
    from maria_tpu.ops.program import build_tod_program as ref_build
    from test_torch_slice import program_tables

    from maria_torch.convert import program_from_tables
    from maria_torch.ops.program import build_tod_program

    ref_plan = dict(TINY_PLAN)
    ref_sim = maria_tpu.Simulation(plans=maria_tpu.get_plan(ref_plan.pop("scan_pattern"), **ref_plan), **TINY_KW)
    ref_program = ref_build(ref_sim.obs_list[0], with_noise=False, noise_kwargs={})
    sim = maria_torch.Simulation(plans=maria_torch.plan.Plan.generate(**TINY_PLAN), device="cpu", **TINY_KW)
    return {"ref_program": ref_program, "carried": program_from_tables(program_tables(ref_program)),
            "program": build_tod_program(sim.obs_list[0], with_noise=False, noise_kwargs={}, device="cpu")}


@pytest.fixture(scope="module")
def mustang(caches):
    """tests/test_torch_slice.py's MUSTANG-2 scene with noise (the matrix
    product's route), both packages."""
    from maria_tpu.ops.program import build_tod_program

    kw = dict(instrument="MUSTANG-2", site="GBT", atmosphere="2d", noise=True, seed=0)
    ref_sim = maria_tpu.Simulation(plans=maria_tpu.get_plan("daisy_5arcmin_60s", **M2_PLAN), **kw)
    sim = maria_torch.Simulation(plans=maria_torch.get_plan("daisy_5arcmin_60s", **M2_PLAN), device="cpu", **kw)
    return {"ref_program": build_tod_program(ref_sim.obs_list[0], noise_kwargs=ref_sim.noise_kwargs),
            "program": sim.program()}


def near_cell_edges(program, offsets, bs_az, bs_el):
    """(n_det, n_tc) bool: the coarse samples whose line of sight lies
    within EDGE_CELLS of a cell edge of any screen or group layer of
    ``program``, the positions computed as atmosphere/sampling.py does."""
    from maria_torch.ops.program import line_of_sight

    _, _, px, py = line_of_sight(*(torch.as_tensor(np.asarray(a, dtype=np.float32)) for a in (offsets, bs_az, bs_el)))
    t = torch.as_tensor(np.asarray(program.t_coarse, dtype=np.float32))
    layers = [(s.h, s.angle, s.vx, s.vy, s.res, s.ty_res if s.ty_res is not None else s.res, s.tx_min, s.ty_min)
              for s in program.screens]
    layers += [(float(h), g.angle, g.vx, g.vy, g.res, g.res, g.tx_min, g.ty_min)
               for g in program.groups for h in g.heights]
    near = torch.zeros(px.shape, dtype=torch.bool)
    for h, angle, vx, vy, res_x, res_y, x0, y0 in layers:
        x, y = h * px + vx * t, h * py + vy * t
        ca, sa = float(np.cos(angle)), float(np.sin(angle))
        fx, fy = (ca * x + sa * y - x0) / res_x, (-sa * x + ca * y - y0) / res_y
        near |= ((fx - fx.round()).abs() < EDGE_CELLS) | ((fy - fy.round()).abs() < EDGE_CELLS)
    return near.numpy()


def edge_free_weights(program, ref_program, seed, fine=True):
    """Random N(0, 1) weights over the (n_det, n_t) output (the coarse
    (n_det, n_tc) one with ``fine=False``), zero where a sample lies near
    a cell edge (``near_cell_edges`` at maria_tpu's pointing) and, at the
    fine rate, on every sample that the cubic upsampling interpolates from
    such a coarse sample (fine cell k reads coarse steps k-1..k+2)."""
    near = near_cell_edges(program, ref_program.offsets, ref_program.bs_az_coarse, ref_program.bs_el_coarse)
    if fine:
        n_tc = near.shape[1]
        pad = np.pad(near, ((0, 0), (2, 2)))
        near = np.any([pad[:, k:k + n_tc] for k in range(5)], axis=0)
        near = near[:, np.minimum(np.arange(program.n_t) // program.upsample_ratio, n_tc - 1)]
    share = float(near.mean())
    assert share <= MAX_EDGE_SHARE, share
    w = np.random.default_rng(seed).standard_normal(near.shape).astype(np.float32)
    return np.where(near, np.float32(0), w)


def port_args(ref_program):
    """maria_tpu's pointing as float32 tensors for the port, requiring a gradient."""
    return [torch.tensor(np.asarray(a, dtype=np.float32), requires_grad=True)
            for a in (ref_program.offsets, ref_program.bs_az_coarse, ref_program.bs_el_coarse)]


def port_grads(fn, weights, args, **kw):
    """The gradients of sum(weights * fn(...)) in offsets, bs_az, bs_el."""
    offsets, bs_az, bs_el = args
    out = fn(offsets=offsets, bs_az=bs_az, bs_el=bs_el, device="cpu", **kw)
    return torch.autograd.grad((torch.as_tensor(weights) * out).sum(), (offsets, bs_az, bs_el))


def jax_grads(fn, weights, ref_program):
    """The gradients of sum(weights * fn(offsets, bs_az, bs_el)) by jax.grad."""
    args = [jnp.asarray(a, dtype=jnp.float32)
            for a in (ref_program.offsets, ref_program.bs_az_coarse, ref_program.bs_el_coarse)]
    w = jnp.asarray(weights)
    return jax.jit(jax.grad(lambda *a: jnp.sum(w * fn(*a)), argnums=(0, 1, 2)))(*args)


# -- (i) tests/test_autodiff.py on the port ---------------------------------------------------------


def test_grad_through_full_synthesis(tiny):
    """The gradient of a TOD functional in the detector offsets is finite
    and nonzero: the chain runs through the pointing's trigonometry, the
    screen samplers, the band tables and the upsampling."""
    program = tiny["program"]
    seed, offsets, bs_az, bs_el = program.example_args(0, device="cpu")
    offsets.requires_grad_(True)
    total = program.total_power_fn()(seed=seed, offsets=offsets, bs_az=bs_az, bs_el=bs_el, device="cpu")
    (g,) = torch.autograd.grad((total**2).mean(), offsets)
    assert g.shape == offsets.shape
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


def test_grad_matches_finite_difference(tiny):
    """The directional derivative of the calibration mismatch against a
    reference TOD agrees with a central difference within 10%, with the
    JAX test's step: eps 2e-5 sits above the float32 floor of a loss
    that is near zero at the operating point."""
    program = tiny["program"]
    seed, offsets_true, bs_az, bs_el = program.example_args(1, device="cpu")
    fn = program.total_power_fn()
    observed = fn(seed=seed, offsets=offsets_true, bs_az=bs_az, bs_el=bs_el, device="cpu")

    def loss(offsets):
        return ((fn(seed=seed, offsets=offsets, bs_az=bs_az, bs_el=bs_el, device="cpu") - observed) ** 2).mean()

    rng = np.random.default_rng(0)
    x = offsets_true + torch.as_tensor(np.radians(0.3 / 60.0) * rng.standard_normal(offsets_true.shape)
                                       .astype(np.float32))
    v = rng.standard_normal(offsets_true.shape).astype(np.float32)
    v = torch.as_tensor(v / np.linalg.norm(v))
    x.requires_grad_(True)
    (g,) = torch.autograd.grad(loss(x), x)
    analytic = float((g * v).sum())
    eps = 2e-5
    with torch.no_grad():
        fd = (float(loss(x + eps * v)) - float(loss(x - eps * v))) / (2 * eps)
    assert np.isfinite(analytic) and np.isfinite(fd)
    assert abs(analytic - fd) < 0.1 * (abs(analytic) + abs(fd) + 1e-12), (analytic, fd)


def test_gradient_pointing_calibration(tiny):
    """Recover a 2-arcminute error in one detector's offset along eta by
    descending its own row's mismatch, with maria_tpu's normalized,
    backtracking step: the loss ends under 0.3 of its start and the error
    under 0.5 of its start (tests/test_autodiff.py:100-139's gates)."""
    program = tiny["program"]
    seed, offsets_true, bs_az, bs_el = program.example_args(2, device="cpu")
    fn = program.total_power_fn()
    observed = fn(seed=seed, offsets=offsets_true, bs_az=bs_az, bs_el=bs_el, device="cpu")
    det = 3
    p_true = offsets_true[det]
    p0 = p_true + torch.as_tensor(np.radians(np.array([0.0, -2.0]) / 60.0), dtype=torch.float32)

    def loss(p):
        offsets = torch.cat([offsets_true[:det], p[None], offsets_true[det + 1:]])
        return ((fn(seed=seed, offsets=offsets, bs_az=bs_az, bs_el=bs_el, device="cpu")[det] - observed[det]) ** 2
                ).mean()

    def value_and_grad(p):
        p = p.detach().requires_grad_(True)
        value = loss(p)
        return float(value.detach()), torch.autograd.grad(value, p)[0]

    p = p0
    l0 = value_and_grad(p)[0]
    err0 = float(torch.linalg.norm(p0 - p_true))
    eta = 0.3 * err0
    for _ in range(30):
        value, g = value_and_grad(p)
        step = p - eta * g / max(float(torch.linalg.norm(g)), 1e-30)
        with torch.no_grad():
            l_new = float(loss(step))
        if l_new < value:
            p = step
            eta *= 1.3
        else:
            eta *= 0.5
    err1 = float(torch.linalg.norm(p - p_true))
    with torch.no_grad():
        l_end = float(loss(p))
    assert l_end < 0.3 * l0, (l_end, l0)
    assert err1 < 0.5 * err0, (err1, err0)


# -- (ii) against jax.grad --------------------------------------------------------------------------


def test_grad_matches_jax_fourier_2d(tiny):
    """The 2-D Fourier scene: maria_tpu's program carried into the port
    (maria_torch.convert.program_from_tables), the same screen and gain
    normals, the gradient of sum(w * total) in the offsets and the
    boresight track within 1e-3 (relative L2) of jax.grad's. maria_tpu
    samples a screen through a window that follows the boresight; inside
    it the values are the exact bilinear ones, and the window's integer
    origin carries no gradient."""
    ref_program, program = tiny["ref_program"], tiny["carried"]
    key = jax.random.key(11)
    draws = to_torch(program_key_draws(ref_program, key))
    w = edge_free_weights(program, ref_program, 3)
    ref_fn = ref_program.total_power_fn()
    ref = jax_grads(lambda *a: ref_fn(key, *a), w, ref_program)
    ours = port_grads(program.total_power_fn(), w, port_args(ref_program), draws=draws)
    for name, o, r in zip(("offsets", "bs_az", "bs_el"), ours, ref):
        assert o.shape == r.shape and bool(torch.isfinite(o).all())
        assert rel_l2(o, r) <= GRAD_RTOL, (name, rel_l2(o, r))


@pytest.fixture(scope="module")
def ar_scene(caches):
    """tests/test_torch_ar.py's 2-D AR scene (MUSTANG-2, a 10 s daisy,
    method="ar"), without noise, both packages."""
    from maria_tpu.ops.program import build_tod_program

    out = {}
    for name, pkg in (("ref", maria_tpu), ("ours", maria_torch)):
        plan = pkg.get_plan("daisy_5arcmin_60s", **M2_PLAN)
        kw = {} if pkg is maria_tpu else {"device": "cpu"}
        out[name] = pkg.Simulation(instrument="MUSTANG-2", plans=plan, site="GBT", atmosphere="2d",
                                   atmosphere_kwargs={"method": "ar"}, noise=False, seed=0, **kw)
    ref_program = build_tod_program(out["ref"].obs_list[0], with_noise=False, noise_kwargs={})
    return {"ref_program": ref_program, "program": out["ours"].program()}


def test_grad_matches_jax_ar(ar_scene):
    """The 2-D AR scene: the port given maria_tpu's pointing and the
    (buffer_init, innovations) normals its key draws for each of the
    eight processes; the gradient of sum(w * total) within 1e-3 (relative
    L2) of jax.grad's. The extruded screens are constants: the gradient
    flows through the samplers' weights, the band tables and the
    upsampling."""
    ref_program, program = ar_scene["ref_program"], ar_scene["program"]
    assert len(program.ar_processes) == 8 and not program.with_noise
    key = jax.random.key(12)
    draws = to_torch(program_key_draws(ref_program, key))
    assert len(draws["ar"]) == 8
    w = edge_free_weights(program, ref_program, 4)
    ref_fn = ref_program.total_power_fn()
    ref = jax_grads(lambda *a: ref_fn(key, *a), w, ref_program)
    ours = port_grads(program.total_power_fn(), w, port_args(ref_program), draws=draws)
    for name, o, r in zip(("offsets", "bs_az", "bs_el"), ours, ref):
        assert bool(torch.isfinite(o).all())
        assert rel_l2(o, r) <= GRAD_RTOL, (name, rel_l2(o, r))


def test_grad_matches_jax_3d_group_stage(caches):
    """A 3-D screen group at the stage level (tests/test_torch_atmosphere3d.py's
    scene: two AtLAST bands, 19 detectors each, ALMA): offsets and
    boresight -> each package's line of sight -> accumulate_pwv, the
    port's against maria_tpu's exact bilinear path (bs_px=None) under
    jax.grad on the same group draw; the gradient of sum(w * pwv) within
    1e-3 (relative L2). maria_tpu's default static-hat and decimated
    samplers approximate the values, and with them the gradient."""
    from maria_tpu.atmosphere.sampling import accumulate_pwv as ref_accumulate
    from maria_tpu.coords.transforms import offsets_to_phi_theta as ref_phi_theta
    from maria_tpu.ops.program import build_tod_program

    from maria_torch.atmosphere.sampling import accumulate_pwv
    from maria_torch.ops.program import line_of_sight

    kw = dict(site="ALMA", atmosphere="3d", noise=False, seed=0)
    ref_sim = maria_tpu.Simulation(instrument=maria_tpu.get_instrument(array=ATLAST_ARRAY),
                                   plans=maria_tpu.get_plan("daisy_5arcmin_60s", **dict(
                                       M2_PLAN, scan_options={"radius": 0.5, "speed": 0.25})), **kw)
    rp = build_tod_program(ref_sim.obs_list[0], with_noise=False, noise_kwargs={})
    assert len(rp.groups) == 1 and len(rp.groups[0].heights) == 12 and not rp.screens
    key = jax.random.key(13)
    t_c = np.asarray(rp.t_coarse, dtype=np.float32)

    def ref_pwv(offsets, bs_az, bs_el):
        pt = ref_phi_theta(offsets[:, None, :], bs_az, bs_el)
        el = jnp.clip(pt[..., 1], jnp.radians(5.0), jnp.pi / 2)
        px, py = jnp.sin(pt[..., 0]) / jnp.tan(el), jnp.cos(pt[..., 0]) / jnp.tan(el)
        return ref_accumulate(key, rp.mean_pwv, [], rp.groups, px, py, None, None, jnp.asarray(t_c))

    g = rp.groups[0]  # atmosphere/sampling.py:106: one key a group after the (no) screens
    group_draw = [torch.as_tensor(np.array(jax.random.normal(
        jax.random.split(key, 1)[0], (2 * g.W.shape[0], g.ny, g.nx // 2 + 1, 2), dtype=jnp.float32)))]

    def our_pwv(offsets, bs_az, bs_el, device):
        _, _, px, py = line_of_sight(offsets, bs_az, bs_el)
        return accumulate_pwv(rp.mean_pwv, [], px, py, torch.as_tensor(t_c), groups=rp.groups,
                              group_draws=group_draw)

    w = edge_free_weights(rp, rp, 5, fine=False)
    ref = jax_grads(ref_pwv, w, rp)
    ours = port_grads(our_pwv, w, port_args(rp))
    for name, o, r in zip(("offsets", "bs_az", "bs_el"), ours, ref):
        assert bool(torch.isfinite(o).all())
        assert rel_l2(o, r) <= GRAD_RTOL, (name, rel_l2(o, r))


# -- (iii) NEP_per_loading ---------------------------------------------------------------------------


def test_nep_per_loading_grad_matches_jax(mustang):
    """A band with NEP_per_loading takes the fields route in both
    packages, and its noise scale 1e12 (NEP + NEP_per_loading P) carries
    the gradient of the loading P; the noise draws carry none. The
    gradient of sum(w * total) on the same draws within 1e-3 (relative
    L2) of jax.grad's. At MUSTANG-2's NEP the term moves the gradient by
    ~5e-4 of itself (the noise is ~1e-4 of the loading), under the
    tolerance, so it is set to a thousand times the NEP at 3 pW here: the
    gradient then differs from the one without it by over 1e-2."""
    ref_program, program = mustang["ref_program"], mustang["program"]
    band, ref_band = program.bands[0], ref_program.bands[0]
    key = jax.random.key(14)
    draws = to_torch(program_key_draws(ref_program, key))
    w = edge_free_weights(program, ref_program, 6)
    band.NEP_per_loading = ref_band.NEP_per_loading = 1000 * band.NEP / 3e-12
    try:
        fn = program.total_power_fn()
        assert fn.__name__ == "fields_total"
        ref_fn = ref_program.total_power_fn()
        ref = jax_grads(lambda *a: ref_fn(key, *a), w, ref_program)
        ours = port_grads(fn, w, port_args(ref_program), draws=draws)
        band.NEP_per_loading = ref_band.NEP_per_loading = 0.0

        def fields_route(draws, **kw):  # fields_total's sum, on the same draws, without the term
            fields, _ = program.fields(draws=draws, **kw)
            gains = program.draw_gains(draw=draws["gains"], device="cpu")
            return sum(v if k == "noise" else v * gains for k, v in fields.items())

        without = port_grads(fields_route, w, port_args(ref_program), draws=draws)
    finally:
        band.NEP_per_loading = ref_band.NEP_per_loading = 0.0
    for name, o, r, o0 in zip(("offsets", "bs_az", "bs_el"), ours, ref, without):
        assert bool(torch.isfinite(o).all())
        assert rel_l2(o, r) <= GRAD_RTOL, (name, rel_l2(o, r))
        assert rel_l2(o0, r) > 10 * GRAD_RTOL, name  # the term moves the gradient


# -- (iv) a detector at the centre ------------------------------------------------------------------


def test_detector_at_the_centre_keeps_the_gradient_finite(tiny):
    """A detector at exactly (0, 0): the tangent-plane map's guarded sqrt
    (coords/transforms.py) keeps its gradient finite, and equal to
    jax.grad's of maria_tpu's map there; the program's gradient is finite
    for every detector."""
    from maria_tpu.coords.transforms import offsets_to_phi_theta as ref_phi_theta

    from maria_torch.coords import offsets_to_phi_theta

    centre = (np.float32(2.6), np.float32(0.7))
    x = torch.zeros(2, requires_grad=True)
    ours = torch.autograd.functional.jacobian(lambda d: offsets_to_phi_theta(d, *map(torch.tensor, centre)), x)
    ref = jax.jacobian(lambda d: ref_phi_theta(d, *centre))(jnp.zeros(2, dtype=jnp.float32))
    assert bool(torch.isfinite(ours).all())
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)

    program = tiny["program"]
    seed, offsets, bs_az, bs_el = program.example_args(0, device="cpu")
    offsets[0] = 0.0
    offsets.requires_grad_(True)
    total = program.total_power_fn()(seed=seed, offsets=offsets, bs_az=bs_az, bs_el=bs_el, device="cpu")
    (g,) = torch.autograd.grad((total**2).mean(), offsets)
    assert bool(torch.isfinite(g).all()) and float(g[0].abs().max()) > 0


# -- (v) the inputs handed in ----------------------------------------------------------------------


@pytest.mark.parametrize("route", ["matmul_total", "fields_total"])
def test_own_pointing_and_rows_are_bit_equal(tiny, mustang, route):
    """Handing a program its own pointing gives the bits of a call given
    none (``fields``, both totals); with ``rows=`` the offsets are handed
    in at their global shape, and the rows equal those rows of the whole,
    bit for bit (the matrix product's route: MUSTANG-2 with noise; the
    fields route: the test/1deg scene)."""
    program = mustang["program"] if route == "matmul_total" else tiny["program"]
    fn = program.total_power_fn()
    assert fn.__name__ == route
    seed, offsets, bs_az, bs_el = program.example_args(5, device="cpu")
    given = dict(offsets=offsets, bs_az=bs_az, bs_el=bs_el)
    whole = fn(seed=seed, device="cpu")
    assert torch.equal(fn(seed=seed, device="cpu", **given), whole)
    rows = (7, program.n_det - 11)
    assert torch.equal(fn(seed=seed, device="cpu", rows=rows, **given), whole[rows[0]:rows[1]])
    fields, pwv = program.fields(seed=seed, device="cpu")
    fields_given, pwv_given = program.fields_fn()(seed, device="cpu", **given)
    assert list(fields_given) == list(fields) and torch.equal(pwv_given, pwv)
    assert all(torch.equal(fields_given[k], fields[k]) for k in fields)
    moved = program.fields(seed=seed, device="cpu", upto="pwv", offsets=offsets + 1e-4)["pwv"]
    assert not torch.equal(moved, program.fields(seed=seed, device="cpu", upto="pwv")["pwv"])
    with pytest.raises(ValueError, match="offsets must have shape"):
        fn(seed=seed, device="cpu", offsets=offsets[1:])
    with pytest.raises(ValueError, match="a generator or a seed"):
        fn(generator=torch.Generator(), seed=seed, device="cpu")


def test_example_args_are_new_tensors(tiny):
    """``example_args`` gives the seed and new float32 tensors of the
    program's pointing: setting their gradient flag leaves the program's
    cached tables alone."""
    program = tiny["program"]
    seed, offsets, bs_az, bs_el = program.example_args(9, device="cpu")
    assert seed == 9 and offsets.dtype == bs_az.dtype == bs_el.dtype == torch.float32
    assert offsets.shape == (program.n_det, 2) and bs_az.shape == bs_el.shape == (len(program.t_coarse),)
    np.testing.assert_array_equal(offsets.numpy(), program.offsets)
    offsets.requires_grad_(True)
    assert not program._tensors(torch.device("cpu"))["offsets"].requires_grad


# -- (vi) one seed, one realization; every stage under autograd --------------------------------------


def test_one_seed_is_one_realization_with_and_without_grad(mustang):
    """Two calls on one seed are bit-equal, with the pointing requiring a
    gradient inside ``torch.enable_grad()`` and without it under
    ``torch.no_grad()``; another seed is another realization."""
    program = mustang["program"]
    fn = program.total_power_fn()
    seed, offsets, bs_az, bs_el = program.example_args(21, device="cpu")
    with torch.no_grad():
        a = fn(seed=seed, offsets=offsets, bs_az=bs_az, bs_el=bs_el, device="cpu")
        b = fn(seed=seed, device="cpu")
    offsets.requires_grad_(True)
    with torch.enable_grad():
        c = fn(seed=seed, offsets=offsets, bs_az=bs_az, bs_el=bs_el, device="cpu")
        d = fn(seed=seed, offsets=offsets, bs_az=bs_az, bs_el=bs_el, device="cpu")
    assert c.requires_grad and not a.requires_grad
    assert torch.equal(a, b) and torch.equal(a, c.detach()) and torch.equal(c, d)
    assert not torch.equal(a, fn(seed=seed + 1, device="cpu"))


@pytest.fixture(scope="module")
def sky_program(caches):
    """MUSTANG-2 on tests/test_torch_slice.py's daisy with the 2-D
    atmosphere, a CMB (nside 16) and a map over the scan: every stage of
    the program."""
    center = (150.0, 41.0)
    sim = maria_torch.Simulation(
        instrument="MUSTANG-2", plans=maria_torch.get_plan("daisy_5arcmin_60s", **M2_PLAN), site="GBT",
        atmosphere="2d", cmb="generate", cmb_kwargs={"nside": 16}, noise=True, seed=0, device="cpu",
        map=maria_torch.map.get("cluster", center=center, frame="az/el"),
    )
    return sim.program()


@pytest.mark.parametrize("route", ["matmul_total", "fields_total"])
def test_backward_through_every_stage(sky_program, route):
    """A backward through the atmosphere, the CMB and map stages and the
    noise on both routes: the in-place assemblies (the per-band index
    writes, the signal's sum, the noise product's epilogue) raise no
    autograd error, the gradient is finite and nonzero, and the forward
    equals the call without a gradient bit for bit."""
    program = sky_program
    band = program.bands[0]
    band.NEP_per_loading = band.NEP / 3e-12 if route == "fields_total" else 0.0
    try:
        fn = program.total_power_fn()
        assert fn.__name__ == route
        seed, offsets, bs_az, bs_el = program.example_args(3, device="cpu")
        with torch.no_grad():
            plain = fn(seed=seed, device="cpu")
        for x in (offsets, bs_az, bs_el):
            x.requires_grad_(True)
        total = fn(seed=seed, offsets=offsets, bs_az=bs_az, bs_el=bs_el, device="cpu")
        fields, _ = program.fields(seed=seed, offsets=offsets, device="cpu")
        assert set(fields) == {"atmosphere", "cmb", "map", "noise"}
        (total.square().mean() + sum(v.square().mean() for v in fields.values())).backward()
    finally:
        band.NEP_per_loading = 0.0
    assert torch.equal(total.detach(), plain)
    for x in (offsets, bs_az, bs_el):
        assert bool(torch.isfinite(x.grad).all()) and float(x.grad.abs().max()) > 0


def test_noise_draws_carry_no_gradient(mustang):
    """Without NEP_per_loading the noise is a constant of the pointing:
    on the matrix product's route the gradient of sum(w * total) equals
    that of sum(w * gains * signal) on the same seed (1e-5 relative L2:
    the two sums are rounded in another order)."""
    program = mustang["program"]
    seed, offsets, bs_az, bs_el = program.example_args(8, device="cpu")
    offsets.requires_grad_(True)
    w = torch.as_tensor(np.random.default_rng(7).standard_normal((program.n_det, program.n_t)).astype(np.float32))
    total = program.total_power_fn()(seed=seed, offsets=offsets, device="cpu")
    (g,) = torch.autograd.grad((w * total).sum(), offsets)
    gen = torch.Generator().manual_seed(seed)
    signal = program.fields(generator=gen, offsets=offsets, device="cpu", upto="signal")
    gains = program.draw_gains(generator=gen, device="cpu")
    (g_signal,) = torch.autograd.grad((w * gains * sum(signal.values())).sum(), offsets)
    assert rel_l2(g, g_signal) <= 1e-5
