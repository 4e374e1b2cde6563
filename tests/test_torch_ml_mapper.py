"""The port's maximum-likelihood mapper against maria_tpu, on the CPU.

The scene is the 20 s sky scene (MUSTANG-2 on a Planner-made ra/dec daisy
over ``big_cluster`` at (150, 10) deg, no atmosphere, noise on), made by
the port with private caches. maria_tpu's mapper gets the same signal in a
maria_tpu TOD with maria_tpu's own pointing of the same plan; its blocks
(ids, Stokes weights, data, and where a test says so its noise model) are
carried into the port's mapper by ``convert.ml_state_from_arrays``, since
two float32 ra/dec tracks put a few samples in a hundred thousand into
the neighbouring pixel. Two 64 x 64 grids: "on" (0.5 deg, every sample on
the map) and "over" (0.2 deg, ~3% of the samples in the overflow
buckets). Each comparison states its tolerance.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import maria_torch  # noqa: E402
import maria_tpu  # noqa: E402
from maria_tpu.io import caching as tpu_caching  # noqa: E402
from maria_tpu.mappers import MaximumLikelihoodMapper as RefML  # noqa: E402

from maria_torch.convert import ml_state_from_arrays  # noqa: E402
from maria_torch.mappers.ml_mapper import conjugate_gradient, smooth_spectrum  # noqa: E402

CENTER = (150.0, 10.0)
PLANNER_KW = dict(start_time=1.75e9, horizon_days=2, total_duration=20.0, chunk_duration=20.0, scan_pattern="daisy",
                  scan_options={"radius": 0.083, "speed": 0.017}, sample_rate=50)
GRIDS = {"on": 0.5, "over": 0.2}


def grid_kw(grid):
    return dict(center=CENTER, width=GRIDS[grid], resolution=GRIDS[grid] / 64, frame="ra/dec")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The port's noisy and noise-free 20 s TODs (with their simulations)
    and a maria_tpu TOD of the noisy signal on maria_tpu's pointing."""
    from maria_tpu.tod.tod import Pointing as RefPointing

    old_tpu, old_torch = tpu_caching.get_cache_dir(), maria_torch.io._cache_state["base"]
    maria_tpu.set_cache_dir(str(tmp_path_factory.mktemp("maria_tpu_cache")))
    maria_torch.set_cache_dir(str(tmp_path_factory.mktemp("maria_torch_cache")))
    try:
        from maria_torch.scenes import sky_simulation

        sim = sky_simulation(20.0, "cpu", atmosphere=None, noise=True)
        clean_sim = sky_simulation(20.0, "cpu", atmosphere=None, noise=False)
        tod = sim.run()[0]
        ref_map = maria_tpu.map.get("big_cluster", center=CENTER, fetch_first=False)
        ref_plan = maria_tpu.plan.Planner(target=ref_map, site="GBT").generate_plans(**PLANNER_KW)[0]
        obs = maria_tpu.Simulation(instrument="MUSTANG-2", plans=ref_plan, site="GBT", atmosphere=None,
                                   seed=0).obs_list[0]
        ref_tod = maria_tpu.tod.TOD(data={"signal": tod.signal.numpy()}, pointing=RefPointing(obs.boresight,
                                    obs.offsets, obs.q), dets=obs.instrument.dets, units="K_RJ")
        yield {"sim": sim, "tod": tod, "ref_tod": ref_tod, "clean_sim": clean_sim, "clean": clean_sim.run()[0]}
    finally:
        maria_tpu.set_cache_dir(old_tpu)
        maria_torch.set_cache_dir(old_torch)


def block_arrays(ref, i=0, noise_model=False):
    block = ref.blocks[i]
    keys = ("pix", "sw", "data") + (("A_inv", "U", "core") if noise_model else ())
    return {k: (None if block.get(k) is None else np.array(block[k])) for k in keys} | {"fs": block["fs"]}


def pair(scene, grid, t_bins=1, noise_model=False, **kw):
    """(maria_tpu's mapper, the port's with maria_tpu's blocks)."""
    ref = RefML([scene["ref_tod"]], t_bins=t_bins, **grid_kw(grid), **kw)
    ours = maria_torch.MaximumLikelihoodMapper([scene["tod"]], t_bins=t_bins, **grid_kw(grid), **kw)
    if noise_model:
        ref._update_noise_model(ref.naive_map)
    return ref, ml_state_from_arrays(ours, [block_arrays(ref, noise_model=noise_model)])


def rel_max(ours, ref):
    ours, ref = np.asarray(ours, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert ours.shape == ref.shape
    return np.abs(ours - ref).max() / np.abs(ref).max()


# -- the blocks and the operators -----------------------------------------------------------


@pytest.mark.parametrize("grid,t_bins", [("on", 1), ("over", 1), ("over", 2)])
def test_blocks_match(scene, grid, t_bins):
    """The port's own blocks: ids equal maria_tpu's but for a float32 ulp
    of ra/dec (at most 0.05% of the samples), every id in [0, n_cpix),
    the overflow share as maria_tpu's; Stokes weights and data equal."""
    ref = RefML([scene["ref_tod"]], t_bins=t_bins, **grid_kw(grid))
    ours = maria_torch.MaximumLikelihoodMapper([scene["tod"]], t_bins=t_bins, **grid_kw(grid))
    assert (ours.n_x, ours.n_y, ours.n_cpix, ours.n_m) == (ref.n_x, ref.n_y, ref.n_cpix, ref.n_m)
    pix, ref_pix = ours.blocks[0]["pix"], np.asarray(ref.blocks[0]["pix"])
    assert pix.dtype == torch.int32 and pix.is_contiguous() and int(pix.min()) >= 0 and int(pix.max()) < ours.n_cpix
    assert (pix.numpy() == ref_pix).mean() >= 0.9995
    buckets = (ref_pix % ref.n_pix1) == ref.n_pix
    assert abs(((pix.numpy() % ours.n_pix1) == ours.n_pix).mean() - buckets.mean()) <= 5e-4
    assert buckets.any() == (grid == "over")
    np.testing.assert_array_equal(ours.blocks[0]["sw"].numpy(), np.asarray(ref.blocks[0]["sw"]))
    np.testing.assert_array_equal(ours.blocks[0]["data"].numpy(), np.asarray(ref.blocks[0]["data"]))
    assert ours.blocks[0]["fs"] == pytest.approx(ref.blocks[0]["fs"], rel=1e-12)


@pytest.mark.parametrize("t_bins", [1, 2])
def test_pointing_operators(scene, t_bins):
    """On maria_tpu's blocks ("over" grid): P equal to maria_tpu's where
    the buckets hold zero, and reading zero at off-map samples whatever
    they hold; P^T (K2's plain version) within 1e-5 of the maximum of
    maria_tpu's segment sums; the hit map equal; the naive map and the
    white-noise diagonal within 1e-5 of their maxima."""
    ref, ours = pair(scene, "over", t_bins=t_bins)
    block, ref_block = ours.blocks[0], ref.blocks[0]
    rng = np.random.default_rng(0)
    m = rng.standard_normal(ref.n_m).astype(np.float32)
    mask = np.asarray(ref._overflow_mask())
    np.testing.assert_array_equal(ours._project(torch.as_tensor(m), block).numpy(),
                                  np.asarray(ref._project(jnp.asarray(m * mask), ref_block)))
    off_map = (np.asarray(ref_block["pix"]) % ref.n_pix1) == ref.n_pix
    assert off_map.any() and not ours._project(torch.as_tensor(m), block).numpy()[off_map].any()
    v = rng.standard_normal(scene["tod"].shape).astype(np.float32)
    assert rel_max(ours._project_T(torch.as_tensor(v), block).numpy(), ref._project_T(jnp.asarray(v), ref_block)) <= 1e-5
    np.testing.assert_array_equal(ours.hits.numpy(), np.asarray(ref.hits))
    assert rel_max(ours.naive_map.numpy(), ref.naive_map) <= 1e-5
    ref._update_noise_model(ref.naive_map)
    ml_state_from_arrays(ours, [block_arrays(ref, noise_model=True)])
    assert rel_max(ours._white_diag().numpy(), ref._white_diag()) <= 1e-5


@pytest.mark.parametrize("k", [0, 2])
def test_noise_model(scene, k):
    """From the same map on maria_tpu's blocks: A_inv, the median PSD
    and the modes' PSDs within 1e-4 relative; N^-1 v within 1e-4 of its
    maximum (through the Woodbury term at k = 2); the history's shapes."""
    ref, ours = pair(scene, "on", k=k)
    m0 = np.array(ref.naive_map)
    ref._update_noise_model(jnp.asarray(m0))
    ours._update_noise_model(torch.as_tensor(m0))
    np.testing.assert_allclose(ours.blocks[0]["A_inv"].numpy(), np.asarray(ref.blocks[0]["A_inv"]), rtol=1e-4)
    ((diag,),), ((ref_diag,),) = ours.noise_model_history, ref.noise_model_history
    np.testing.assert_array_equal(diag["f"], ref_diag["f"])
    assert diag["median_psd"].shape == diag["f"].shape == (501,) and (diag["median_psd"][1:] > 0).all()
    np.testing.assert_allclose(diag["median_psd"], ref_diag["median_psd"], rtol=1e-4)
    if k:
        assert diag["mode_psd"].shape == (k, 501)
        np.testing.assert_allclose(diag["mode_psd"], ref_diag["mode_psd"], rtol=1e-4)
        assert ours.blocks[0]["U"].shape == (217, k) and ours.blocks[0]["core"].shape == (501, k, k)
    else:
        assert diag["mode_psd"] is None and ours.blocks[0]["U"] is None
    v = np.random.default_rng(1).standard_normal(scene["tod"].shape).astype(np.float32)
    assert rel_max(ours._apply_inverse_N(ours.blocks[0], torch.as_tensor(v)).numpy(),
                   ref._apply_inverse_N(ref.blocks[0], jnp.asarray(v))) <= 1e-4


def test_woodbury_inverse_is_exact():
    """tests/test_ml_mapper.py's dense check on the port: N^-1 v equals a
    per-frequency solve of N_f = diag(A_f) + U diag(lam_f) U^T (2e-3)."""
    rng = np.random.default_rng(0)
    n_det, n_t, k = 6, 64, 2
    n_f = n_t // 2 + 1
    A_inv = rng.uniform(0.5, 2.0, (n_det, n_f)).astype(np.float32)
    U = rng.standard_normal((n_det, k)).astype(np.float32)
    lam = rng.uniform(0.1, 3.0, (k, n_f)).astype(np.float32)
    G = np.einsum("df,dk,dl->fkl", A_inv, U, U)
    core = np.linalg.inv(np.stack([np.diag(1 / lam[:, f]) for f in range(n_f)]) + G).astype(np.float32)
    mapper = maria_torch.MaximumLikelihoodMapper.__new__(maria_torch.MaximumLikelihoodMapper)
    block = {"A_inv": torch.as_tensor(A_inv), "U": torch.as_tensor(U), "core": torch.as_tensor(core)}
    v = rng.standard_normal((n_det, n_t)).astype(np.float32)
    out = mapper._apply_inverse_N(block, torch.as_tensor(v)).numpy()
    fv = np.fft.rfft(v, axis=-1)
    x = np.stack([np.linalg.solve(np.diag(1 / A_inv[:, f]) + U @ np.diag(lam[:, f]) @ U.T, fv[:, f])
                  for f in range(n_f)], axis=-1)
    np.testing.assert_allclose(out, np.fft.irfft(x, n=n_t, axis=-1), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 8, 9])
def test_smooth_spectrum_is_jnp_convolve_same(k):
    """The box of k bins, edges included, as jnp.convolve(row, ones(k) /
    k, mode="same") (maria_tpu's _smooth_spectrum) to 1e-6 relative."""
    from maria_tpu.mappers.ml_mapper import _smooth_spectrum

    spec = np.exp(np.random.default_rng(2).standard_normal((3, 37)) * 4).astype(np.float32)
    ours = smooth_spectrum(torch.as_tensor(spec), k).numpy()
    np.testing.assert_allclose(ours, np.asarray(_smooth_spectrum(jnp.asarray(spec), k)), rtol=1e-6)
    row = np.convolve(spec[0].astype(np.float64), np.ones(k) / k, mode="same")
    np.testing.assert_allclose(ours[0], row, rtol=1e-6)


@pytest.mark.parametrize("maxiter", [3, 12, 40])
def test_conjugate_gradient_is_jax_cg(maxiter):
    """The recurrence of jax.scipy.sparse.linalg.cg with a Jacobi M on an
    SPD system (1e-5 of the solution's maximum), also after the stop rule
    r.r <= tol^2 b.b has frozen the state (12 steps solve it to float32
    precision; 40 run on frozen, where 0/0 would be NaN)."""
    rng = np.random.default_rng(3)
    Q = rng.standard_normal((12, 12))
    H = (Q @ Q.T + 12 * np.eye(12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    inv_diag = (1 / np.diag(H)).astype(np.float32)
    x0 = np.zeros(12, dtype=np.float32)
    ref, _ = jax.scipy.sparse.linalg.cg(lambda x: jnp.asarray(H) @ x, jnp.asarray(b), x0=jnp.asarray(x0),
                                        maxiter=maxiter, tol=1e-8, M=lambda x: x * inv_diag)
    Ht = torch.as_tensor(H)
    ours = conjugate_gradient(lambda x: Ht @ x, torch.as_tensor(b), torch.as_tensor(x0), maxiter,
                              torch.as_tensor(inv_diag)).numpy()
    assert np.isfinite(ours).all()
    assert rel_max(ours, ref) <= 1e-5
    if maxiter == 40:
        assert rel_max(ours, np.linalg.solve(H.astype(np.float64), b)) <= 1e-5


# -- the fit ----------------------------------------------------------------------------------


@pytest.mark.parametrize("k,method", [(0, "conjugate_gradient"), (2, "conjugate_gradient"), (0, "gradient_descent")])
def test_fit_matches(scene, k, method):
    """fit() from maria_tpu's blocks on the "on" grid, 2 epochs x 15
    steps: the map within 1e-3 of its maximum of maria_tpu's (measured
    3.4e-6 at k = 2 and 2.5e-7 at k = 0: float32 sums in another order,
    through two noise-model updates and the solve) and the weights (the
    last epoch's white-noise diagonal) within 1e-3 relative; one history
    entry an epoch."""
    ref, ours = pair(scene, "on", k=k, n_epochs=2, n_cg_iters=15)
    out_ref, out = ref.fit(method=method), ours.fit(method=method)
    assert out.shape == (1, 1, 1, 64, 64) and out.frame == "ra/dec" and out.units == "K_RJ"
    assert rel_max(out.data.numpy(), np.nan_to_num(np.asarray(out_ref.data))) <= 1e-3
    np.testing.assert_allclose(out.weight.numpy(), np.asarray(out_ref.weight), rtol=1e-3)
    assert len(ours.noise_model_history) == len(ref.noise_model_history) == 2
    assert ours.m.shape == (ours.n_m,) and ours.map is out


def test_overflow_buckets_keep_the_operator_symmetric(scene):
    """ROADMAP queue 3, hazard 5. On the "over" grid, with maria_tpu's
    noise model, the port's P^T N^-1 P is symmetric to float32 rounding
    (|w.Au - u.Aw| within 1e-6 of |u| |Au|), and its CG drives r.r below
    1e-6 of b.b in 60 steps. maria_tpu's P reads the overflow buckets,
    whose rows it makes the identity: its operator is not symmetric there
    (measured 5.5e-5 of |u| |Au|) and 60 steps of its CG leave r.r above
    b.b."""
    ref, ours = pair(scene, "over", noise_model=True)
    g = torch.Generator().manual_seed(4)
    u, w = torch.randn(ours.n_m, generator=g), torch.randn(ours.n_m, generator=g)
    Au, Aw = ours._apply_PNP(u), ours._apply_PNP(w)
    assert abs(float(w @ Au - u @ Aw)) <= 1e-6 * float(u.norm() * Au.norm())
    ju, jw = jnp.asarray(u.numpy()), jnp.asarray(w.numpy())
    ref_Au, ref_Aw = ref._apply_PNP(ju), ref._apply_PNP(jw)
    assert abs(float(jw @ ref_Au - ju @ ref_Aw)) > 1e-5 * float(jnp.linalg.norm(ju) * jnp.linalg.norm(ref_Au))
    b = ours._rhs()
    diag = ours._white_diag()
    inv_diag = torch.where(diag > 0, 1.0 / torch.clamp(diag, min=1e-30), 1.0)
    x = conjugate_gradient(ours._apply_PNP, b, ours.naive_map, 60, inv_diag)
    r = b - ours._apply_PNP(x)
    assert float(r @ r) <= 1e-6 * float(b @ b)
    ref_b = ref._rhs()
    ref_inv = jnp.asarray(inv_diag.numpy())
    ref_x, _ = jax.scipy.sparse.linalg.cg(ref._apply_PNP, ref_b, x0=ref.naive_map, maxiter=60, tol=1e-8,
                                          M=lambda x: x * ref_inv)
    ref_r = ref_b - ref._apply_PNP(ref_x)
    assert float(ref_r @ ref_r) > float(ref_b @ ref_b)


def test_fit_keywords_and_history(scene, caplog, tmp_path):
    """epochs / steps_per_epoch / max_steps_per_epoch override the
    constructor's, run is fit, init="random" starts from a draw of the
    naive map's scale; the TPU keywords are taken; fit(plot=True) plots
    each epoch's map and plot_noise_model the median PSD and the k modes;
    mesh= runs (a one-rank gloo world here: the fit equals the fit without
    a mesh; tests/test_torch_parallel.py shards it over four ranks);
    unknown solvers and inits raise; bilinear/prior warn."""
    tod = scene["tod"]
    kw = grid_kw("on")
    mapper = maria_torch.MaximumLikelihoodMapper([tod], n_epochs=3, n_cg_iters=2, mxu_pointing=True, **kw)
    assert mapper.map.shape == (1, 1, 1, 64, 64)  # the naive map before fit()
    assert mapper.run is not None and maria_torch.MaximumLikelihoodMapper.run is maria_torch.MaximumLikelihoodMapper.fit
    mapper.fit(epochs=1, steps_per_epoch=2, fused=False)
    assert len(mapper.noise_model_history) == 1
    mapper.run(max_steps_per_epoch=1)
    assert len(mapper.noise_model_history) == 4
    rand = maria_torch.MaximumLikelihoodMapper([tod], init="random", n_epochs=1, n_cg_iters=3, **kw)
    assert bool(torch.isfinite(rand.fit().data).all())
    with pytest.raises(ValueError, match="Unknown solver"):
        mapper.fit(method="newton")
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_figs = len(plt.get_fignums())
    mapper.fit(epochs=2, steps_per_epoch=1, plot=True)  # a map plot an epoch
    assert len(plt.get_fignums()) == n_figs + 2 and len(mapper.noise_model_history) == 6
    ax = mapper.plot_noise_model()
    assert len(ax.get_lines()) == 1 + mapper.k and ax.get_title() == "noise model, epoch 6/6"
    plt.close("all")
    import torch.distributed as dist

    from maria_torch.parallel import create_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0, world_size=1)
    try:
        mesh = create_mesh(axis_names=("det",), device="cpu")
        sharded = maria_torch.MaximumLikelihoodMapper([tod], mesh=mesh, n_epochs=1, n_cg_iters=3, k=1, **kw).fit()
    finally:
        dist.destroy_process_group()
    single = maria_torch.MaximumLikelihoodMapper([tod], n_epochs=1, n_cg_iters=3, k=1, **kw).fit()
    torch.testing.assert_close(sharded.data, single.data, rtol=0, atol=0)
    with pytest.raises(ValueError, match="init"):
        maria_torch.MaximumLikelihoodMapper([tod], init="zeros", **kw)
    with caplog.at_level(logging.WARNING, logger="maria_torch"):
        maria_torch.MaximumLikelihoodMapper([tod], bilinear=True, prior=True, **kw)
    assert sum("ignoring" in r.message for r in caplog.records) == 2


def test_ml_state_from_arrays_checks(scene):
    ref, ours = pair(scene, "on")
    arrays = block_arrays(ref)
    with pytest.raises(ValueError, match="blocks for a mapper"):
        ml_state_from_arrays(ours, [arrays, arrays])
    with pytest.raises(ValueError, match="pixel ids"):
        ml_state_from_arrays(ours, [arrays | {"pix": arrays["pix"] + ours.n_cpix}])
    with pytest.raises(ValueError, match="U and core"):
        ml_state_from_arrays(ours, [arrays | {"U": np.ones((217, 2))}])


def test_compute_residual_map(scene):
    """On the same grid: the output less the input where the output has
    weight, as maria_tpu's (1e-5 of the output map's maximum, the two
    fits' own distance), and on another grid through sampled_onto."""
    from maria_tpu.mappers import compute_residual_map as ref_residual

    from maria_torch.convert import map_from_arrays

    ref, ours = pair(scene, "on")
    out_ref, out = ref.fit(epochs=1, steps_per_epoch=3), ours.fit(epochs=1, steps_per_epoch=3)
    ref_in = maria_tpu.map.get("big_cluster", center=CENTER, width=0.5, n=64, fetch_first=False)
    ours_in = map_from_arrays(np.asarray(ref_in.data), ref_in.center, float(ref_in.width.rad),
                              float(ref_in.height.rad), nu=ref_in.nu)
    resid, ref_resid = maria_torch.compute_residual_map(ours_in, out), ref_residual(ref_in, out_ref)
    assert resid.shape == (1, 1, 1, 64, 64) and resid.center == out.center
    scale = float(out.data.abs().max())
    assert np.abs(resid.data.numpy() - np.asarray(ref_resid.data)).max() <= 1e-5 * scale
    np.testing.assert_array_equal(resid.weight.numpy(), out.weight.numpy())
    # another grid (big_cluster's 512 x 512 over the same 0.5 deg): the
    # input sampled onto the output's pixels, as maria_tpu's
    full, ref_full = maria_torch.map.get("big_cluster", center=CENTER), maria_tpu.map.get(
        "big_cluster", center=CENTER, fetch_first=False)
    resid, ref_resid = maria_torch.compute_residual_map(full, out), ref_residual(ref_full, out_ref)
    assert resid.shape == (1, 1, 1, 64, 64)
    assert np.abs(resid.data.numpy() - np.asarray(ref_resid.data)).max() <= 1e-5 * scale


# -- the port alone, on its own scenes ---------------------------------------------------------


def test_ml_recovers_the_sky(scene):
    """tests/test_ml_mapper.py's recovery on the noise-free scene, on the
    input map's grid cut to 64 x 64: CG above 0.9, steepest descent above
    0.8 (correlation with the beam-smoothed input over the better-covered
    half of the hit pixels)."""
    from maria_torch.scenes import sky_recovery

    sim, tod = scene["clean_sim"], scene["clean"]
    kw = dict(center=CENTER, width=0.5, resolution=0.5 / 64, frame="ra/dec")
    cg = maria_torch.MaximumLikelihoodMapper([tod], n_epochs=2, n_cg_iters=40, **kw).fit()
    assert sky_recovery(sim, cg) > 0.9
    gd = maria_torch.MaximumLikelihoodMapper([tod], n_epochs=1, n_cg_iters=40, **kw).fit(method="gradient_descent")
    assert sky_recovery(sim, gd) > 0.8


def test_ml_time_bins_solve_independently(scene):
    """Two time bins: both covered, not the same coverage, different
    solves, each above 0.8."""
    from maria_torch.scenes import sky_recovery

    sim, tod = scene["clean_sim"], scene["clean"]
    out = maria_torch.MaximumLikelihoodMapper([tod], n_epochs=1, n_cg_iters=30, t_bins=2, center=CENTER, width=0.5,
                                              resolution=0.5 / 64, frame="ra/dec").fit()
    w, d = out.weight[0, 0].numpy(), out.data[0, 0].numpy()
    assert out.shape == (1, 1, 2, 64, 64) and (w[0] > 0).any() and (w[1] > 0).any()
    assert not np.array_equal(w[0] > 0, w[1] > 0) and not np.allclose(d[0], d[1])
    for t in range(2):
        assert sky_recovery(sim, out, t=t) > 0.8


def test_ml_beats_binning_on_a_common_mode(scene):
    """tests/test_ml_mapper.py's common mode (5e-3 x the cumulative sum of
    normals from default_rng(0)) on the noisy scene: the k = 2 ML map's
    residual rms below BinMapper's."""
    from maria_torch.scenes import sky_residual_rms

    sim, tod = scene["sim"], scene["tod"]
    common = 5e-3 * np.cumsum(np.random.default_rng(0).standard_normal(tod.shape[-1]))
    data = dict(tod.data)
    data["common"] = torch.as_tensor(np.broadcast_to(common, tod.shape).astype(np.float32))
    corrupted = maria_torch.TOD(data=data, pointing=tod.pointing, units=tod.units, dets=tod.dets,
                                metadata=tod.metadata)
    kw = dict(center=CENTER, width=0.5, resolution=0.5 / 64, frame="ra/dec")
    binned = maria_torch.BinMapper([corrupted], **kw).run()
    ml = maria_torch.MaximumLikelihoodMapper([corrupted], n_epochs=2, n_cg_iters=40, k=2, **kw).fit()
    assert sky_residual_rms(sim, ml) < sky_residual_rms(sim, binned)
