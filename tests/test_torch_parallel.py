"""The port's (det, time) mesh on torch.distributed, on the CPU: the mesh,
sharded binning, BinMapper.run(mesh=), the ML mapper with mesh=, the
streamed run with mesh= and the time-sharded extrusion, each against the
port's single-process run and against maria_tpu.

One gloo world of four ranks is started once for the module
(``torch.multiprocessing``, spawn), meeting through a file under the
test's temporary directory (no port for files run in parallel to race
for); ``init_process_group`` times out after 60 s and the join after
JOIN_SECONDS, when the ranks are killed. Every rank runs every sharded
path and writes its results to an .npz; the parent computes the
single-process runs and maria_tpu's meanwhile, and the tests compare.
maria_tpu's mesh tests of BinMapper, the ML mapper and the streamed run
are marked slow, so the port's mesh runs are held against maria_tpu's
single-device runs on the same TOD (its state and normals, for the
stream); its time-sharded extrusion runs on maria_tpu's virtual
8-device CPU mesh.
"""

import copy
import time
from datetime import timedelta

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import maria_torch  # noqa: E402

WORLD = 4
JOIN_SECONDS = 300
SEED = 7
BLOCK_TC = 16
CHUNK_ROWS = 16
CENTER = (150.0, 10.0)
PLANNER_KW = dict(start_time=1.75e9, horizon_days=2, total_duration=20.0, chunk_duration=20.0, scan_pattern="daisy",
                  scan_options={"radius": 0.083, "speed": 0.017}, sample_rate=50)
GRID_KW = dict(center=CENTER, width=0.5, resolution=0.5 / 64, frame="ra/dec", units="K_RJ")
ML_KW = dict(k=2, n_epochs=2, n_cg_iters=15)
STREAM_PLAN_KW = dict(start_time=1.75e9, scan_center=(150.0, 41.0), frame="az/el", duration=30.0, sample_rate=50.0)
STREAM_SCENE_KW = dict(instrument="MUSTANG-2", site="GBT", atmosphere="2d", noise=True, seed=0)
COLUMNS = ("xi", "eta", "gamma", "band_name", "pol_label", "base_det_index", "array_name", "primary_size",
           "bath_temp", "time_constant")


# -- what every rank runs (module level: spawn imports it by name) ------------------------------------------------


def stream_scene(cache_dir):
    """The streamed scene's port program and observation (a 30 s MUSTANG-2
    daisy at 50 Hz with the 2-D atmosphere and noise)."""
    from maria_torch.ops.program import build_tod_program

    maria_torch.set_cache_dir(cache_dir)
    sim = maria_torch.Simulation(plans=maria_torch.get_plan("daisy_5arcmin_60s", **STREAM_PLAN_KW), device="cpu",
                                 **STREAM_SCENE_KW)
    obs = sim.obs_list[0]
    return build_tod_program(obs, noise_kwargs=sim.noise_kwargs, device="cpu"), obs


def bin_case():
    """tests/test_parallel.py's sharded-binning case: smooth scan tracks,
    two padded rows at id -1."""
    rng = np.random.default_rng(3)
    n_det, n_t, n_y, n_x = 32, 256, 64, 64
    t = np.arange(n_t)
    base_y = 32 + 20 * np.sin(2 * np.pi * t / n_t)
    base_x = 32 + 20 * np.cos(2 * np.pi * t / n_t)
    iy = np.broadcast_to(np.clip(base_y[None] + rng.integers(-6, 7, (n_det, 1)), 0, n_y - 1), (n_det, n_t)).copy()
    ix = np.broadcast_to(np.clip(base_x[None] + rng.integers(-6, 7, (n_det, 1)), 0, n_x - 1), (n_det, n_t)).copy()
    iy[-2:] = -1
    ids = np.where(iy >= 0, iy * n_x + ix, -1).astype(np.int32)
    return ids, rng.standard_normal((n_det, n_t)).astype(np.float32), n_y * n_x


def rank_main(rank, world, tmp, inputs):
    """One rank of the world: every sharded path, its results to rank<i>.npz."""
    import torch.distributed as dist

    from maria_torch.atmosphere.streaming import StreamingExtrusion, extrude_time_sharded
    from maria_torch.convert import ar_process_from_arrays, ml_state_from_arrays, stream_state_from_arrays, \
        tod_from_arrays
    from maria_torch.ops.streaming_exec import StreamingExecutor
    from maria_torch.parallel import create_mesh, replicate, shard_rows
    from maria_torch.parallel.binning import bin_sharded

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    out = {}
    try:
        mesh = create_mesh(device="cpu")
        det_mesh = create_mesh(axis_names=("det",), device="cpu")
        time_mesh = create_mesh(axis_names=("time",), device="cpu")
        out["coords"] = np.array(mesh.coords)
        out["shape"] = np.array(mesh.shape)
        out["det_group"] = np.array(mesh.group("det")[1])
        out["time_group"] = np.array(mesh.group("time")[1])
        try:
            create_mesh(world - 1, device="cpu")
            out["refused_size"] = False
        except ValueError:
            out["refused_size"] = True
        out["shard_rows"] = shard_rows(mesh, torch.arange(10.0)).numpy()
        out["replicate"] = replicate(mesh, torch.full((3,), float(rank))).numpy()

        # K2 on this rank's (det, time) block, reduced over the mesh
        ids, data, n_pix = bin_case()
        r0, r1 = mesh.block(ids.shape[0], "det")
        c0, c1 = mesh.block(ids.shape[1], "time")
        out["bin"] = bin_sharded(torch.as_tensor(data[r0:r1, c0:c1]), torch.as_tensor(ids[r0:r1, c0:c1]), n_pix,
                                 mesh)[0].numpy()

        # the mappers on the carried TOD
        tod = tod_from_arrays(**inputs["tod"])
        bm = maria_torch.BinMapper([tod], **GRID_KW).run(mesh=mesh)
        out["bm_data"], out["bm_weight"] = np.asarray(bm.data), np.asarray(bm.weight)
        ml = maria_torch.MaximumLikelihoodMapper([tod], mesh=det_mesh, **GRID_KW, **ML_KW)
        out["ml_hits"] = ml.hits.numpy()
        fit = ml.fit()
        out["ml_data"], out["ml_weight"] = fit.data.numpy(), fit.weight.numpy()
        out["ml_median_psd"] = ml.noise_model_history[-1][0]["median_psd"]
        ml_ref = ml_state_from_arrays(maria_torch.MaximumLikelihoodMapper([tod], mesh=det_mesh, **GRID_KW, **ML_KW),
                                      [inputs["ml_block"]])
        out["ml_ref_data"] = ml_ref.fit().data.numpy()

        # the streamed run: its own draws, maria_tpu's, a padded program, a checkpoint
        program, obs = stream_scene(f"{tmp}/cache{rank}")
        ex = StreamingExecutor(program, obs, block_tc=BLOCK_TC, device="cpu")
        res = ex.run(SEED, group_size=4, mesh=det_mesh, accumulate_psd=True)
        out["st_sum"], out["st_wgt"], out["st_psd"] = res.map_sum, res.map_wgt, np.stack(res.psds)
        state = stream_state_from_arrays(ex, inputs["stream_leaves"])
        res = ex.run(group_size=4, mesh=det_mesh, state=state, draws=inputs["stream_draws"])
        out["st_ref_sum"], out["st_ref_wgt"] = res.map_sum, res.map_wgt
        padded = copy.deepcopy(program)
        padded.pad_detectors(world)
        res = StreamingExecutor(padded, obs, block_tc=BLOCK_TC, device="cpu").run(SEED, group_size=4, mesh=det_mesh)
        out["pad_sum"], out["pad_wgt"], out["pad_samples"] = res.map_sum, res.map_wgt, res.n_samples
        ex8 = StreamingExecutor(program, obs, block_tc=8, device="cpu")
        sharded = ex8.shard(det_mesh)
        st = sharded.init_state(SEED)
        for b, st, _ in sharded._blocks(st, with_psd=True):
            sharded._save_ckpt(f"{tmp}/stream.ckpt.npz", st, b + 1, SEED)
            if b + 1 == 2:
                break
        dist.barrier()
        res = ex8.run(SEED, group_size=1, mesh=det_mesh, accumulate_psd=True,
                      checkpoint_path=f"{tmp}/stream.ckpt.npz")
        out["resumed_sum"], out["resumed_wgt"], out["resumed_psd"] = res.map_sum, res.map_wgt, np.stack(res.psds)

        # the halo ring over the time axis
        proc = ar_process_from_arrays(*inputs["ar"])
        out["ext"] = extrude_time_sharded(proc, SEED, CHUNK_ROWS, time_mesh).numpy()
        g = torch.Generator()
        g.manual_seed(SEED)
        out["ext_seq"] = torch.cat(StreamingExtrusion(proc, CHUNK_ROWS, device="cpu").run_chunks(world, g)).numpy()
        out["ext_ref"] = extrude_time_sharded(proc, None, CHUNK_ROWS, time_mesh, draws=inputs["ar_draws"]).numpy()
        np.savez(f"{tmp}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def run_world(fn, world, tmp, inputs, timeout=JOIN_SECONDS):
    """Start ``world`` ranks of ``fn`` (spawn); returns a join() that waits
    at most ``timeout`` s from the start and kills the ranks past it."""
    ctx = torch.multiprocessing.start_processes(fn, args=(world, str(tmp), inputs), nprocs=world, join=False,
                                                start_method="spawn")
    deadline = time.monotonic() + timeout

    def join():
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"the {world}-rank world did not end within {timeout} s")
        return [dict(np.load(f"{tmp}/rank{r}.npz", allow_pickle=False)) for r in range(world)]

    return join


# -- the parent: maria_tpu's runs and the single-process ones ------------------------------------------------------


def carry_args(ref):
    b = ref.pointing.boresight
    loc = b.earth_location
    return dict(data={k: np.asarray(v) for k, v in ref.data.items()}, weight=np.asarray(ref.weight), phi=b._phi,
                theta=b._theta, t=b.t, offsets=ref.pointing.offsets, q=ref.pointing.q,
                columns={k: ref.dets.dets[k].values for k in COLUMNS}, bands=ref.dets.bands.names,
                frame=b.frame.name, earth_location=(loc.lat_deg, loc.lon_deg, loc.height_m), units=ref.units,
                device="cpu")


def jax_stream_inputs(ref_ex, key):
    """maria_tpu's executor state and every block's normals (as its
    block_fn draws them), as numpy."""
    import jax
    import jax.numpy as jnp

    ref_state = ref_ex.init_state(key)

    def as_numpy(tree):
        if isinstance(tree, dict):
            return {k: as_numpy(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(as_numpy(v) for v in tree)
        return np.asarray(tree)

    leaves = as_numpy({k: v for k, v in ref_state.items() if k != "noise_keys"})
    blocks = []
    for b in range(ref_ex.n_blocks):
        per_band = []
        for i, (band, model) in enumerate(zip(ref_ex.program.bands, ref_ex.noise_models)):
            k_white, k_pink, k_modes = jax.random.split(jax.random.fold_in(ref_state["noise_keys"][i], b), 3)
            n = len(band.det_index)
            white = np.asarray(jax.random.normal(k_white, (n, ref_ex.B), dtype=jnp.float32))
            w = wm = None
            if model.cascade is not None:
                w = np.asarray(jax.random.normal(k_pink, (n, ref_ex.B), dtype=jnp.float32))
                if model.corr_prop > 0:
                    wm = np.asarray(jax.random.normal(k_modes, (model.basis.shape[-1], ref_ex.B), dtype=jnp.float32))
            per_band.append((white, w, wm))
        blocks.append(per_band)
    return leaves, {"blocks": blocks}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import maria_tpu
    from maria_tpu.atmosphere.process import AutoregressiveProcess as RefProcess
    from maria_tpu.atmosphere.streaming import extrude_time_sharded as ref_extrude
    from maria_tpu.io import caching as tpu_caching
    from maria_tpu.mappers import BinMapper as RefBinMapper
    from maria_tpu.mappers.ml_mapper import MaximumLikelihoodMapper as RefML
    from maria_tpu.ops.program import build_tod_program as ref_build
    from maria_tpu.ops.streaming_exec import StreamingExecutor as RefExecutor
    from maria_tpu.parallel import create_mesh as ref_create_mesh

    from maria_torch.convert import ml_state_from_arrays, stream_state_from_arrays, tod_from_arrays
    from maria_torch.ops.streaming_exec import StreamingExecutor

    tmp = tmp_path_factory.mktemp("world")
    old_tpu, old_torch = tpu_caching.get_cache_dir(), maria_torch.io._cache_state["base"]
    maria_tpu.set_cache_dir(str(tmp_path_factory.mktemp("maria_tpu_cache")))
    try:
        # maria_tpu's TOD of the observer's scene without an atmosphere
        ref_map = maria_tpu.map.get("big_cluster", center=CENTER, fetch_first=False)
        ref_plan = maria_tpu.plan.Planner(target=ref_map, site="GBT").generate_plans(**PLANNER_KW)[0]
        ref_tod = maria_tpu.Simulation(instrument="MUSTANG-2", plans=ref_plan, site="GBT", atmosphere=None,
                                       map=ref_map, noise=True, seed=0).run()[0]
        ref_ml = RefML([ref_tod], **GRID_KW, **ML_KW)
        block = ref_ml.blocks[0]
        ml_block = {k: np.array(block[k]) for k in ("pix", "sw", "data")} | {"fs": block["fs"]}
        # maria_tpu's streamed scene, its state and normals
        ref_sim = maria_tpu.Simulation(plans=maria_tpu.get_plan("daisy_5arcmin_60s", **STREAM_PLAN_KW),
                                       **STREAM_SCENE_KW)
        ref_obs = ref_sim.obs_list[0]
        ref_ex = RefExecutor(ref_build(ref_obs, noise_kwargs=ref_sim.noise_kwargs), ref_obs, block_tc=BLOCK_TC)
        stream_leaves, stream_draws = jax_stream_inputs(ref_ex, jax.random.key(SEED))
        # an AR process, and maria_tpu's draws of its time-sharded stream
        ny = 12
        ref_proc = RefProcess(cross_section=np.stack([10.0 * np.arange(ny), np.full(ny, 500.0)], axis=-1),
                              extrusion=10.0 * np.arange(24), callback_kwargs={"nu": 5 / 6, "r0": 300.0})
        ref_proc.run_setup()
        key = jax.random.key(SEED)
        key_init, key_noise = jax.random.split(key)
        key_white, key_burn = jax.random.split(key_init)
        n_ext = ref_proc.n_extrusion
        ar_draws = (
            np.asarray(jax.random.normal(key_white, (3 * n_ext, ny), dtype=jnp.float32)),
            np.asarray(jax.random.normal(key_burn, (2 * n_ext, ref_proc.n_live_edge), dtype=jnp.float32)),
            [np.asarray(jax.random.normal(jax.random.fold_in(key_noise, c), (CHUNK_ROWS, ref_proc.n_live_edge),
                                          dtype=jnp.float32)) for c in range(WORLD)],
        )
        inputs = {"tod": carry_args(ref_tod), "ml_block": ml_block, "stream_leaves": stream_leaves,
                  "stream_draws": stream_draws, "ar_draws": ar_draws,
                  "ar": (np.asarray(ref_proc.A), np.asarray(ref_proc.B), ref_proc.extrusion_sample_index,
                         ref_proc.cross_section_sample_index)}
        join = run_world(rank_main, WORLD, tmp, inputs)

        # meanwhile: the single-process runs, the port's and maria_tpu's
        ref = {}
        tod = tod_from_arrays(**inputs["tod"])
        ref["bm"] = maria_torch.BinMapper([tod], **GRID_KW).run()
        ref["tpu_bm"] = RefBinMapper([ref_tod], progress_bars=False, **GRID_KW).run()
        ml = maria_torch.MaximumLikelihoodMapper([tod], **GRID_KW, **ML_KW)
        ref["ml_hits"] = ml.hits.numpy()
        ref["ml"] = ml.fit()
        ref["ml_median_psd"] = ml.noise_model_history[-1][0]["median_psd"]
        ref["ml_ref"] = ml_state_from_arrays(maria_torch.MaximumLikelihoodMapper([tod], **GRID_KW, **ML_KW),
                                             [ml_block]).fit()
        ref["tpu_ml"] = ref_ml.fit()
        program, obs = stream_scene(str(tmp_path_factory.mktemp("maria_torch_cache")))
        ex = StreamingExecutor(program, obs, block_tc=BLOCK_TC, device="cpu")
        ref["st"] = ex.run(SEED, group_size=4, accumulate_psd=True)
        ref["st_ref"] = ex.run(group_size=4, state=stream_state_from_arrays(ex, stream_leaves), draws=stream_draws)
        ref["tpu_st"] = ref_ex.run(jax.random.key(SEED), group_size=4, mxu_binning=False)
        padded = copy.deepcopy(program)
        padded.pad_detectors(WORLD)
        ref["pad"] = StreamingExecutor(padded, obs, block_tc=BLOCK_TC, device="cpu").run(SEED, group_size=4)
        ref["pad_program"] = padded
        ref["resumed"] = StreamingExecutor(program, obs, block_tc=8, device="cpu").run(SEED, group_size=1,
                                                                                      accumulate_psd=True)
        ref["stream_program"], ref["stream_obs"] = program, obs
        ref["tpu_ext"] = np.asarray(ref_extrude(ref_proc, key, chunk_rows=CHUNK_ROWS,
                                                mesh=ref_create_mesh(WORLD, axis_names=("time",), shape=(WORLD,))))
        ref["bin_case"] = bin_case()
        ref["tpu_mesh_shape"] = ref_create_mesh(WORLD).devices.shape
        ref["tmp"] = tmp
        ranks = join()
    finally:
        maria_tpu.set_cache_dir(old_tpu)
        maria_torch.io._cache_state["base"] = old_torch
    return ranks, ref


def rel_max(a, b):
    a, b = np.nan_to_num(np.asarray(a, np.float64)), np.nan_to_num(np.asarray(b, np.float64))
    return float(np.abs(a - b).max() / (np.abs(b).max() or 1.0))


# -- the mesh -----------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_for_equals_maria_tpu(n):
    from maria_tpu.parallel import mesh_shape_for as ref_shape

    from maria_torch.parallel import mesh_shape_for

    assert mesh_shape_for(n) == ref_shape(n)


def test_mesh_layout(world):
    """The world's (det 2, time 2) mesh is maria_tpu's create_mesh(4) shape,
    det-major: rank = 2 det + time, each axis group holding its row or
    column; a mesh of another size than the world is refused."""
    ranks, ref = world
    for r, out in enumerate(ranks):
        assert tuple(out["shape"]) == ref["tpu_mesh_shape"] == (2, 2)
        assert tuple(out["coords"]) == divmod(r, 2)
        assert list(out["det_group"]) == [r % 2, r % 2 + 2]
        assert list(out["time_group"]) == [2 * (r // 2), 2 * (r // 2) + 1]
        assert bool(out["refused_size"])
        # rows split along "det" (5 a rank), and rank 0's copy everywhere
        np.testing.assert_array_equal(out["shard_rows"], np.arange(10.0)[5 * (r // 2):5 * (r // 2) + 5])
        np.testing.assert_array_equal(out["replicate"], np.zeros(3))


def test_create_mesh_needs_a_world():
    from maria_torch.parallel import create_mesh

    with pytest.raises(RuntimeError, match="torch.distributed"):
        create_mesh(device="cpu")


# -- binning ------------------------------------------------------------------------------------------------------


def test_bin_sharded_equals_bincount(world):
    """K2 on each (det, time) block and one all_reduce equal a float64
    bincount, with tests/test_parallel.py:119-147's tolerance, on every rank."""
    ranks, ref = world
    ids, data, n_pix = ref["bin_case"]
    keep = ids >= 0
    expect = np.bincount(ids[keep], weights=data[keep].astype(np.float64), minlength=n_pix)
    for out in ranks:
        np.testing.assert_allclose(out["bin"], expect, rtol=1e-5, atol=1e-4)


def test_bin_mapper_mesh_equals_single_process(world):
    """BinMapper.run(mesh) on every rank: weights equal, the map within
    1e-5 of its maximum of the one-process map (tests/test_mappers.py:
    144-148's tolerance)."""
    ranks, ref = world
    one = ref["bm"]
    for out in ranks:
        np.testing.assert_array_equal(out["bm_weight"], np.asarray(one.weight))
        assert rel_max(out["bm_data"], one.data) <= 1e-5


def test_bin_mapper_mesh_against_maria_tpu(world):
    """The sharded map against maria_tpu's single-device BinMapper on the
    same TOD: the two packages' float32 pointing differs by ulps, so a few
    samples on a pixel's edge take its neighbour; the hit weights differ
    on at most 1% of the total, and the summed weighted map within 1e-5."""
    ranks, ref = world
    tpu = ref["tpu_bm"]
    w_ref = np.asarray(tpu.weight, np.float64)
    for out in ranks:
        w = out["bm_weight"].astype(np.float64)
        assert np.abs(w - w_ref).sum() <= 1e-2 * w_ref.sum()
        np.testing.assert_allclose((np.nan_to_num(out["bm_data"]) * w).sum(),
                                   (np.nan_to_num(np.asarray(tpu.data, np.float64)) * w_ref).sum(),
                                   rtol=1e-5, atol=1e-5 * np.abs(w_ref).sum())


# -- the ML mapper ------------------------------------------------------------------------------------------------


def test_ml_mapper_mesh_equals_single_process(world):
    """MaximumLikelihoodMapper(mesh=) over four det ranks (217 rows: 55, 55,
    55 and 52 padded to 55), k = 2, two epochs of 15 CG steps: the hit map
    equal, the fit within 1e-3 of its maximum of the one-process fit
    (tests/test_ml_mapper.py:291-294's tolerance), the weights within
    1e-3 relative, the noise model's median PSD (gathered) within 1e-5."""
    ranks, ref = world
    for out in ranks:
        np.testing.assert_array_equal(out["ml_hits"], ref["ml_hits"])
        assert rel_max(out["ml_data"], ref["ml"].data.numpy()) <= 1e-3
        np.testing.assert_allclose(out["ml_weight"], ref["ml"].weight.numpy(), rtol=1e-3)
        np.testing.assert_allclose(out["ml_median_psd"], ref["ml_median_psd"], rtol=1e-5)


def test_ml_mapper_mesh_against_maria_tpu(world):
    """The sharded fit on maria_tpu's blocks (convert.ml_state_from_arrays
    takes each rank's rows) within 1e-3 of its maximum of maria_tpu's
    single-device fit, and of the port's one-process fit on them."""
    ranks, ref = world
    tpu = np.nan_to_num(np.asarray(ref["tpu_ml"].data))
    for out in ranks:
        assert rel_max(out["ml_ref_data"], tpu) <= 1e-3
        assert rel_max(out["ml_ref_data"], ref["ml_ref"].data.numpy()) <= 1e-3


# -- the streamed run ---------------------------------------------------------------------------------------------


def test_streamed_mesh_equals_single_process(world):
    """run(mesh=) over four det ranks with the executor's own draws: hits
    equal, sums within rtol 1e-5 and atol 1e-3 (tests/test_streaming_exec.
    py:165-166), every sample in the map, the Welch PSD within 1e-5."""
    ranks, ref = world
    one, program = ref["st"], ref["stream_program"]
    for out in ranks:
        np.testing.assert_array_equal(out["st_wgt"], one.map_wgt)
        np.testing.assert_allclose(out["st_sum"], one.map_sum, rtol=1e-5, atol=1e-3)
        assert float(out["st_wgt"].astype(np.float64).sum()) == program.n_det * program.n_t
        np.testing.assert_allclose(out["st_psd"], np.stack(one.psds), rtol=1e-5)


def test_streamed_mesh_on_maria_tpu_draws(world):
    """run(mesh=) on maria_tpu's state and normals (global, each rank takes
    its rows): equal to the port's one-process run on them (hits exact,
    rtol 1e-5 / atol 1e-3), and to maria_tpu's scatter-binned run as
    tests/test_torch_streaming.py holds the one-process run (the
    pointing's ulps move under 1% of the hits)."""
    ranks, ref = world
    one, tpu = ref["st_ref"], ref["tpu_st"]
    for out in ranks:
        np.testing.assert_array_equal(out["st_ref_wgt"], one.map_wgt)
        np.testing.assert_allclose(out["st_ref_sum"], one.map_sum, rtol=1e-5, atol=1e-3)
        assert np.abs(out["st_ref_wgt"] - tpu.map_wgt).sum() <= 1e-2 * tpu.map_wgt.sum()
        np.testing.assert_allclose(out["st_ref_sum"].sum(dtype=np.float64), tpu.map_sum.sum(dtype=np.float64),
                                   rtol=1e-5)


def test_pad_detectors_keeps_padding_off_the_map(world):
    """pad_detectors(4): 217 rows become 220 (the last replicated), and the
    padded rows never reach the map: n_real_det x n_t hits, sharded and
    not, the two runs equal as above."""
    ranks, ref = world
    padded, one = ref["pad_program"], ref["pad"]
    assert padded.n_real_det == 217 and padded.n_det == 220
    assert one.map_wgt.astype(np.float64).sum() == one.n_samples == 217 * padded.n_t
    for out in ranks:
        assert int(out["pad_samples"]) == one.n_samples
        np.testing.assert_array_equal(out["pad_wgt"], one.map_wgt)
        np.testing.assert_allclose(out["pad_sum"], one.map_sum, rtol=1e-5, atol=1e-3)


def test_sharded_checkpoint_resumes(world):
    """A sharded run broken off after two blocks' checkpoints (written by
    rank 0 in the single-process layout) and resumed by the world equals
    the uninterrupted one-process run (hits exact, sums and PSD within
    1e-5); the checkpoint also resumes in one process."""
    from maria_torch.ops.streaming_exec import StreamingExecutor

    ranks, ref = world
    full = ref["resumed"]
    program = ref["stream_program"]
    for out in ranks:
        np.testing.assert_array_equal(out["resumed_wgt"], full.map_wgt)
        np.testing.assert_allclose(out["resumed_sum"], full.map_sum, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(out["resumed_psd"], np.stack(full.psds), rtol=1e-5)
    ex = StreamingExecutor(program, ref["stream_obs"], block_tc=8, device="cpu")
    one = ex.run(SEED, group_size=1, accumulate_psd=True, checkpoint_path=str(ref["tmp"] / "stream.ckpt.npz"))
    np.testing.assert_array_equal(one.map_wgt, full.map_wgt)
    np.testing.assert_allclose(one.map_sum, full.map_sum, rtol=1e-5, atol=1e-3)


# -- the time-sharded extrusion -----------------------------------------------------------------------------------


def test_extrude_time_sharded_equals_sequential(world):
    """The halo ring over four time ranks, all-gathered on every rank,
    equals StreamingExtrusion.run_chunks(4) on the same generator bit for
    bit (tests/test_streaming.py:63-76 holds maria_tpu so)."""
    ranks, _ = world
    for out in ranks:
        assert out["ext"].shape == (WORLD * CHUNK_ROWS, 12)
        np.testing.assert_array_equal(out["ext"], out["ext_seq"])
        np.testing.assert_array_equal(out["ext"], ranks[0]["ext"])


def test_extrude_time_sharded_against_maria_tpu(world):
    """On maria_tpu's innovations the port's ring equals maria_tpu's
    extrude_time_sharded on its virtual 4-device time mesh within the AR
    gate, 1e-4 of the screen's std."""
    ranks, ref = world
    tpu = ref["tpu_ext"]
    for out in ranks:
        assert float(np.abs(out["ext_ref"] - tpu).max()) <= 1e-4 * float(tpu.std())
