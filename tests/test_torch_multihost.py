"""The port's multi-process bring-up on the CPU: ``initialize_multihost``,
the ("dcn", "det", "time") mesh, ``process_detector_range``,
``host_local_shard``, a rank's rows of the TOD program (``rows=``) and
its draws.

One gloo world of two ranks is started once for the module
(``torch.multiprocessing``, spawn) through ``initialize_multihost`` with
a file rendezvous under the test's temporary directory, a 60 s
``init_process_group`` timeout and a JOIN_SECONDS join, past which the
ranks are killed. Each rank writes its results to an .npz; the parent
computes the single-process runs meanwhile. The draws' rows are held bit
for bit; a rank's TOD rows within 1e-5 of the rows' std (the matrix
products' row counts differ, so the sums round in another order).
"""

import os
import time
from datetime import timedelta

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import maria_torch  # noqa: E402

WORLD = 2
JOIN_SECONDS = 240
SEED = 5
ATLAST_BANDS = [f"atlast/f{b}" for b in ("042", "093", "150", "220", "280", "350", "400", "650", "850")]
ATLAST_ARRAY = {"primary_size": 50, "n": 19, "field_of_view": 2.0, "shape": "circle", "bands": ATLAST_BANDS}
ATLAST_PLAN = dict(start_time=1.75e9, scan_center=(150.0, 41.0), frame="az/el", duration=10.0, sample_rate=50.0,
                   scan_options={"radius": 0.5, "speed": 0.25})
TEST_PLAN = dict(start_time=1.75e9, sample_rate=32, scan_center=(60.0, 45.0))
K3_C = np.linspace(0.5, 2.0, 257).astype(np.float32)  # a spectrum for K3's rows: m + 1 = 257


def programs(cache_dir):
    """{"atlast": the small AtLAST scene's program (nine bands of one
    spectral shape: V from kernel K3), "test": test/1deg's (two bands of
    their own shapes, maria_tpu's tests/test_parallel.py scene)}."""
    from maria_torch.ops.program import build_tod_program

    maria_torch.set_cache_dir(cache_dir)
    atlast = maria_torch.Simulation(instrument=maria_torch.get_instrument(array=ATLAST_ARRAY),
                                    plans=maria_torch.get_plan("daisy_5arcmin_60s", **ATLAST_PLAN), site="ALMA",
                                    atmosphere="3d", noise=True, seed=0, device="cpu")
    test = maria_torch.Simulation(instrument="test/1deg", plans=maria_torch.get_plan("five_second_stare", **TEST_PLAN),
                                  site="chajnantor", atmosphere="2d", noise=True, seed=1, device="cpu")
    return {"atlast": atlast.program(),
            "test": build_tod_program(test.obs_list[0], noise_kwargs=test.noise_kwargs, device="cpu")}


def generator(seed=SEED):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def rank_main(rank, world, tmp, _):
    """One rank: bring-up, the mesh, host-local loading, its program rows."""
    import torch.distributed as dist

    from maria_torch.ops.shared_v import draw_key, shared_v
    from maria_torch.parallel.multihost import create_multihost_mesh, host_local_shard, initialize_multihost, \
        is_multihost, process_detector_range

    torch.set_num_threads(1)
    os.environ.pop("MARIA_TORCH_MULTIHOST", None)
    out = {"before": is_multihost()}
    kwargs = dict(init_method=f"file://{tmp}/rendezvous", world_size=world, rank=rank, backend="gloo",
                  timeout=timedelta(seconds=60))
    out["up"] = initialize_multihost(**kwargs)
    try:
        out["again"] = initialize_multihost(**kwargs)
        mesh = create_multihost_mesh(device="cpu")
        out["names"] = np.array(mesh.axis_names)
        out["shape"] = np.array(mesh.shape)
        out["range"] = np.array(process_detector_range(1000, mesh))
        dcn = create_multihost_mesh(dcn_size=2, device="cpu")
        out["dcn_shape"] = np.array(dcn.shape)
        out["dcn_range"] = np.array(process_detector_range(1000, dcn, axis=("dcn", "det")))
        try:
            create_multihost_mesh(dcn_size=3, device="cpu")
            out["refused_dcn"] = False
        except ValueError:
            out["refused_dcn"] = True

        calls = []
        full = np.arange(64 * 48, dtype=np.float32).reshape(64, 48)

        def fill(index):
            calls.append([(s.start, s.stop) for s in index])
            return full[index]

        out["shard"] = host_local_shard(mesh, (64, 48), fill).numpy()
        out["calls"] = np.array(calls)

        # a rank's rows of the program: its draws and its TOD rows, each
        # built only for its detector range through host_local_shard
        for name, program in programs(f"{tmp}/cache{rank}").items():
            start, stop = process_detector_range(program.n_det, mesh)
            tp = program.total_power_fn()
            out[f"{name}_tod"] = host_local_shard(
                mesh, (program.n_det, program.n_t),
                lambda index: tp(generator=generator(), device="cpu", rows=(index[0].start, index[0].stop))).numpy()
            out[f"{name}_gains"] = program.draw_gains(generator(), device="cpu", rows=(start, stop)).numpy()
            fields, _ = program.fields(generator(), device="cpu", rows=(start, stop))
            for field, value in fields.items():
                out[f"{name}_field_{field}"] = value.numpy()
        start, stop = process_detector_range(1001, mesh)
        out["v_rows"] = shared_v(draw_key(generator(), "cpu"), K3_C, stop - start, row0=start)[0].float().numpy()
        out["v_range"] = np.array((start, stop))
        np.savez(f"{tmp}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def run_world(fn, world, tmp, inputs, timeout=JOIN_SECONDS):
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


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world")
    old = maria_torch.io._cache_state["base"]
    join = run_world(rank_main, WORLD, tmp, None)
    try:
        progs = programs(str(tmp_path_factory.mktemp("maria_torch_cache")))
        ref = {}
        for name, program in progs.items():
            ref[f"{name}_tod"] = program.total_power_fn()(generator=generator(), device="cpu").numpy()
            ref[f"{name}_gains"] = program.draw_gains(generator(), device="cpu").numpy()
            fields, _ = program.fields(generator(), device="cpu")
            for field, value in fields.items():
                ref[f"{name}_field_{field}"] = value.numpy()
        ref["programs"] = progs
        ranks = join()
    finally:
        maria_torch.io._cache_state["base"] = old
    return ranks, ref


def test_initialize_is_noop_single_process(monkeypatch):
    import torch.distributed as dist

    from maria_torch.parallel.multihost import initialize_multihost, is_multihost

    monkeypatch.delenv("MARIA_TORCH_MULTIHOST", raising=False)
    assert initialize_multihost() is False
    assert is_multihost() is False and not dist.is_initialized()


def test_create_multihost_mesh_needs_a_world():
    from maria_torch.parallel.multihost import create_multihost_mesh

    with pytest.raises(RuntimeError, match="initialize_multihost"):
        create_multihost_mesh(device="cpu")


def test_bring_up_and_mesh_layout(world):
    """initialize_multihost brings the world up once (idempotent); the mesh
    is ("dcn", "det", "time") with one node's ranks inside (1, 2, 1), or
    (2, 1, 1) split into two DCN groups; a split that does not divide is
    refused."""
    ranks, _ = world
    for out in ranks:
        assert not bool(out["before"]) and bool(out["up"]) and bool(out["again"])
        assert list(out["names"]) == ["dcn", "det", "time"]
        assert tuple(out["shape"]) == (1, 2, 1) and tuple(out["dcn_shape"]) == (2, 1, 1)
        assert bool(out["refused_dcn"])


def test_process_detector_range_covers_all_rows(world):
    """The ranks' detector ranges tile [0, n_det) in order, along "det" and
    along ("dcn", "det")."""
    ranks, _ = world
    for key in ("range", "dcn_range"):
        assert [tuple(out[key]) for out in ranks] == [(0, 500), (500, 1000)]


def test_host_local_shard_fill_sees_only_its_rows(world):
    """fill is called once a rank, with that rank's rows and every column,
    and the block lands as the global array's rows."""
    ranks, _ = world
    full = np.arange(64 * 48, dtype=np.float32).reshape(64, 48)
    for r, out in enumerate(ranks):
        assert out["calls"].tolist() == [[[32 * r, 32 * r + 32], [0, 48]]]
        np.testing.assert_array_equal(out["shard"], full[32 * r:32 * r + 32])


@pytest.mark.parametrize("name", ["atlast", "test"])
def test_sharded_draws_equal_unsharded_rows(world, name):
    """A rank's draws are the unsharded run's rows bit for bit: the gains,
    and every field of ``fields`` (the atmosphere from the same screens,
    each band's noise from the band's whole white draw cut to the rank's
    rows); its total-power rows, built by host_local_shard from
    total_power_fn(rows=), within 1e-5 of the rows' std."""
    ranks, ref = world
    program = ref["programs"][name]
    for r, out in enumerate(ranks):
        start, stop = (0, -(-program.n_det // 2)) if r == 0 else (-(-program.n_det // 2), program.n_det)
        np.testing.assert_array_equal(out[f"{name}_gains"], ref[f"{name}_gains"][start:stop])
        for key in ref:
            if key.startswith(f"{name}_field_"):
                np.testing.assert_array_equal(out[key], ref[key][start:stop])
        rows = ref[f"{name}_tod"][start:stop]
        assert out[f"{name}_tod"].shape == rows.shape
        assert float(np.abs(out[f"{name}_tod"] - rows).max()) <= 1e-5 * float(rows.std())


def test_atlast_program_takes_the_k3_route(world):
    _, ref = world
    assert ref["programs"]["atlast"]._noise_matmul_specs()[3] is not None


def test_k3_rows_at_row0_equal_the_unsharded_rows(world):
    """Kernel K3's plain version at row0 (1,001 rows over two ranks) draws
    exactly the rows of the unsharded V, bit for bit."""
    from maria_torch.ops.shared_v import draw_key, shared_v_plain

    ranks, _ = world
    full = shared_v_plain(draw_key(generator(), "cpu"), K3_C, 1001)[0].float().numpy()
    for out in ranks:
        start, stop = out["v_range"]
        np.testing.assert_array_equal(out["v_rows"], full[start:stop])


def test_pad_detectors_matches_maria_tpu(tmp_path):
    """pad_detectors on the port's test/1deg program (120 detectors, padded
    to a multiple of 7) pads as maria_tpu's: the last detector replicated
    into the last band, n_real_det kept, a second call a no-op."""
    import copy

    import maria_tpu
    from maria_tpu.io import caching as tpu_caching
    from maria_tpu.ops.program import build_tod_program as ref_build

    from maria_torch.ops.program import build_tod_program

    old_tpu, old_torch = tpu_caching.get_cache_dir(), maria_torch.io._cache_state["base"]
    maria_tpu.set_cache_dir(str(tmp_path / "maria_tpu_cache"))
    maria_torch.set_cache_dir(str(tmp_path / "maria_torch_cache"))
    try:
        ref_sim = maria_tpu.Simulation(instrument="test/1deg", site="chajnantor", atmosphere="2d", noise=True, seed=1,
                                       plans=maria_tpu.get_plan("five_second_stare", **TEST_PLAN))
        ref = ref_build(ref_sim.obs_list[0], noise_kwargs=ref_sim.noise_kwargs)
        sim = maria_torch.Simulation(instrument="test/1deg", site="chajnantor", atmosphere="2d", noise=True, seed=1,
                                     plans=maria_torch.get_plan("five_second_stare", **TEST_PLAN), device="cpu")
        ours = copy.deepcopy(build_tod_program(sim.obs_list[0], noise_kwargs=sim.noise_kwargs, device="cpu"))
    finally:
        maria_tpu.set_cache_dir(old_tpu)
        maria_torch.io._cache_state["base"] = old_torch
    n = ours.n_det
    assert n == 120 and ours.pad_detectors(7) == ref.pad_detectors(7) == 6
    assert ours.n_real_det == ref.n_real_det == n and ours.pad_detectors(7) == 0
    np.testing.assert_array_equal(ours.offsets, np.asarray(ref.offsets, dtype=np.float32))
    np.testing.assert_array_equal(ours.mueller_I, np.asarray(ref.mueller_I))
    np.testing.assert_array_equal(ours.gain_error, np.asarray(ref.gain_error))
    for a, b in zip(ours.bands, ref.bands):
        np.testing.assert_array_equal(a.det_index, b.det_index)
        if b.noise_basis is not None:
            np.testing.assert_allclose(a.noise_basis, np.asarray(b.noise_basis), rtol=1e-5, atol=1e-6)
    assert ours.band_order == ref.band_order and ours.band_bounds() == ref.band_bounds()
    # maria_tpu's padded program carried across keeps its real count
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_slice import program_tables

    from maria_torch.convert import program_from_tables

    carried = program_from_tables(program_tables(ref) | {"n_real_det": ref.n_real_det})
    assert carried.n_det == n + 6 and carried.n_real_det == n


@pytest.mark.parametrize("shared", [True, False])
def test_noise_matmul_rows_equal_unsharded_rows(shared):
    """noise_total_matmul(rows=) draws as the unsharded call does (modes
    whole; V by K3's row0, or each band's whole white block cut to the
    rows) and gives the unsharded rows, within 1e-5 of their std (the
    matrix product's row count differs)."""
    from maria_torch.noise import band_half_spectrum
    from maria_torch.noise.dft import NoiseBandSpec, noise_total_matmul

    n, n_fft = 300, 320
    rng = np.random.default_rng(0)
    bounds = [(0, 13), (13, 40), (40, 57)]
    specs, cols = [], np.zeros((57, 4), np.float32)
    for i, (a, b) in enumerate(bounds):
        knee = 0.5 if shared else 0.2 * (i + 1)
        c = band_half_spectrum(50.0, knee, 1.0, n_fft, corr_prop=0.5)
        k = 2 if i != 1 else 0
        if k:
            col0 = 0 if i == 0 else 2
            cols[a:b, col0:col0 + k] = rng.standard_normal((b - a, k))
        specs.append(NoiseBandSpec(start=a, stop=b, c=(1.0 if shared else 2.0 + i) * c, k_modes=k,
                                   mode_c=band_half_spectrum(50.0, knee, 1.0, n_fft, pink_only=True), key_index=i))
    shared_c = band_half_spectrum(50.0, 0.5, 1.0, n_fft, corr_prop=0.5) if shared else None
    row_scale = rng.uniform(1.0, 2.0, (57, 1)).astype(np.float32) if shared else None
    A = torch.as_tensor(rng.standard_normal((57, n)).astype(np.float32))
    full = noise_total_matmul(A.clone(), specs, n=n, n_fft=n_fft, corr_cols=cols, shared_c=shared_c,
                              row_scale=row_scale, generator=generator(), device="cpu").numpy()
    for start, stop in ((0, 20), (20, 41), (41, 57)):
        part = noise_total_matmul(A[start:stop].clone(), specs, n=n, n_fft=n_fft, corr_cols=cols[start:stop],
                                  shared_c=shared_c, row_scale=None if row_scale is None else row_scale[start:stop],
                                  generator=generator(), device="cpu", rows=(start, stop)).numpy()
        assert part.shape == (stop - start, n)
        assert float(np.abs(part - full[start:stop]).max()) <= 1e-5 * float(full[start:stop].std())


@pytest.mark.parametrize("knee", [0.0, 0.5])
def test_noise_and_gain_rows_equal_unsharded_rows(knee):
    """generate_noise_with_knee(rows=) and gain_errors(rows=) draw at the
    whole shape and keep the slice: bit-equal to those rows of the call
    without it, an empty slice included (a rank holding none of a band)."""
    from maria_torch.noise import generate_noise_with_knee
    from maria_torch.ops.program import gain_errors

    n_det, n = 40, 300
    basis = np.random.default_rng(1).standard_normal((n_det, 3)).astype(np.float32)
    kw = dict(sample_rate=50.0, knee=knee, basis=basis, corr_prop=0.4, device="cpu")
    gain_error = np.linspace(0.01, 0.1, n_det)
    full = generate_noise_with_knee((n_det, n), generator=generator(), **kw).numpy()
    gains = gain_errors(gain_error, generator(), device="cpu").numpy()
    for rows in (slice(0, 17), slice(17, 40), slice(40, 40)):
        part = generate_noise_with_knee((n_det, n), generator=generator(), rows=rows, **kw).numpy()
        assert part.shape == (rows.stop - rows.start, n)
        np.testing.assert_array_equal(part, full[rows])
        np.testing.assert_array_equal(gain_errors(gain_error, generator(), device="cpu", rows=rows).numpy(),
                                      gains[rows])
