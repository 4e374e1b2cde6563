"""The port's autoregressive atmosphere (method="ar") against maria_tpu,
on CPU:

- the host numpy helpers (Matérn covariances, the Cholesky inverse);
- ``AutoregressiveProcess``: the decimated lookback, the live edge, the
  float64 operators A and B, the stability check and the jitter ladder;
- the extrusion loop (``ar_extrude_reference``, the plain version of the
  card's kernel) against ``_ar_extrude_noise`` given the same operators,
  buffer and innovations, at the shapes of the MUSTANG-2 60 s scene's
  longest process and of the AtLAST-50k 3-D process;
- the beam blur, the screen geometry of ``Atmosphere.initialize`` and the
  whole path to pwv (2-D and 3-D) given the same draws;
- the structure-function oracles of tests/test_atmosphere_fidelity.py
  (AR and Fourier) and the Fourier-against-AR comparisons of
  tests/test_atmosphere3d.py on the port's own generator.

Scenes: MUSTANG-2 at GBT on a 10 s daisy (2-D) and the small AtLAST-shaped
instrument (nine atlast bands, 19 detectors each) at ALMA on a 10 s daisy
(3-D), each built by both packages with private data caches.
"""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import maria_torch  # noqa: E402
import maria_tpu  # noqa: E402
from maria_tpu import functions as ref_functions  # noqa: E402
from maria_tpu import utils as ref_utils  # noqa: E402
from maria_tpu.atmosphere import process as ref_process  # noqa: E402
from maria_tpu.io import caching as tpu_caching  # noqa: E402

from maria_torch import utils  # noqa: E402
from maria_torch.atmosphere.process import AutoregressiveProcess  # noqa: E402
from maria_torch.convert import ar_process_from_arrays  # noqa: E402
from maria_torch.ops.ar_extrude import (  # noqa: E402
    ar_cluster_size,
    ar_extrude,
    ar_extrude_reference,
    ar_plan,
    ar_smem_bytes,
    ar_tables,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_atmosphere_fidelity import NU, R0, RES, analytic_d_half  # noqa: E402

ATLAST_ARRAY = {"primary_size": 50, "n": 19, "field_of_view": 2.0, "shape": "circle",
                "bands": [f"atlast/f{b}" for b in ("042", "093", "150", "220", "280", "350", "400", "650", "850")]}
SCENES = {
    "2d": dict(instrument="MUSTANG-2", site="GBT", atmosphere="2d",
               plan=dict(duration=10.0, scan_options={"radius": 0.083, "speed": 0.017})),
    "3d": dict(instrument=ATLAST_ARRAY, site="ALMA", atmosphere="3d",
               plan=dict(duration=10.0, scan_options={"radius": 0.5, "speed": 0.25})),
}
# (n_extrusion, points a layer, layers) -> (n_extrusion, n_cross,
# n_sample): the MUSTANG-2 60 s scene's longest process, and AtLAST-50k's
# 60 s 3-D process (12 stacked layers of 21 points)
SHAPES = {"e_top": ((174, 14, 1), (174, 14, 53)), "g_3d": ((209, 21, 12), (209, 252, 510))}


def _instrument(pkg, spec):
    return pkg.get_instrument(array=spec) if isinstance(spec, dict) else spec


def _simulation(pkg, model, method="ar", seed=0, noise=True, **kw):
    s = SCENES[model]
    plan = pkg.get_plan("daisy_5arcmin_60s", start_time=1.75e9, scan_center=(150.0, 41.0), frame="az/el",
                        sample_rate=50.0, **s["plan"])
    return pkg.Simulation(instrument=_instrument(pkg, s["instrument"]), plans=plan, site=s["site"],
                          atmosphere=s["atmosphere"], atmosphere_kwargs={"method": method}, noise=noise,
                          seed=seed, **kw)


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    old_tpu, old_torch = tpu_caching.get_cache_dir(), maria_torch.io._cache_state["base"]
    maria_tpu.set_cache_dir(str(tmp_path_factory.mktemp("maria_tpu_cache")))
    maria_torch.set_cache_dir(str(tmp_path_factory.mktemp("maria_torch_cache")))
    yield
    maria_tpu.set_cache_dir(old_tpu)
    maria_torch.set_cache_dir(old_torch)


@pytest.fixture(scope="module")
def scenes(caches):
    """Both packages' AR simulations and programs of the 2-D and 3-D scene."""
    from maria_tpu.ops.program import build_tod_program

    out = {}
    for model in SCENES:
        ref_sim = _simulation(maria_tpu, model)
        sim = _simulation(maria_torch, model, device="cpu")
        out[model] = {"ref_sim": ref_sim, "sim": sim, "program": sim.program(),
                      "ref_program": build_tod_program(ref_sim.obs_list[0], noise_kwargs=ref_sim.noise_kwargs)}
    return out


def _geometry(shape):
    """(cross_section, extrusion, nu, r0) of a process of ``shape``:
    (n_extrusion, points a layer, layers)."""
    n_ext, n_layer, n_layers = shape
    heights = np.geomspace(50.0, 5000.0, n_layers) if n_layers > 1 else np.array([10000.0])
    cross = np.concatenate([np.stack([12.5 * np.arange(n_layer), np.full(n_layer, h)], axis=-1) for h in heights])
    return cross, 12.5 * np.arange(n_ext), (1 / 3 if n_layers > 1 else 5 / 6), max(1e3, 300 + heights.mean() / 10)


def _f64_setup(monkeypatch, proc):
    """maria_tpu's float64 A and B: its setup, with the final cast to
    float32 device arrays kept on the host in float64."""
    monkeypatch.setattr(ref_process, "jnp", types.SimpleNamespace(asarray=lambda x, dtype=None: np.asarray(x),
                                                                  float32=None))
    proc.run_setup()
    monkeypatch.undo()
    return proc.A, proc.B


# -- host helpers and the process's setup --------------------------------------------------


def test_matern_helpers_and_inverse_match():
    r = np.geomspace(1e-7, 5e3, 257)
    for nu in (1 / 3, 5 / 6):
        np.testing.assert_allclose(utils.normalized_matern(r, nu), ref_functions.normalized_matern(r, nu), rtol=1e-13)
        np.testing.assert_allclose(utils.approximate_normalized_matern(r, nu=nu, r0=700.0),
                                   ref_functions.approximate_normalized_matern(r, nu=nu, r0=700.0), rtol=1e-13)
    x = np.random.default_rng(0).standard_normal((40, 40))
    M = x @ x.T + 40 * np.eye(40)
    np.testing.assert_allclose(utils.fast_psd_inverse(M), ref_utils.fast_psd_inverse(M), rtol=1e-13)
    with pytest.raises(np.linalg.LinAlgError):
        utils.fast_psd_inverse(-M)


@pytest.mark.parametrize("shape", [(40, 9, 1), (60, 7, 4)], ids=["2d_slab", "3d_stack"])
def test_process_setup_matches(monkeypatch, shape):
    """The lookback and live-edge geometry equal maria_tpu's exactly, A
    and B its float64 operators to 1e-10 relative."""
    cross, ext, nu, r0 = _geometry(shape)
    kw = dict(callback_kwargs={"nu": nu, "r0": r0})
    ours = AutoregressiveProcess(cross, ext, **kw)
    ref = ref_process.AutoregressiveProcess(cross, ext, **kw)
    for k in ("cross_section_sample_index", "extrusion_sample_index", "sample_points", "live_edge_points"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(ref, k))
    assert (ours.n_sample, ours.n_live_edge, ours.extrusion_res) == (ref.n_sample, ref.n_live_edge, ref.extrusion_res)
    A, B = _f64_setup(monkeypatch, ref)
    ours.run_setup()
    assert A.dtype == B.dtype == ours.A.dtype == ours.B.dtype == np.float64
    np.testing.assert_allclose(ours.A, A, rtol=1e-10, atol=1e-10 * np.abs(A).max())
    np.testing.assert_allclose(ours.B, B, rtol=1e-10, atol=1e-10 * np.abs(B).max())
    assert ours.jitter == ref.jitter == 1e-8


def test_unstable_propagator_raises_as_jax():
    """A covariance whose propagator has a row sum above one raises
    ValueError in both packages (the jitter ladder does not catch it)."""
    from scipy.special import j0

    cross, ext = np.stack([10 * np.arange(8), np.full(8, 500.0)], axis=-1), 10 * np.arange(32)
    for cls in (AutoregressiveProcess, ref_process.AutoregressiveProcess):
        proc = cls(cross, ext, callback=lambda d: j0(d / 20))
        with pytest.raises(ValueError, match="unstable"):
            proc.run_setup()
        assert proc.jitter == 1e-8


def test_jitter_ladder_matches_jax():
    """A covariance that is singular at the first jitter escalates to the
    next one; one singular at every jitter raises LinAlgError at 1e-4;
    both as maria_tpu does."""
    cross, ext = np.stack([10 * np.arange(8), np.full(8, 500.0)], axis=-1), 10 * np.arange(32)

    def first_attempt_singular():
        calls = [0]

        def callback(d):
            calls[0] += 1  # three covariance blocks an attempt
            return np.cos(d / 40) if calls[0] <= 3 else utils.approximate_normalized_matern(d, nu=NU, r0=R0)

        return callback

    procs = [cls(cross, ext, callback=first_attempt_singular())
             for cls in (AutoregressiveProcess, ref_process.AutoregressiveProcess)]
    for proc in procs:
        proc.run_setup()
        assert proc.jitter == 1e-6 and proc._computed
    np.testing.assert_allclose(procs[0].A, np.asarray(procs[1].A), rtol=1e-5, atol=1e-6)
    for cls in (AutoregressiveProcess, ref_process.AutoregressiveProcess):
        proc = cls(cross, ext, callback=lambda d: np.cos(d / 40))
        with pytest.raises(np.linalg.LinAlgError, match="max jitter"):
            proc.run_setup()
        assert proc.jitter == 1e-4 and not proc._computed


# -- the extrusion loop -------------------------------------------------------------------------


@pytest.mark.parametrize("shape,sizes", list(SHAPES.values()), ids=list(SHAPES))
def test_extrusion_loop_matches_jax(shape, sizes):
    """ar_extrude_reference (and ar_extrude on CPU tensors) against
    maria_tpu's _ar_extrude_noise with the same float32 A, B, buffer and
    innovations: within 2e-5 of the buffer's std. Both run float32
    matrix-vector products summed in different orders (the TPU package's
    on XLA's CPU dot), and each row's rounding enters every later row
    through the lookback."""
    cross, ext, nu, r0 = _geometry(shape)
    ref = ref_process.AutoregressiveProcess(cross, ext, callback_kwargs={"nu": nu, "r0": r0})
    ref.run_setup()
    n_steps, n_cross = 2 * ref.n_extrusion, ref.n_cross_section
    assert (ref.n_extrusion, n_cross, ref.n_sample) == sizes
    rng = np.random.default_rng(3)
    buffer = rng.standard_normal((ref.n_extrusion + n_steps, n_cross)).astype(np.float32)
    noise = rng.standard_normal((n_steps, n_cross)).astype(np.float32)
    expected = np.asarray(ref_process._ar_extrude_noise(ref.A, ref.B, jnp.asarray(buffer), ref._ext_idx,
                                                        ref._cross_idx, jnp.asarray(noise)))
    A, B = torch.as_tensor(np.asarray(ref.A)), torch.as_tensor(np.asarray(ref.B))
    ext_idx = torch.as_tensor(np.asarray(ref.extrusion_sample_index))
    cross_idx = torch.as_tensor(np.asarray(ref.cross_section_sample_index))
    got = ar_extrude_reference(A, B, torch.as_tensor(buffer), ext_idx, cross_idx, torch.as_tensor(noise)).numpy()
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, rtol=0, atol=2e-5 * expected.std())
    np.testing.assert_array_equal(got[-ref.n_extrusion:], buffer[-ref.n_extrusion:])  # the lookback rows stay

    proc = ar_process_from_arrays(np.asarray(ref.A), np.asarray(ref.B),
                                                      ref.extrusion_sample_index, ref.cross_section_sample_index)
    (values,) = ar_extrude([proc], [torch.as_tensor(buffer)], [torch.as_tensor(noise)])
    np.testing.assert_array_equal(values.numpy(), got[: ref.n_extrusion])


SMEM_LIMIT = 232448  # bytes of shared memory a block may take on an H100
ALL_SIZES = (1, 2, 4, 8)  # the cluster sizes the kernel runs on; the plan's rule picks from 1 and 8


def test_kernel_stages_every_2d_process_in_shared_memory(scenes):
    """A and B fit one block's shared memory (227 KB on an H100) for every
    2-D process of the scenes the card runs (at most 103 x 217, AtLAST-50k
    2-D): a cluster of one. The 3-D process (252 x 510) does not fit one
    block and takes a cluster of eight, whose blocks hold 32 rows of A and
    B each; a process too large for that reads them through L2 from one
    block."""
    for n_cross, n_sample in ((103, 217), (14, 53), (15, 66)):
        assert ar_cluster_size(n_cross, n_sample, SMEM_LIMIT) == 1
    plan = ar_plan(scenes["2d"]["program"].ar_processes, "cpu", smem_limit=SMEM_LIMIT)
    assert plan["cluster"] == [1] * 8 and [g["cluster"] for g in plan["groups"]] == [1]
    assert plan["groups"][0]["smem"] <= SMEM_LIMIT
    assert ar_smem_bytes(252, 510, 2) > SMEM_LIMIT >= ar_smem_bytes(252, 510, 4) > ar_smem_bytes(252, 510, 8)
    assert ar_cluster_size(252, 510, SMEM_LIMIT) == 8 and ar_cluster_size(252, 510, SMEM_LIMIT, ALL_SIZES) == 4
    assert ar_cluster_size(700, 1500, SMEM_LIMIT) == 0 and ar_smem_bytes(700, 1500, 0) <= 48 * 1024


def _small_process(shape, indices=None):
    """A process of ``shape`` (n_extrusion, points a layer, layers) after
    its setup; with ``indices`` (ext_idx, cross_idx) its lookback replaced
    by those samples and A by a random stable operator of their width."""
    cross, ext, nu, r0 = _geometry(shape)
    proc = AutoregressiveProcess(cross, ext, callback_kwargs={"nu": nu, "r0": r0})
    proc.run_setup()
    if indices is not None:
        proc.extrusion_sample_index, proc.cross_section_sample_index = map(np.asarray, indices)
        proc.n_sample = len(indices[0])
        proc.A = np.random.default_rng(2).uniform(-1, 1, (proc.n_cross_section, proc.n_sample)) / proc.n_sample
        proc._device_cache = {}
    return proc


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 0])
def test_plan_picks_the_smallest_cluster_that_fits(cluster):
    """Under a shared-memory limit between the needs of two cluster sizes,
    ar_plan, offered every size, gives a 40 x 87 process the larger one (0:
    none fits, one block reads A and B through L2), rows split evenly,
    beside a small process that keeps a cluster of one: a launch a cluster
    size. Its own rule takes eight blocks wherever one is too few."""
    big, small = _small_process((30, 10, 4)), _small_process((12, 6, 1))
    n_cross, n_sample = big.n_cross_section, big.n_sample
    assert (n_cross, n_sample) == (40, 87)
    need = {c: ar_smem_bytes(n_cross, n_sample, c) for c in (1, 2, 4, 8)}
    assert need[1] > need[2] > need[4] > need[8] > ar_smem_bytes(n_cross, n_sample, 0)
    limit = need[cluster] if cluster else need[8] - 4
    assert ar_cluster_size(n_cross, n_sample, limit, ALL_SIZES) == cluster
    assert ar_cluster_size(n_cross, n_sample, limit) == (cluster if cluster < 2 else 8)
    if cluster:  # four bytes less and it takes the next size
        assert ar_cluster_size(n_cross, n_sample, limit - 4, ALL_SIZES) == {1: 2, 2: 4, 4: 8, 8: 0}[cluster]
    plan = ar_plan([small, big, small], "cpu", smem_limit=limit, sizes=ALL_SIZES)
    assert plan["cluster"] == [1, cluster, 1]
    if cluster > 1:
        g1, g = plan["groups"]
        assert (g1["cluster"], g1["index"], g["cluster"], g["index"]) == (1, [0, 2], cluster, [1])
        assert g["rows"] == [n_cross // cluster] and g["threads"] == 32 * g["rows"][0]
    else:
        (g,) = plan["groups"]
        assert g["cluster"] == 1 and g["index"] == [0, 1, 2] and g["rows"] == [6, 40, 6]
        assert g["desc"].reshape(3, -1)[:, 8].tolist() == [1, int(cluster == 1), 1]
    assert all(x["smem"] <= limit for x in plan["groups"])


def _kernel_emulation(A, B, ext_idx, cross_idx, buffer, noise, cluster):
    """numpy emulation of csrc/ar_extrude.cu's schedule with the tables of
    ``ar_tables``: ``cluster`` blocks, each owning a share of the rows and
    holding two copies of the sample-and-innovation vector; the samples
    with ext_idx >= 1 and the innovations of step i + 1 loaded at the top
    of step i and stored after the dot; a finished row element written to
    the buffer and into the ext_idx == 0 slots of every block's next
    vector; a lane-strided dot into one accumulator and a shuffle tree, in
    float32. It tags every buffer row with the step that wrote it and
    asserts that what step i loads ahead lies in rows written in step
    i - 1 or earlier (or the initial lookback), and that a vector is
    complete when it is read. Returns the filled buffer."""
    n_cross, n_sample = A.shape
    n_steps, n_rows = noise.shape[0], buffer.shape[0]
    tab = ar_tables(ext_idx, cross_idx, n_cross)
    goff, old, new_start, new_slot = (tab[k].astype(np.int64) for k in ("goff", "old", "new_start", "new_slot"))
    assert len(old) + len(new_slot) == n_sample and new_start[0] == 0 and new_start[-1] == len(new_slot)
    flat = buffer.astype(np.float32).reshape(-1).copy()
    unwritten = n_steps + 1
    written = np.where(np.arange(n_rows) >= n_steps, -1, unwritten)  # the step that wrote each row
    eps_at = (n_sample + 31) & ~31
    vec = np.full((cluster, 2, eps_at + n_cross), np.nan, dtype=np.float32)
    rpb = -(-n_cross // cluster)
    shares = [range(min(n_cross, c * rpb), min(n_cross, (c + 1) * rpb)) for c in range(cluster)]
    assert sorted(r for share in shares for r in share) == list(range(n_cross))
    lanes = np.arange(32)

    first = (n_steps - 1) * n_cross + goff
    assert (written[first // n_cross] == -1).all()
    vec[:, 0, :n_sample] = flat[first]
    vec[:, 0, eps_at:] = noise[0]
    for i in range(n_steps):
        cur, nxt, more = i & 1, (i + 1) & 1, i + 1 < n_steps
        vec[:, nxt] = np.nan  # the copy step i - 1 read is free to fill
        if more:  # loaded at the top of the step, before any of its rows is written
            ahead = (n_steps - 2 - i) * n_cross + goff[old]
            assert (written[ahead // n_cross] <= i - 1).all()
            pre_samples, pre_eps = flat[ahead].copy(), noise[i + 1]
        b = n_steps - 1 - i
        for c, share in enumerate(shares):
            if not len(share):
                continue
            rows = np.asarray(share)
            v = vec[c, cur]
            assert np.isfinite(v[:n_sample]).all() and np.isfinite(v[eps_at:]).all()
            acc = np.zeros((len(rows), 32), dtype=np.float32)
            for weights, x in ((A[rows], v[:n_sample]), (B[rows], v[eps_at:])):
                for k in range(0, weights.shape[1], 32):
                    part = weights[:, k:k + 32] * x[k:k + 32]
                    acc[:, :part.shape[1]] += part
            for o in (16, 8, 4, 2, 1):
                acc = acc + acc[:, lanes ^ o]
            flat[b * n_cross + rows] = acc[:, 0]
            if more:
                for r, value in zip(rows, acc[:, 0]):
                    vec[:, nxt, new_slot[new_start[r]:new_start[r + 1]]] = value
        written[b] = i
        if more:
            vec[:, nxt, old] = pre_samples
            vec[:, nxt, eps_at:] = pre_eps
    assert (written[:n_steps] == np.arange(n_steps)[::-1]).all()
    return flat.reshape(n_rows, n_cross)


def _lookback(n_extrusion, n_cross):
    """The lookback indices AutoregressiveProcess derives for these sizes."""
    proc = AutoregressiveProcess(np.stack([np.arange(n_cross, dtype=float), np.zeros(n_cross)], axis=-1),
                                 np.arange(max(n_extrusion, 2), dtype=float))
    return proc.extrusion_sample_index, proc.cross_section_sample_index


EMULATED = {
    # name: (shape or None, (ext_idx, cross_idx) or None, cluster sizes)
    "e_top": (SHAPES["e_top"][0], None, (1, 2, 8)),
    "g_3d": (SHAPES["g_3d"][0], None, (4, 8)),
    # the shortest screens: their rings repeat lookback rows
    "n_extrusion_2": ((2, 9, 1), None, (1, 4)),
    "n_extrusion_3": ((3, 9, 1), None, (1, 2)),
    # one row of lookback, sampled at every column and again at four: a
    # column's element goes into two slots
    "n_extrusion_1": ((2, 9, 1), (np.zeros(13, dtype=int), np.r_[np.arange(9), 0, 2, 5, 8]), (1, 2)),
    # the newest row sampled at a strict subset of the columns, not first in
    # the sample order
    "newest_subset": ((8, 6, 1), (np.r_[1, 1, 1, 0, 0, 0, 2, 4, 7, 7], np.r_[0, 2, 5, 4, 0, 2, 1, 3, 0, 5]), (1, 2, 4)),
}


@pytest.mark.parametrize("name,cluster", [(k, c) for k, v in EMULATED.items() for c in v[2]])
def test_kernel_schedule_matches_plain(name, cluster):
    """The kernel's schedule, emulated in numpy (see _kernel_emulation,
    which also asserts what the loads a step ahead may read), against
    ar_extrude_reference on the same operators, buffer and innovations:
    within 2e-5 of the buffer's std (float32 dots summed in another
    order, the rounding carried through the lookback)."""
    shape, indices, _ = EMULATED[name]
    proc = _small_process(shape, indices)
    t = proc.tensors("cpu")
    n_rows = int(t["ext_idx"].max()) + 1 if name == "n_extrusion_1" else proc.n_extrusion
    n_steps, n_cross = 2 * n_rows, proc.n_cross_section
    rng = np.random.default_rng(7)
    buffer = rng.standard_normal((n_rows + n_steps, n_cross)).astype(np.float32)
    noise = rng.standard_normal((n_steps, n_cross)).astype(np.float32)
    ref = ar_extrude_reference(t["A"], t["B"], torch.as_tensor(buffer), t["ext_idx"], t["cross_idx"],
                               torch.as_tensor(noise)).numpy()
    got = _kernel_emulation(t["A"].numpy(), t["B"].numpy(), t["ext_idx"].numpy(), t["cross_idx"].numpy(), buffer,
                            noise, cluster)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * ref.std())
    np.testing.assert_array_equal(got[n_steps:], buffer[n_steps:])


def test_tables_of_a_process_with_its_newest_row_sampled_in_part():
    """A process whose ext_idx == 0 samples are a strict subset of the
    columns: ar_tables sends each column to the slots that sample it,
    ar_plan lays it out and ar_extrude (the plain loop, on CPU tensors)
    equals ar_extrude_reference."""
    shape, (ext_idx, cross_idx), _ = EMULATED["newest_subset"]
    proc = _small_process(shape, (ext_idx, cross_idx))
    tab = ar_tables(ext_idx, cross_idx, 6)
    assert tab["goff"].tolist() == ((ext_idx + 1) * 6 + cross_idx).tolist()
    assert tab["old"].tolist() == [0, 1, 2, 6, 7, 8, 9]
    assert tab["new_start"].tolist() == [0, 1, 1, 2, 2, 3, 3] and tab["new_slot"].tolist() == [4, 5, 3]
    with pytest.raises(ValueError, match="outside"):
        ar_tables(ext_idx, cross_idx, 5)
    plan = ar_plan([proc], "cpu", smem_limit=SMEM_LIMIT)
    (g,) = plan["groups"]
    assert g["tab"].numel() == 2 * 10 + 6 + 1 and g["desc"].tolist()[5:] == [6, 10, 16, 1, 7]
    rng = np.random.default_rng(1)
    buffer = torch.as_tensor(rng.standard_normal((proc.n_buffer, 6)).astype(np.float32))
    noise = torch.as_tensor(rng.standard_normal((proc.n_steps, 6)).astype(np.float32))
    t = proc.tensors("cpu")
    ref = ar_extrude_reference(t["A"], t["B"], buffer, t["ext_idx"], t["cross_idx"], noise)
    np.testing.assert_array_equal(ar_extrude([proc], [buffer], [noise])[0].numpy(), ref[:8].numpy())
    proc.extrusion_sample_index = proc.extrusion_sample_index + 1  # one row past the buffer's lookback
    with pytest.raises(ValueError, match="outside"):
        ar_plan([proc], "cpu", smem_limit=SMEM_LIMIT)


def test_ar_process_from_arrays_checks_its_geometry():
    cross, ext, nu, r0 = _geometry((30, 6, 1))
    ref = ref_process.AutoregressiveProcess(cross, ext, callback_kwargs={"nu": nu, "r0": r0})
    ref.run_setup()
    proc = ar_process_from_arrays(np.asarray(ref.A), np.asarray(ref.B),
                                                      ref.extrusion_sample_index, ref.cross_section_sample_index)
    assert (proc.n_extrusion, proc.n_cross_section, proc.n_sample) == (30, 6, ref.n_sample)
    np.testing.assert_array_equal(proc.A, np.asarray(ref.A, dtype=np.float64))
    with pytest.raises(ValueError):
        ar_process_from_arrays(np.asarray(ref.A), np.asarray(ref.B),
                                                   ref.extrusion_sample_index[::-1], ref.cross_section_sample_index)


def test_process_run_draws_on_the_generators_device():
    """run(generator=...) draws (buffer_init, noise) on the generator's
    device, in draw()'s order, and returns the extruded screen."""
    cross, ext, nu, r0 = _geometry((30, 6, 1))
    proc = AutoregressiveProcess(cross, ext, callback_kwargs={"nu": nu, "r0": r0})
    gen = torch.Generator().manual_seed(9)
    values = proc.run(generator=gen)
    gen.manual_seed(9)
    buffer_init, noise = proc.draw(gen, "cpu")
    assert values.device.type == "cpu" and values.shape == (30, 6)
    np.testing.assert_array_equal(values.numpy(), ar_extrude([proc], [buffer_init], [noise])[0].numpy())


# -- the screens and the path to pwv ------------------------------------------------------


def test_gaussian_blur_matches_jax():
    from maria_tpu.atmosphere.sampling import gaussian_blur_2d as ref_blur

    from maria_torch.atmosphere.sampling import gaussian_blur_2d

    x = np.random.default_rng(1).standard_normal((13, 198)).astype(np.float32)
    for sy, sx, ry, rx in ((42.46, 42.46, 27.96, 21.23), (3.0, 7.0, 1.0, 2.5)):
        ref = np.asarray(ref_blur(jnp.asarray(x), sy, sx, ry, rx))
        ours = gaussian_blur_2d(torch.as_tensor(x), sy, sx, ry, rx).numpy()
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * ref.std())


@pytest.mark.parametrize("model", ["2d", "3d"])
def test_initialize_geometry_matches_jax(scenes, model):
    ref = scenes[model]["ref_sim"].obs_list[0].atmosphere.screens
    ours = scenes[model]["sim"].obs_list[0].atmosphere.screens
    assert len(ours) == len(ref) == (8 if model == "2d" else 12)
    for s, r in zip(ours, ref):
        for k in ("h", "z", "res", "pwv_rms", "angle", "vx", "vy", "tx_min", "ty_min", "ty_res", "beam_sigma"):
            np.testing.assert_allclose(getattr(s, k), getattr(r, k), rtol=1e-10, err_msg=k)
        assert (s.nx, s.ny, s.ar_columns, s.W) == (r.nx, r.ny, r.ar_columns, None)
        np.testing.assert_allclose(s.process.cross_section, r.process.cross_section, rtol=1e-10, atol=1e-9)
        np.testing.assert_allclose(s.process.extrusion, r.process.extrusion, rtol=1e-10, atol=1e-9)
    assert len({id(s.process) for s in ours}) == (8 if model == "2d" else 1)


@pytest.mark.parametrize("model", ["2d", "3d"])
def test_pwv_matches_jax(scenes, model):
    """fields(upto="pwv") with injected (buffer_init, noise) draws against
    maria_tpu's accumulate_pwv fed the values its _ar_extrude_noise makes
    of the same draws: 2e-5 of the pwv std or 8 ulp of the mean pwv,
    whichever is larger (the extrusion's float32 rounding, then the blur's
    FFTs and the bilinear gathers in another order)."""
    from maria_tpu.atmosphere.sampling import accumulate_pwv as ref_accumulate

    from maria_torch.coords import offsets_to_phi_theta

    p, rp = scenes[model]["program"], scenes[model]["ref_program"]
    procs = p.ar_processes
    ref_procs = list({id(s.process): s.process for s in rp.screens}.values())
    assert len(procs) == len(ref_procs) == (8 if model == "2d" else 1)
    rng = np.random.default_rng(5)
    draws = [(rng.standard_normal((q.n_buffer, q.n_cross_section)).astype(np.float32),
              rng.standard_normal((q.n_steps, q.n_cross_section)).astype(np.float32)) for q in procs]
    ran = {id(q): np.asarray(ref_process._ar_extrude_noise(q.A, q.B, jnp.asarray(b), q._ext_idx, q._cross_idx,
                                                          jnp.asarray(e)))[: q.n_extrusion]
           for q, (b, e) in zip(ref_procs, draws)}
    ar_values = {i: jnp.asarray(ran[id(s.process)][:, s.ar_columns].T) for i, s in enumerate(rp.screens)}

    f32 = dict(dtype=torch.float32)
    pt = offsets_to_phi_theta(torch.as_tensor(p.offsets, **f32)[:, None, :], torch.as_tensor(p.bs_az_coarse, **f32),
                              torch.as_tensor(p.bs_el_coarse, **f32))
    el = torch.clamp(pt[..., 1], float(np.float32(np.radians(5.0))), float(np.float32(np.pi / 2)))
    px, py = (torch.sin(pt[..., 0]) / torch.tan(el)).numpy(), (torch.cos(pt[..., 0]) / torch.tan(el)).numpy()
    ref = np.asarray(ref_accumulate(jax.random.key(0), rp.mean_pwv, rp.screens, [], jnp.asarray(px),
                                    jnp.asarray(py), None, None, jnp.asarray(p.t_coarse, dtype=jnp.float32),
                                    ar_values=ar_values))
    ours = p.fields(draws={"ar": [tuple(map(torch.as_tensor, d)) for d in draws]}, device="cpu", upto="pwv")["pwv"]
    assert ours.shape == ref.shape == (p.n_det, len(p.t_coarse))
    atol = max(2e-5 * ref.std(), 8 * float(np.spacing(np.float32(rp.mean_pwv))))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=atol)


def test_generator_draw_order(scenes):
    """Without injected draws, each AR process takes (buffer_init, noise)
    from the generator in ar_processes order."""
    p = scenes["2d"]["program"]
    gen = torch.Generator().manual_seed(4)
    ours = p.fields(generator=gen, device="cpu", upto="pwv")["pwv"]
    gen.manual_seed(4)
    draws = [q.draw(gen, "cpu") for q in p.ar_processes]
    np.testing.assert_array_equal(ours.numpy(), p.fields(draws={"ar": draws}, device="cpu", upto="pwv")["pwv"].numpy())


def test_ar_scenes_run_on_cpu(scenes):
    """The 2-D AR Simulation.run() and the 3-D AR total_power_fn() give
    finite output of the expected shapes on CPU."""
    sim = scenes["2d"]["sim"]
    tod = sim.run()[0]
    assert tod.shape == (217, 500) and tod.units == "K_RJ"
    assert all(bool(torch.isfinite(v).all()) for v in tod.data.values())
    p = scenes["3d"]["program"]
    total = p.total_power_fn()(generator=scenes["3d"]["sim"].generator, device="cpu")
    assert total.shape == (p.n_det, p.n_t) == (171, 500) and bool(torch.isfinite(total).all())


@pytest.mark.parametrize("method", ["fft", "AR"])
def test_other_methods_raise_naming_their_item(caches, method):
    """The port has both of maria_tpu's methods; any other raises
    maria_tpu's ValueError with its message."""
    import maria_tpu.atmosphere

    with pytest.raises(ValueError) as ref:
        maria_tpu.atmosphere.Atmosphere(model="2d", method=method)
    with pytest.raises(ValueError, match=f"Invalid method '{method}'") as ours:
        maria_torch.atmosphere.Atmosphere(model="2d", method=method)
    assert str(ours.value) == str(ref.value)


# -- structure-function oracles (tests/test_atmosphere_fidelity.py) ------------------------


def _ar_structure_ratios(ny, nx, lags, n_real, seed0=0):
    cross = np.stack([RES * np.arange(ny), np.full(ny, 500.0)], axis=-1)
    proc = AutoregressiveProcess(cross, RES * np.arange(nx), callback_kwargs={"nu": NU, "r0": R0})
    gen = torch.Generator()
    fields = []
    for i in range(n_real):
        gen.manual_seed(seed0 + i)
        fields.append(proc.run(generator=gen).numpy())
    out = {}
    for lag in lags:
        d = np.mean([np.sqrt(((F[lag:, :] - F[:-lag, :]) ** 2).mean()) for F in fields])
        out[lag] = d / analytic_d_half(lag * RES, 0.0)
    dy = np.mean([np.sqrt(((F[:, 6:] - F[:, :-6]) ** 2).mean()) for F in fields])
    out["y6"] = dy / analytic_d_half(6 * RES, 0.0)
    return out


def test_ar_screen_structure_function_matches_analytic():
    """The port's extrusion recovers the analytic structure function on a
    footprint grid (the oracle at test_atmosphere_fidelity.py:202, on the
    port's generator): within 12%."""
    ratios = _ar_structure_ratios(ny=16, nx=128, lags=(6, 16), n_real=8)
    for key, r in ratios.items():
        assert abs(r - 1) < 0.12, (key, r)


@pytest.mark.parametrize("beam_sigma", [0.0, 42.5])
def test_fourier_screen_structure_function_matches_analytic(beam_sigma):
    """The port's Fourier screen on a 5 r0 box (test_atmosphere_fidelity.py:48),
    over 96 realizations where the JAX test takes 24: the in-box variance
    is 1 in expectation, but a realization's scatters by ~20% (the few
    modes near the box size carry most of it), so 24 draws of another
    generator land above the 1.05 bound about one time in ten."""
    from maria_torch.atmosphere.fourier import field_spectral_weights_2d, synthesize_matern_field_2d

    cells = 512
    W = torch.as_tensor(field_spectral_weights_2d(cells, cells, RES, RES, nu=NU, r0=R0, beam_sigma=beam_sigma))
    gen = torch.Generator().manual_seed(0)
    d, var = {6: [], 20: []}, []
    for _ in range(96):
        F = synthesize_matern_field_2d(W, cells, cells, generator=gen).numpy()
        var.append(F.var())
        for lag in d:
            d[lag].append(np.sqrt(((F[:, lag:] - F[:, :-lag]) ** 2).mean()))
    for lag, vals in d.items():
        ref = analytic_d_half(lag * RES, beam_sigma)
        assert abs(float(np.mean(vals)) / ref - 1) < 0.15, (lag, float(np.mean(vals)), ref)
    assert 0.45 < float(np.mean(var)) < 1.05


def test_layered_3d_statistics_match_analytic():
    """Each layer of the port's 3-D Fourier stack: unit variance and the
    2-D structure function (test_atmosphere_fidelity.py:155)."""
    from maria_torch.atmosphere.fourier import layered_field_spectral_weights, synthesize_layered_matern_2d

    heights = np.array([250.0, 750.0, 1250.0, 2500.0, 4000.0])
    cells, res = 256, 20.0
    W, Mc, Ms, _ = (torch.as_tensor(a) if a is not None else None
                    for a in layered_field_spectral_weights(cells, cells, res, res, heights, nu=NU, r0=R0))
    gen = torch.Generator().manual_seed(0)
    var, d = [], []
    for _ in range(10):
        F = synthesize_layered_matern_2d(W, Mc, Ms, None, cells, cells, generator=gen).numpy()
        var.append(F.var(axis=(1, 2)))
        d.append(np.sqrt(((F[:, :, 3:] - F[:, :, :-3]) ** 2).mean(axis=(1, 2))))
    var, d = np.mean(var, axis=0), np.mean(d, axis=0)
    assert np.all((var > 0.75) & (var < 1.3)), var
    ref = analytic_d_half(3 * res, 0.0)
    assert np.all(np.abs(d / ref - 1) < 0.2), (d, ref)


# -- Fourier against AR (tests/test_atmosphere3d.py:119-146) -------------------------------


@pytest.mark.parametrize("model", ["2d", "3d"])
def test_fourier_vs_ar_statistics(caches, model):
    """The Fourier and AR models target the same covariance: the TOD's
    atmospheric fluctuations agree within a factor of 2."""
    stds = {}
    for method in ("fourier", "ar"):
        tod = _simulation(maria_torch, model, method=method, seed=11, noise=False, device="cpu").run()[0]
        d = tod.data["atmosphere"].double().numpy()
        assert np.isfinite(d).all()
        stds[method] = (d - d.mean()).std()
    assert 0.5 < stds["fourier"] / stds["ar"] < 2.0, stds


@pytest.mark.parametrize("model", ["2d", "3d"])
def test_ar_method_uses_processes(scenes, model):
    atm = scenes[model]["sim"].obs_list[0].atmosphere
    assert atm.method == "ar" and not atm.groups
    assert atm.screens and all(s.process is not None and s.W is None for s in atm.screens)
    assert all(s.process._computed for s in atm.screens)
