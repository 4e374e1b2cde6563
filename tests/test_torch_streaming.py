"""The port's streaming slice against maria_tpu, on the CPU.

One module-scoped scene (MUSTANG-2, GBT, a 30 s daisy in az/el at 50 Hz,
2-D atmosphere, noise) is built by both packages with private caches,
and each package's ``StreamingExecutor`` runs on it. maria_tpu's draws
are carried into the port: its executor state (coarse fields, gains,
the cascades' stationary starts) by ``convert.stream_state_from_arrays``,
and each block's white, innovation and mode normals reproduced with
jax.random, so the streamed TODs compare like with like. The pink
cascade's kernel KC runs only on a card; here its plain version (the
Toeplitz form) runs, and a numpy emulation of KC's order of operations
is held against a float64 recurrence.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import maria_torch  # noqa: E402
import maria_tpu  # noqa: E402
from maria_tpu.io import caching as tpu_caching  # noqa: E402

SEED = 0
PLAN_KWARGS = dict(start_time=1.75e9, scan_center=(150.0, 41.0), frame="az/el", duration=30.0, sample_rate=50.0)
SCENE_KWARGS = dict(instrument="MUSTANG-2", site="GBT", atmosphere="2d", noise=True, seed=SEED)
BLOCK_TC = 16


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    old_tpu, old_torch = tpu_caching.get_cache_dir(), maria_torch.io._cache_state["base"]
    maria_tpu.set_cache_dir(str(tmp_path_factory.mktemp("maria_tpu_cache")))
    maria_torch.set_cache_dir(str(tmp_path_factory.mktemp("maria_torch_cache")))
    try:
        from maria_tpu.ops.program import build_tod_program as ref_build

        from maria_torch.ops.program import build_tod_program

        ref_sim = maria_tpu.Simulation(plans=maria_tpu.get_plan("daisy_5arcmin_60s", **PLAN_KWARGS), **SCENE_KWARGS)
        ref_obs = ref_sim.obs_list[0]
        sim = maria_torch.Simulation(plans=maria_torch.get_plan("daisy_5arcmin_60s", **PLAN_KWARGS), device="cpu",
                                     **SCENE_KWARGS)
        obs = sim.obs_list[0]
        yield {"ref_obs": ref_obs, "ref_program": ref_build(ref_obs, noise_kwargs=ref_sim.noise_kwargs),
               "obs": obs, "program": build_tod_program(obs, noise_kwargs=sim.noise_kwargs, device="cpu"),
               "sim": sim}
    finally:
        maria_tpu.set_cache_dir(old_tpu)
        maria_torch.set_cache_dir(old_torch)


def executors(scene, **kw):
    from maria_tpu.ops.streaming_exec import StreamingExecutor as RefExecutor

    from maria_torch.ops.streaming_exec import StreamingExecutor

    return (RefExecutor(scene["ref_program"], scene["ref_obs"], **kw),
            StreamingExecutor(scene["program"], scene["obs"], device="cpu", **kw))


def as_numpy(tree):
    if isinstance(tree, dict):
        return {k: as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(as_numpy(v) for v in tree)
    return np.asarray(tree)


def jax_block_draws(ref_ex, ref_state):
    """Each block's per-band (white, innovations, mode innovations), as
    maria_tpu's block_fn draws them (ops/streaming_exec.py:1077,
    noise/streaming.py:230-246)."""
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
                    k = model.basis.shape[-1]
                    wm = np.asarray(jax.random.normal(k_modes, (k, ref_ex.B), dtype=jnp.float32))
            per_band.append((white, w, wm))
        blocks.append(per_band)
    return blocks


@pytest.fixture(scope="module")
def carried(scene):
    """Both executors at block_tc 16, maria_tpu's state and block normals
    carried into the port, and maria_tpu's streamed TOD."""
    from maria_torch.convert import stream_state_from_arrays

    ref_ex, ex = executors(scene, block_tc=BLOCK_TC)
    key = jax.random.key(7)
    ref_state = ref_ex.init_state(key)
    leaves = {k: v for k, v in as_numpy({k: v for k, v in ref_state.items() if k != "noise_keys"}).items()}
    state = stream_state_from_arrays(ex, leaves)
    draws = {"blocks": jax_block_draws(ref_ex, ref_state)}
    ref_tod = np.concatenate([blk for _, blk in ref_ex.tod_blocks(key, group_size=4)], axis=-1)
    return {"ref_ex": ref_ex, "ex": ex, "state": state, "draws": draws, "ref_tod": ref_tod, "key": key}


# -- the cascade -------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("fs,knee,T_ref", [(50.0, 0.5, 4096.0), (100.0, 1.0, 36000.0), (20.0, 0.05, 4096.0)])
def test_fit_cascade_equals_maria_tpu(fs, knee, T_ref):
    from maria_tpu.noise.streaming import PinkCascade as RefCascade

    from maria_torch.noise.streaming import PinkCascade

    ref, ours = RefCascade(fs, knee, T_ref=T_ref), PinkCascade(fs, knee, T_ref=T_ref)
    np.testing.assert_array_equal(ours.p, np.asarray(ref.p))
    np.testing.assert_array_equal(ours.a, np.asarray(ref.a))
    np.testing.assert_array_equal(ours.chol0, np.asarray(ref._chol0))
    # maria_tpu's fit-quality bounds (tests/test_streaming_exec.py::test_cascade_fit_quality)
    p, a = ours.p.astype(np.float64), ours.a.astype(np.float64)
    f = np.geomspace(1.0 / T_ref, fs / 2 * 0.999, 600)
    H = 1.0 / (1 - p[None, :] * np.exp(-1j * 2 * np.pi * f[:, None] / fs))
    logratio = np.abs(np.log(np.abs(H @ a) ** 2 / (fs * knee / f)))
    assert logratio.max() < 0.15 and logratio[f < 0.7 * fs / 2].max() < 0.07


@pytest.mark.parametrize("rows,n", [(13, 257), (5, 2 * 1024 + 100), (3, 64)])
def test_cascade_block_equals_maria_tpu(rows, n):
    """The plain block on maria_tpu's innovations, three blocks with the
    state carried (across the Toeplitz sub-chunk boundary), within 1e-4
    of the pink std."""
    from maria_tpu.noise.streaming import PinkCascade as RefCascade

    from maria_torch.noise.streaming import PinkCascade

    ref, ours = RefCascade(50.0, 0.5, T_ref=4096.0), PinkCascade(50.0, 0.5, T_ref=4096.0)
    key = jax.random.key(0)
    s_ref = ref.init_state(jax.random.key(1), (rows,))
    z = np.asarray(jax.random.normal(jax.random.key(1), (rows, ours.K), dtype=jnp.float32))
    s = ours.init_state(rows, z=z, device="cpu")
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-5, atol=1e-5 * float(np.abs(s_ref).max()))
    for b in range(3):
        kb = jax.random.fold_in(key, b)
        s_ref, y_ref = ref.block(s_ref, kb, n)
        w = torch.as_tensor(np.array(jax.random.normal(kb, (rows, n), dtype=jnp.float32)))
        s, y = ours.block(s, n, w=w)
        y_ref = np.asarray(y_ref)
        assert float(np.abs(y.numpy() - y_ref).max()) <= 1e-4 * float(y_ref.std())


def fmaf(x, y, z):
    """An fmaf emulated as the float64 product-sum rounded once to float32
    (the product of two float32 is exact in float64)."""
    return (np.asarray(x, np.float64) * np.asarray(y, np.float64) + np.asarray(z, np.float64)).astype(np.float32)


def cascade_emulation(w, state, p, a):
    """KC's arithmetic in numpy where G = 1 (csrc/pink_cascade.cu): each
    state update one fmaf, then the pink sum by fmaf over k from 0."""
    x = state.astype(np.float32).copy()
    out = np.empty(w.shape, np.float32)
    for t in range(w.shape[1]):
        x = fmaf(p, x, w[:, t:t + 1])
        y = np.zeros(w.shape[0], np.float32)
        for k in range(len(p)):
            y = fmaf(a[k], x[:, k], y)
        out[:, t] = y
    return out, x


def cascade_split_emulation(w, state, p, a, G, S, tables=None):
    """KC's arithmetic in numpy where a row's time is split
    (csrc/pink_cascade.cu, G > 1): chunks of G x S samples, each cut into G
    segments of S. Pass A walks every segment from zero (the G = 1 step);
    the scan composes the segments' end states in groups of 32 lanes
    (Kogge-Stone, b_j <- E[d-1] b_{j-d} + b_j for d = 1, 2, 4, ...), the
    groups' totals in order (C <- E[31] C + T), each segment's end
    E[j] C + b_j and start the previous end; pass B adds D[k, m] s_k over k
    from 0 to the local pink; the last segment's end Z[len-1] s + e carries.
    ``tables`` (D, Z, E) default to ``split_tables_np``'s float64-built ones."""
    from maria_torch.ops.pink_cascade import POWERS, split_tables_np

    if G == 1:
        return cascade_emulation(w, state, p, a)
    if tables is None:
        t = split_tables_np(p, a, S)[0]
        Sp = (t.shape[-1] - POWERS) // 2
        tables = t[:, :S], t[:, Sp:Sp + S], t[:, 2 * Sp:]
    D, Z, E = tables
    rows, n = w.shape
    K = len(p)
    out = np.empty(w.shape, np.float32)
    x = state.astype(np.float32).copy()
    for c0 in range(0, n, G * S):
        clen = min(G * S, n - c0)
        lens = np.clip(clen - np.arange(G) * S, 0, S)
        seg = np.zeros((rows, G * S), np.float32)
        seg[:, :clen] = w[:, c0:c0 + clen]
        seg = seg.reshape(rows, G, S)
        e = np.zeros((rows, G, K), np.float32)
        for m in range(S):  # pass A
            live = (m < lens)[None, :, None]
            e = np.where(live, fmaf(p, e, seg[:, :, m:m + 1]), e)
            y = np.zeros((rows, G), np.float32)
            for k in range(K):
                y = fmaf(a[k], e[:, :, k], y)
            seg[:, :, m] = y
        start = np.empty_like(e)
        C = x.copy()
        for w0 in range(0, G, 32):  # the scan, a warp of lanes at a time
            b = e[:, w0:w0 + 32].copy()
            width = b.shape[1]
            d = 1
            while d < width:
                b[:, d:] = fmaf(E[:, d - 1], b[:, :-d], b[:, d:])
                d *= 2
            end = fmaf(E[:, :width].T, C[:, None, :], b)
            start[:, w0], start[:, w0 + 1:w0 + width] = C, end[:, :-1]
            if w0 + 32 < G:
                C = fmaf(E[:, 31], C, b[:, 31])
        for m in range(S):  # pass B
            y = seg[:, :, m]
            for k in range(K):
                y = fmaf(D[k, m], start[:, :, k], y)
            seg[:, :, m] = y
        out[:, c0:c0 + clen] = seg.reshape(rows, G * S)[:, :clen]
        last = -(-clen // S) - 1
        x = fmaf(Z[:, lens[last] - 1], start[:, last], e[:, last])
    return out, x


def float32_power_tables(p, a, S):
    """(D, Z, E) as a kernel computing the powers in float32 by repeated
    multiplication would hold them."""
    Z = np.empty((len(p), S), np.float32)
    z = np.ones(len(p), np.float32)
    for m in range(S):
        z = z * p
        Z[:, m] = z
    E = np.empty((len(p), 32), np.float32)
    z = np.ones(len(p), np.float32)
    for j in range(32):
        z = z * Z[:, -1]
        E[:, j] = z
    return a[:, None] * Z, Z, E


def split_emulation_error(G, S, rows, n, blocks, tables=None):
    """The largest error of ``cascade_split_emulation`` against a float64
    recurrence over ``blocks`` blocks with the state carried, over the pink
    std, on a real cascade (the poles within 1.5e-6 of 1, states ~600)."""
    from maria_torch.noise.streaming import PinkCascade

    c = PinkCascade(50.0, 0.5, T_ref=4096.0)
    tables = None if tables is None else tables(c.p, c.a, S)
    rng = np.random.default_rng(0)
    s_emu = c.init_state(rows, z=rng.standard_normal((rows, c.K)).astype(np.float32), device="cpu").numpy()
    s64 = s_emu.astype(np.float64)
    p64, a64 = c.p.astype(np.float64), c.a.astype(np.float64)
    worst, stds = 0.0, []
    for _ in range(blocks):
        w = rng.standard_normal((rows, n)).astype(np.float32)
        y_emu, s_emu = cascade_split_emulation(w, s_emu, c.p, c.a, G, S, tables)
        y64 = np.empty((rows, n))
        for t in range(n):
            s64 = p64 * s64 + w[:, t:t + 1]
            y64[:, t] = s64 @ a64
        worst = max(worst, float(np.abs(y_emu - y64).max()))
        stds.append(float(y64.std()))
    return worst / np.mean(stds)


@pytest.mark.parametrize("G,S", [(1, None), (7, 41), (32, 21), (49, 13)])
def test_kernel_emulation_against_float64(G, S):
    """KC's order of operations, over 12 blocks of 640 with the state
    carried, against a float64 recurrence: under 1e-4 of the pink std. G = 1
    is the walk a thread a row; G = 7 runs 2.2 chunks of 287 a block, G = 32
    one chunk of 31 segments, G = 49 two warps of lanes (n a multiple of no S)."""
    assert split_emulation_error(G, S, 16, 640, 12) < 1e-4


def test_split_tables_need_float64():
    """Why the split's powers are built in float64: with the same order and
    inputs, p^S and its powers by repeated float32 multiplication drift past
    1e-4 of the pink std over chip_smoke's 47 blocks of (u)'s 3,136 samples
    (G 32, S 99: 1.5e-4), where the float64-built tables stay a hundred times
    under it (1.1e-6)."""
    assert split_emulation_error(32, 99, 16, 3136, 47) < 1e-5
    assert split_emulation_error(32, 99, 16, 3136, 47, tables=float32_power_tables) > 1e-4


@pytest.mark.parametrize("rows,n", [(222, 3136), (222, 320), (50049, 640), (5, 40000), (12671, 1000),
                                    (12672, 1000), (37, 95), (1, 1)])
def test_cascade_plan(rows, n):
    """The split the wrapper picks from the shape: G = 1 from SPLIT_BELOW
    rows or where a warp a row would leave a lane under MIN_SEGMENT samples,
    else a power of two from 32 to 256 whose segments (S odd, at least
    MIN_SEGMENT) cover n in chunks a ring stage holds."""
    from maria_torch.ops.pink_cascade import (FILL_LANES, MAX_LANES, MAX_SEGMENT, MIN_LANES, MIN_SEGMENT, ROW_TILE,
                                              SPLIT_BELOW, STAGE_FLOATS, cascade_plan, split_tables_np)

    G, S = cascade_plan(rows, n)
    if G == 1:
        assert S == ROW_TILE and (rows >= SPLIT_BELOW or n < MIN_LANES * MIN_SEGMENT)
        return
    assert MIN_LANES <= G <= MAX_LANES and G & (G - 1) == 0 and S % 2 == 1
    assert S * G <= STAGE_FLOATS and MIN_SEGMENT <= S <= MAX_SEGMENT
    assert G == MAX_LANES or rows * G >= FILL_LANES or n < 4 * G * MIN_SEGMENT
    t = split_tables_np(np.float32([[0.999, 0.99]]), np.float32([[1.0, -2.0]]), S)
    Sp = -(-S // 4) * 4
    assert t.shape == (1, 2, 2 * Sp + 32) and t.dtype == np.float32
    np.testing.assert_allclose(t[0, 1, Sp + S - 1], np.float32(0.99) ** S, rtol=1e-6)
    np.testing.assert_array_equal(t[0, :, S:Sp], 0.0)
    np.testing.assert_allclose(t[0, 0, 2 * Sp:], np.float64(np.float32(0.999)) ** (S * np.arange(1, 33.0)), rtol=1e-6)
    expect = {(222, 3136): (128, 25), (222, 320): (64, 5), (5, 40000): (256, 35), (12671, 1000): (32, 33),
              (12672, 1000): (1, 32), (50049, 640): (1, 32), (37, 95): (1, 32)}
    assert (G, S) == expect.get((rows, n), (G, S))


def test_cascade_psd_matches_fft_generator():
    """The streamed band noise carries the batch generator's spectrum,
    octave by octave, down to ~1/T (tests/test_streaming_exec.py:43-71's bands)."""
    from maria_torch.noise import generate_noise_with_knee
    from maria_torch.noise.streaming import StreamingBandNoise

    fs, knee, n, n_det = 50.0, 0.5, 2**14, 96
    model = StreamingBandNoise(fs, knee, T_ref=4096.0)
    g = torch.Generator()
    g.manual_seed(1)
    state = model.init_state(n_det, g, device="cpu")
    blocks = []
    for _ in range(8):
        state, blk = model.block(state, n_det, n // 8, generator=g)
        blocks.append(blk.numpy())
    x_stream = np.concatenate(blocks, axis=-1)
    x_fft = generate_noise_with_knee((n_det, n), sample_rate=fs, knee=knee, generator=g, device="cpu").numpy()

    def psd(x):
        return (np.abs(np.fft.rfft(x, axis=-1)) ** 2).mean(0) * 2 / (fs * x.shape[-1])

    f = np.fft.rfftfreq(n, 1 / fs)
    p_s, p_f = psd(x_stream), psd(x_fft)
    edges = np.geomspace(4 / (n / fs), fs / 3, 10)
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = (f >= lo) & (f < hi)
        ratio = p_s[m].mean() / p_f[m].mean()
        tol = (0.80, 1.25) if m.sum() < 30 else (0.93, 1.08)
        assert tol[0] < ratio < tol[1], (lo, hi, ratio, int(m.sum()))


# -- the blockwise upsample --------------------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["cubic", "linear"])
def test_blockwise_upsample(kind):
    """Bit-equal to the port's upsample_time_phases, within 1e-6 of
    maria_tpu's upsample_block_phases; the haloed form's interior equal."""
    from maria_tpu.ops.streaming_exec import pad_coarse_for_blocks as ref_pad
    from maria_tpu.ops.streaming_exec import upsample_block_phases as ref_block

    from maria_torch.ops.interp import upsample_time_phases
    from maria_torch.ops.streaming_exec import (pad_coarse_for_blocks, pad_coarse_for_blocks_ext,
                                                upsample_block_ext, upsample_block_phases)

    rng = np.random.default_rng(0)
    n_det, n_c, r, block_tc = 7, 53, 16, 8
    v_np = rng.standard_normal((n_det, n_c)).astype(np.float32)
    v = torch.as_tensor(v_np)
    for n_fine in (n_c * r, (n_c - 1) * r + 3, n_c * r - 5):
        full = upsample_time_phases(v, r, n_fine, kind=kind)
        n_blocks = -(-n_fine // (block_tc * r))
        pad, pad2 = pad_coarse_for_blocks(v, block_tc, n_blocks), pad_coarse_for_blocks_ext(v, block_tc, n_blocks)
        blocks = [upsample_block_phases(pad, b * block_tc, block_tc, r, n_c, v[:, -1], kind) for b in range(n_blocks)]
        torch.testing.assert_close(torch.cat(blocks, dim=-1)[:, :n_fine], full, rtol=0, atol=0)
        for b in range(n_blocks):
            ext = upsample_block_ext(pad2, b * block_tc, block_tc, r, n_c, v[:, -1], kind)
            torch.testing.assert_close(ext[:, r:-r], blocks[b], rtol=0, atol=0)
        rpad = ref_pad(jnp.asarray(v_np), block_tc, n_blocks)
        ref = np.concatenate([np.asarray(ref_block(rpad, b * block_tc, block_tc, r, n_c, jnp.asarray(v_np[:, -1]),
                                                   kind)) for b in range(n_blocks)], axis=-1)[:, :n_fine]
        np.testing.assert_allclose(torch.cat(blocks, dim=-1)[:, :n_fine].numpy(), ref, rtol=0, atol=1e-6)


# -- the executor ------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(block_tc=BLOCK_TC), dict(block_tc=8, n_x=64, n_y=64), dict(),
                                dict(block_tc=32, frame="ra/dec")])
def test_executor_geometry_equals_maria_tpu(scene, kw):
    ref_ex, ex = executors(scene, **kw)
    assert (ex.block_tc, ex.B, ex.n_blocks, ex.n_t, ex.n_c) == (ref_ex.block_tc, ref_ex.B, ref_ex.n_blocks,
                                                                ref_ex.n_t, ref_ex.n_c)
    np.testing.assert_allclose(ex.center, ref_ex.center, rtol=1e-6)
    np.testing.assert_allclose(ex.res, ref_ex.res, rtol=1e-5)
    assert [m.cascade.K for m in ex.noise_models] == [m.cascade.K for m in ref_ex.noise_models]


@pytest.mark.parametrize("frame", ["az/el", "ra/dec"])
@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded"])
def test_streamed_pixel_ids_equal_the_plain_chain(scene, frame, padded):
    """Each block's ids are ``pixel_ids_plain`` on the block's tracks (q's
    rotation in ra/dec), -1 on the samples past n_t of the last block and
    on the rows ``pad_detectors`` adds."""
    import copy

    from maria_torch.ops.pixel_ids import pixel_ids_plain
    from maria_torch.ops.streaming_exec import StreamingExecutor

    p = copy.deepcopy(scene["program"])
    if padded:
        assert p.pad_detectors(4) == 3 and p.n_real_det == 217
    ex = StreamingExecutor(p, scene["obs"], block_tc=BLOCK_TC, frame=frame, device="cpu")
    assert ex.n_blocks >= 2 and ex.n_blocks * ex.B > ex.n_t
    tr = ex._device_tracks()
    tracks = ("ra", "dec", "cq", "sq") if frame == "ra/dec" else ("az", "el")
    offsets = torch.as_tensor(p.offsets, dtype=torch.float32)
    real = torch.arange(p.n_det) < 217
    for b in range(ex.n_blocks):
        sl = slice(b * ex.B, (b + 1) * ex.B)
        phi, theta, *cq_sq = (tr[k][sl] for k in tracks)
        ref = pixel_ids_plain(offsets, phi, theta, ex.center, ex.res, ex.n_x, ex.n_y, *cq_sq)
        live = b * ex.B + torch.arange(ex.B) < ex.n_t
        ids = ex.pixel_ids(b)
        assert ids.dtype == torch.int32 and ids.shape == (p.n_det, ex.B)
        assert torch.equal(ids, torch.where(live & real[:, None], ref, -1))
        assert bool((ids[~real] == -1).all()) and bool((ids[:, ~live] == -1).all())
    assert bool((ids[real][:, live] >= 0).any())


def test_noise_off_equals_batch_total(scene):
    """With noise off the streamed TOD is the batch program's atmosphere
    times the gains, on the same draws, bit for bit."""
    import copy

    from maria_torch.ops.streaming_exec import StreamingExecutor, _generator

    p = copy.copy(scene["program"])
    p.with_noise = False
    ex = StreamingExecutor(p, scene["obs"], block_tc=BLOCK_TC, device="cpu")
    fields = p.fields(generator=_generator("cpu", 3, 0), device="cpu", upto="atmosphere")
    batch = fields["atmosphere"] * p.draw_gains(generator=_generator("cpu", 3, 1), device="cpu")
    stream = torch.cat([blk for _, blk in ex.tod_blocks(3)], dim=-1)
    torch.testing.assert_close(stream, batch, rtol=0, atol=0)


def test_streamed_tod_equals_maria_tpu(carried):
    """On maria_tpu's state and normals the streamed TOD equals maria_tpu's
    tod_blocks within 1e-5 of the TOD's std."""
    ex = carried["ex"]
    tod = torch.cat([blk for _, blk in ex.tod_blocks(state=carried["state"], draws=carried["draws"])], dim=-1)
    ref = carried["ref_tod"]
    assert tod.shape == ref.shape
    assert float(np.abs(tod.numpy() - ref).max()) <= 1e-5 * float(ref.std())


def test_map_hits_and_grouping(carried):
    """Every sample lands on the hull-sized map, and the grouping changes
    nothing; the map equals maria_tpu's scatter-binned map on its draws."""
    ex = carried["ex"]
    a = ex.run(group_size=1, state=carried["state"], draws=carried["draws"])
    b = ex.run(group_size=ex.n_blocks, state=carried["state"], draws=carried["draws"])
    assert float(a.map_wgt.astype(np.float64).sum()) == ex.n_det * ex.n_t
    np.testing.assert_array_equal(a.map_wgt, b.map_wgt)
    np.testing.assert_array_equal(a.map_sum, b.map_sum)
    # maria_tpu's pointing differs from the port's by float32 ulps, so a
    # few samples on a pixel's edge land in its neighbour
    ref = carried["ref_ex"].run(carried["key"], group_size=4, mxu_binning=False)
    assert np.abs(a.map_wgt - ref.map_wgt).sum() <= 1e-2 * ref.map_wgt.sum()
    np.testing.assert_allclose(a.map_sum.sum(dtype=np.float64), ref.map_sum.sum(dtype=np.float64), rtol=1e-5)


def test_checkpoint_resume(scene, tmp_path):
    """A run broken off after two checkpoints and resumed equals the
    uninterrupted run; a wrong seed or geometry refuses to resume."""
    from maria_torch.ops.streaming_exec import StreamingExecutor

    ex = StreamingExecutor(scene["program"], scene["obs"], block_tc=8, device="cpu")
    assert ex.n_blocks >= 4
    ckpt = str(tmp_path / "stream.ckpt.npz")
    full = ex.run(11, group_size=1, accumulate_psd=True)
    state = ex.init_state(11)
    for b, state, _ in ex._blocks(state, with_psd=True):
        ex._save_ckpt(ckpt, state, b + 1, 11)
        if b + 1 == 2:
            break
    resumed = ex.run(11, group_size=1, accumulate_psd=True, checkpoint_path=ckpt)
    np.testing.assert_array_equal(resumed.map_sum, full.map_sum)
    np.testing.assert_array_equal(resumed.map_wgt, full.map_wgt)
    for x, y in zip(resumed.psds, full.psds):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="different seed"):
        ex.run(12, group_size=2, accumulate_psd=True, checkpoint_path=ckpt)
    ex2 = StreamingExecutor(scene["program"], scene["obs"], block_tc=8, n_x=64, n_y=64, device="cpu")
    with pytest.raises(ValueError, match="different run"):
        ex2.run(11, group_size=2, accumulate_psd=True, checkpoint_path=ckpt)


def test_checkpoint_leaves_carry_maria_tpu_state(carried, tmp_path):
    """maria_tpu's checkpoint leaves laid over the port's state give
    maria_tpu's mutable state back, leaf for leaf."""
    from maria_torch.convert import stream_state_from_arrays

    ref_ex, ex = carried["ref_ex"], carried["ex"]
    ref_state = ref_ex.init_state(carried["key"])
    path = str(tmp_path / "ref.npz")
    ref_ex._save_ckpt(path, ref_state, 3, carried["key"])
    with np.load(path) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(ex.mutable_leaves(carried["state"])))]
        assert f"leaf_{len(leaves)}" not in z
    state = stream_state_from_arrays(ex, leaves, base=ex.init_state(0))
    for ours, theirs in zip(ex.mutable_leaves(state), leaves):
        np.testing.assert_array_equal(ours.numpy(), theirs)


def test_welch_psd_equals_whole_tod(scene):
    import scipy.signal

    from maria_torch.ops.streaming_exec import StreamingExecutor

    ex = StreamingExecutor(scene["program"], scene["obs"], block_tc=BLOCK_TC, device="cpu")
    res = ex.run(11, group_size=4, accumulate_psd=True)
    tod = torch.cat([blk for _, blk in ex.tod_blocks(11)], dim=-1).numpy()
    band = scene["program"].bands[0]
    f_ref, p_ref = scipy.signal.welch(tod[band.det_index], fs=scene["program"].sample_rate, nperseg=ex.B,
                                      window="hann", detrend="constant", noverlap=0)
    np.testing.assert_allclose(res.psd_freqs, f_ref, atol=1e-9)
    np.testing.assert_allclose(res.psds[0], p_ref.mean(axis=0), rtol=2e-4)


def test_mesh_and_time_sharding_name_item_11(scene, tmp_path):
    """ROADMAP item 11's two paths run: run(mesh=) on a one-rank gloo world
    equals the run without a mesh (the map bit for bit, the Welch PSD
    within 1e-6), and extrude_time_sharded over a one-rank time axis equals
    StreamingExtrusion's chunk bit for bit (tests/test_torch_parallel.py
    runs both over four ranks)."""
    import torch.distributed as dist

    from maria_torch.atmosphere.streaming import StreamingExtrusion, extrude_time_sharded
    from maria_torch.ops.streaming_exec import StreamingExecutor
    from maria_torch.parallel import create_mesh

    ex = StreamingExecutor(scene["program"], scene["obs"], block_tc=BLOCK_TC, device="cpu")
    proc = scene["program"].ar_processes[0] if scene["program"].ar_processes else None
    if proc is None:
        from maria_torch.atmosphere.process import AutoregressiveProcess

        proc = AutoregressiveProcess(np.stack([10.0 * np.arange(12), np.full(12, 500.0)], axis=-1),
                                     10.0 * np.arange(24), callback_kwargs={"nu": 5 / 6, "r0": 300.0})
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", rank=0, world_size=1)
    try:
        sharded = ex.run(0, group_size=4, mesh=create_mesh(axis_names=("det",), device="cpu"), accumulate_psd=True)
        chunks = extrude_time_sharded(proc, 3, 16, create_mesh(axis_names=("time",), device="cpu"))
    finally:
        dist.destroy_process_group()
    single = ex.run(0, group_size=4, accumulate_psd=True)
    np.testing.assert_array_equal(sharded.map_wgt, single.map_wgt)
    np.testing.assert_array_equal(sharded.map_sum, single.map_sum)
    np.testing.assert_allclose(np.stack(sharded.psds), np.stack(single.psds), rtol=1e-6)
    g = torch.Generator()
    g.manual_seed(3)
    torch.testing.assert_close(chunks, StreamingExtrusion(proc, 16, device="cpu").run_chunks(1, g)[0], rtol=0, atol=0)


# -- the sky stages a block at a time ----------------------------------------------------------------------------


def blob_map(frames=1, frame="az/el", center=(150.0, 41.0), width=0.4):
    from maria_torch.map import ProjectionMap

    n = 48
    yy, xx = np.mgrid[:n, :n]
    blob = np.exp(-((xx - n / 2) ** 2 + (yy - n / 2) ** 2) / (2 * (n / 8) ** 2)) + np.linspace(0, 0.3, n)[None]
    data = np.stack([(1 + f) * 2e-3 * blob for f in range(frames)]).astype(np.float32)[None, None]
    t = None if frames == 1 else [1.75e9 + 10.0 * f for f in range(frames)]
    return ProjectionMap(data=data, center=center, width=width, frame=frame, t=t, units="K_RJ", degrees=True)


def batch_and_stream(scene, key=5, **sky):
    """(batch, stream, sky): the port's batch signal (the program built
    with the sky) times the gains, the streamed TOD (the sky given to the
    executor), noise off, on the same draws, and the batch's gained sky
    field alone."""
    from maria_torch.ops.program import build_tod_program
    from maria_torch.ops.streaming_exec import StreamingExecutor, _generator

    obs = scene["obs"]
    mk = sky.pop("map_kwargs", {})
    batch_prog = build_tod_program(obs, with_noise=False, map_kwargs=mk, device="cpu", **sky)
    fields = batch_prog.fields(generator=_generator("cpu", key, 0), device="cpu", upto="signal")
    gains = batch_prog.draw_gains(generator=_generator("cpu", key, 1), device="cpu")
    batch = sum(fields.values()) * gains
    ex = StreamingExecutor(build_tod_program(obs, with_noise=False, device="cpu"), obs, block_tc=BLOCK_TC,
                           device="cpu", map_kwargs=mk, **sky)
    stream = torch.cat([blk for _, blk in ex.tod_blocks(key)], dim=-1)
    return batch, stream, sum(v for k, v in fields.items() if k != "atmosphere") * gains


def close_to_batch(batch, stream, sky, rel):
    """|stream - batch| within ``rel`` of the sky term's largest value,
    plus a float32 rounding of the total."""
    assert stream.shape == batch.shape
    err = float((stream - batch).abs().max())
    limit = rel * float(sky.abs().max()) + 4 * float(torch.finfo(torch.float32).eps) * float(batch.abs().max())
    assert err <= limit, (err, limit)


@pytest.mark.parametrize("bilinear,frames", [(True, 1), (False, 1), (True, 3)])
def test_streamed_map_stage_equals_batch(scene, bilinear, frames):
    """Bilinear, nearest and a time-evolving map (three frames 10 s apart)
    sampled a block at a time equal the batch map stage."""
    close_to_batch(*batch_and_stream(scene, input_map=blob_map(frames), map_kwargs={"bilinear_sampling": bilinear}),
                   rel=1e-5)


def test_streamed_cmb_stage_equals_batch(scene):
    """A CMB (nside 64) sampled a block at a time equals the batch CMB stage."""
    from maria_torch.cmb import generate_cmb

    close_to_batch(*batch_and_stream(scene, cmb=generate_cmb(nside=64, lmax=128, seed=0, device="cpu")), rel=1e-5)


def test_streamed_radec_binning(scene):
    """frame="ra/dec": the streamed map equals K2's plain binning of the
    streamed TOD at BinMapper's ra/dec pixel ids on the same grid."""
    from maria_torch.mappers.bin_mapper import radec_pixel_ids
    from maria_torch.ops.streaming_exec import StreamingExecutor
    from maria_torch.tod import Pointing

    obs = scene["obs"]
    ex = StreamingExecutor(scene["program"], obs, block_tc=32, frame="ra/dec", device="cpu")
    res = ex.run(9)
    tod = torch.cat([blk for _, blk in ex.tod_blocks(9)], dim=-1)
    ids = radec_pixel_ids(Pointing(obs.boresight, obs.offsets, obs.q), ex.center, ex.res, ex.n_x, ex.n_y,
                          device="cpu").reshape(-1).long()
    keep = ids >= 0
    hits = np.bincount(ids[keep].numpy(), minlength=ex.n_x * ex.n_y).reshape(ex.n_y, ex.n_x)
    sums = np.bincount(ids[keep].numpy(), weights=tod.reshape(-1)[keep].double().numpy(),
                       minlength=ex.n_x * ex.n_y).reshape(ex.n_y, ex.n_x)
    np.testing.assert_array_equal(res.map_wgt, hits)
    np.testing.assert_allclose(res.map_sum, sums, atol=1e-5 * np.abs(sums).max())


# -- the chunked AR extrusion ------------------------------------------------------------------------------------


def test_streaming_extrusion_chunks():
    """Chunks concatenate into one long extrusion on the same innovations,
    bit for bit, and equal maria_tpu's chunks on the same normals."""
    from maria_tpu.atmosphere.process import AutoregressiveProcess as RefProcess
    from maria_tpu.atmosphere.streaming import StreamingExtrusion as RefStream

    from maria_torch.atmosphere.streaming import StreamingExtrusion
    from maria_torch.convert import ar_process_from_arrays
    from maria_torch.ops.ar_extrude import ar_extrude

    ny, R, n_chunks = 12, 16, 3
    ref_proc = RefProcess(cross_section=np.stack([10.0 * np.arange(ny), np.full(ny, 500.0)], axis=-1),
                          extrusion=10.0 * np.arange(24), callback_kwargs={"nu": 5 / 6, "r0": 300.0})
    ref_proc.run_setup()
    proc = ar_process_from_arrays(np.asarray(ref_proc.A), np.asarray(ref_proc.B), ref_proc.extrusion_sample_index,
                                  ref_proc.cross_section_sample_index)
    ref_stream, stream = RefStream(ref_proc, chunk_rows=R), StreamingExtrusion(proc, chunk_rows=R, device="cpu")
    key_white, key_burn = jax.random.split(jax.random.key(0))
    n_burn = 2 * proc.n_extrusion
    buffer = np.asarray(jax.random.normal(key_white, (n_burn + proc.n_extrusion, ny), dtype=jnp.float32))
    noise0 = np.asarray(jax.random.normal(key_burn, (n_burn, ny), dtype=jnp.float32))
    state0 = stream.initial_state(buffer=buffer, noise=noise0)
    ref_state0 = ref_stream.initial_state(jax.random.key(0))
    np.testing.assert_allclose(state0.numpy(), np.asarray(ref_state0), atol=1e-5)
    noises = [np.random.default_rng(c).standard_normal((R, ny)).astype(np.float32) for c in range(n_chunks)]
    chunks, s, ref_s = [], state0, jnp.asarray(state0.numpy())
    for c in range(n_chunks):
        s, chunk = stream.step(s, torch.as_tensor(noises[c]))
        ref_s, ref_chunk = ref_stream.step(ref_s, jnp.asarray(noises[c]))
        np.testing.assert_allclose(chunk.numpy(), np.asarray(ref_chunk), atol=1e-5 * float(np.std(ref_chunk)))
        chunks.append(chunk)
    long = torch.cat([torch.zeros((n_chunks * R, ny)), state0])
    (one,) = ar_extrude([proc], [long], [torch.as_tensor(np.concatenate(noises))], steps=[n_chunks * R],
                        rows=n_chunks * R)
    torch.testing.assert_close(torch.cat(chunks), one.flip(0), rtol=0, atol=0)
    g = torch.Generator()
    g.manual_seed(3)
    assert [tuple(c.shape) for c in stream.run_chunks(2, g)] == [(R, ny)] * 2
