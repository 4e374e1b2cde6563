"""The hand-written CUDA kernels against their plain torch versions, on
a card (marker ``cuda``; they skip without one). This file imports no
jax, so it runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``-k pink`` for K1 alone, ``-k ar_`` for the AR extrusion kernel,
``-k "cascade or streamed"`` for KC and the streaming slice.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from maria_torch.atmosphere.process import AutoregressiveProcess  # noqa: E402
from maria_torch.noise import band_half_spectrum  # noqa: E402
from maria_torch.ops.ar_extrude import ar_extrude, ar_extrude_reference, ar_plan, ar_smem_bytes  # noqa: E402
from maria_torch.ops.bin_map import bin_map, bin_map_plain  # noqa: E402
from maria_torch.ops.pink_noise import pink_noise, pink_noise_plain  # noqa: E402
from maria_torch.ops.shared_v import draw_key, shared_v, shared_v_plain  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def private_cache(tmp_path_factory):
    import maria_torch

    old = maria_torch.io._cache_state["base"]
    maria_torch.set_cache_dir(str(tmp_path_factory.mktemp("maria_torch_cache")))
    yield
    maria_torch.set_cache_dir(old)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n_det,n,n_fft",
    [(217, 3000, 3072), (217, 30000, 32768), (5, 500, 512), (217, 60000, 65536), (217, 180000, 196608),
     (3, 1100, 1152), (3, 2400, 2560), (3, 4700, 5120), (3, 9000, 9216), (217, 18000, 18432),
     (3, 20000, 20480), (3, 36000, 36864)],
)
def test_pink_noise_kernel_matches_plain(cuda_device, n_det, n, n_fft):
    c = band_half_spectrum(50.0, 5.0, 1.0, n_fft, corr_prop=0.5)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    S = torch.randn((n_det, n_fft // 2 + 1, 2), generator=gen, device=cuda_device)
    before = pink_noise.launches
    x = pink_noise(c, S, n, n_fft)
    ref = pink_noise_plain(c, S, n, n_fft)
    torch.cuda.synchronize()
    assert pink_noise.launches == before + 1
    assert float((x - ref).abs().max()) <= 2e-4 * float(ref.std())


@pytest.mark.cuda
@pytest.mark.parametrize("count", [False, True])
@pytest.mark.parametrize(
    "form,n_channels,n_det,n_t,n_pix",
    [("private", 1, 217, 3000, 128 * 128), ("private", 2, 217, 3001, 128 * 128), ("split", 6, 64, 2003, 128 * 128),
     ("split", 6, 217, 10000, 128 * 128), ("global", 2, 64, 2000, 512 * 512)],
)
def test_bin_map_kernel_matches_plain(cuda_device, form, n_channels, n_det, n_t, n_pix, count):
    """K2 against its plain version on every bin_plan form, with and
    without the in-kernel count (the split form also where its full groups'
    launch takes fewer blocks than its last group's), on ids in runs of ~5
    samples (as a scan gives them) with -1 runs and ids >= n_pix: counts
    exactly, sums within 1e-5 of the map's maximum of the plain sums taken
    in float64."""
    from maria_torch.ops.bin_map import bin_plan

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    n = n_det * n_t
    runs = torch.randint(-1, n_pix + 64, (n // 5 + 1,), generator=gen, device=cuda_device, dtype=torch.int32)
    ids = runs.repeat_interleave(5)[:n].reshape(n_det, n_t).contiguous()
    data = torch.randn((n_channels, n_det, n_t), generator=gen, device=cuda_device)
    channels = data if count else torch.cat([data, torch.ones_like(data[:1])]).contiguous()
    assert bin_plan(n_pix, channels.shape[0], n, count)["form"] == form
    before = bin_map.launches
    out = bin_map(channels, ids, n_pix, count=count)
    ref = bin_map_plain(channels, ids, n_pix, count=count)
    torch.cuda.synchronize()
    assert bin_map.launches == before + 1
    assert out.shape == ref.shape == (n_channels + 1, n_pix)
    assert torch.equal(out[-1], ref[-1]) and float(ref[-1].sum()) > 0
    keep = (ids >= 0) & (ids < n_pix)
    for s in range(n_channels):
        exact = torch.zeros(n_pix, dtype=torch.float64, device=cuda_device)
        exact.index_add_(0, ids[keep].long(), data[s][keep].double())
        assert float((out[s] - exact).abs().max()) <= 1e-5 * float(exact.abs().max())


@pytest.mark.cuda
def test_slice_on_card_matches_cpu(cuda_device):
    """The same draws through the slice on the card (kernels) and on the
    CPU (plain versions) give the same TOD to f32, and maps whose hit
    counts differ only where f32 pointing rounds across a pixel edge."""
    import maria_torch

    def scene(device):
        plan = maria_torch.get_plan(
            "daisy_5arcmin_60s", start_time=1.75e9, scan_center=(150.0, 41.0), frame="az/el",
            duration=10.0, sample_rate=50.0, scan_options={"radius": 0.083, "speed": 0.017},
        )
        return maria_torch.Simulation(instrument="MUSTANG-2", plans=plan, site="GBT",
                                      atmosphere="2d", noise=True, seed=0, device=device)

    sim_cpu, sim_gpu = scene("cpu"), scene(cuda_device)
    p = sim_cpu.program()
    gen = torch.Generator().manual_seed(0)
    n_f = 512 // 2 + 1  # good_fft_size(500)
    draws = {
        "screens": [torch.randn((s.ny, s.nx // 2 + 1, 2), generator=gen) for s in p.screens],
        "noise": [torch.randn((len(b.det_index), n_f, 2), generator=gen) for b in p.bands],
        "modes": [torch.randn((b.noise_basis.shape[1], n_f, 2), generator=gen) for b in p.bands],
        "gains": torch.randn((p.n_det,), generator=gen),
    }
    before = (pink_noise.launches, bin_map.launches)
    tod_c, tod_g = sim_cpu.run(draws=[draws])[0], sim_gpu.run(draws=[draws])[0]
    assert tod_g.device.type == "cuda" and pink_noise.launches == before[0] + 2
    for k in tod_c.fields:
        ref = tod_c.data[k]
        assert float((tod_g.data[k].cpu() - ref).abs().max()) <= 2e-6 * float(ref.abs().max()) + 1e-4 * float(ref.std())

    kw = dict(center=tuple(float(c) for c in np.degrees(tod_c.boresight.center())), width=0.25,
              resolution=0.25 / 128, frame="az/el", map_postprocessing={"keep_mean": True})
    map_c = maria_torch.BinMapper(tod_c, **kw).run()
    map_g = maria_torch.BinMapper(tod_g, **kw).run()
    assert bin_map.launches == before[1] + 1
    assert float((map_g.weight - map_c.weight).abs().sum()) <= 5e-3 * float(map_c.weight.sum())


def _bf16_ulp(x):
    """One bfloat16 ulp at |x| (8 significant bits)."""
    _, e = torch.frexp(x.abs().clamp_min(1e-30))
    return torch.ldexp(torch.ones_like(x), e - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("n_det,m1", [(50004, 1537), (5, 257)])
def test_shared_v_kernel_matches_plain(cuda_device, n_det, m1):
    """K3 against its plain version on the same key: every element within
    one bf16 ulp (the two evaluate log, sqrt and sincos in float32 with
    different last-bit rounding, which can move a bf16 rounding)."""
    c = band_half_spectrum(50.0, 0.5, 1.0, 2 * (m1 - 1), corr_prop=0.5)
    key = draw_key(torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    before = shared_v.launches
    V = shared_v(key, c, n_det)[0].float()
    ref = shared_v_plain(key, c, n_det)[0].float()
    torch.cuda.synchronize()
    assert shared_v.launches == before + 1
    assert V.shape == (n_det, 2 * m1)
    assert bool(((V - ref).abs() <= _bf16_ulp(torch.maximum(V.abs(), ref.abs()))).all())
    assert float((V == ref).float().mean()) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("row0,n_det", [(25002, 25002), (3, 4099), (1, 5)])
def test_shared_v_kernel_at_row0(cuda_device, row0, n_det):
    """K3 at a rank's first row: within one bf16 ulp of the plain version
    at that row0, and equal bit for bit to those rows of a row0 = 0 launch."""
    c = band_half_spectrum(50.0, 0.5, 1.0, 2 * 1536, corr_prop=0.5)
    key = draw_key(torch.Generator(device=cuda_device).manual_seed(2), cuda_device)
    V = shared_v(key, c, n_det, row0=row0)[0]
    ref = shared_v_plain(key, c, n_det, row0=row0)[0].float()
    whole = shared_v(key, c, row0 + n_det)[0]
    torch.cuda.synchronize()
    assert bool(((V.float() - ref).abs() <= _bf16_ulp(torch.maximum(V.float().abs(), ref.abs()))).all())
    assert torch.equal(V, whole[row0:])


@pytest.mark.cuda
@pytest.mark.parametrize("m1,gap", [(1537, 0), (1537, 1), (1536, 1), (257, 7)])
def test_shared_v_kernel_into_strided_operand(cuda_device, m1, gap):
    """K3 written into a wider operand of row stride 2 m1 + gap (even and
    odd strides, odd and even m1): every element within one bf16 ulp of
    the plain version, and the columns from 2 m1 on untouched."""
    n_det = 4099
    c = band_half_spectrum(50.0, 0.5, 1.0, 2 * (m1 - 1), corr_prop=0.5)
    key = draw_key(torch.Generator(device=cuda_device).manual_seed(1), cuda_device)
    sentinel = -12288.0
    buf = torch.full((1, n_det, 2 * m1 + gap), sentinel, dtype=torch.bfloat16, device=cuda_device)
    V = shared_v(key, c, n_det, out=buf)[0].float()
    ref = shared_v_plain(key, c, n_det)[0].float()
    torch.cuda.synchronize()
    assert bool(((V - ref).abs() <= _bf16_ulp(torch.maximum(V.abs(), ref.abs()))).all())
    assert float((V == ref).float().mean()) >= 0.99
    assert bool((buf[0, :, 2 * m1:] == sentinel).all())


def _atlast_scene(device):
    import maria_torch

    plan = maria_torch.get_plan(
        "daisy_5arcmin_60s", start_time=1.75e9, scan_center=(150.0, 41.0), frame="az/el",
        duration=10.0, sample_rate=50.0, scan_options={"radius": 0.5, "speed": 0.25},
    )
    array = {"primary_size": 50, "n": 19, "field_of_view": 2.0, "shape": "circle",
             "bands": [f"atlast/f{b}" for b in ("042", "093", "150", "220", "280", "350", "400", "650", "850")]}
    return maria_torch.Simulation(instrument=maria_torch.get_instrument(array=array), plans=plan, site="ALMA",
                                  atmosphere="3d", noise=True, seed=0, device=device)


@pytest.mark.cuda
def test_atlast_total_on_card_matches_cpu(cuda_device):
    """The small AtLAST-shaped scene's total_power_fn on the card and on
    the CPU given the same draws: within 1e-4 of the total's std (float32
    FFTs, gathers and products in another order; a bf16 rounding of a mode
    time series value may flip). Without injected draws the card's total
    launches K3 once and K1 never."""
    sim_cpu, sim_gpu = _atlast_scene("cpu"), _atlast_scene(cuda_device)
    p = sim_cpu.program()
    specs, _, n_fft, shared_c, _ = p._noise_matmul_specs()
    assert shared_c is not None
    m1 = n_fft // 2 + 1
    gen = torch.Generator().manual_seed(0)
    g = p.groups[0]
    draws = {
        "groups": [torch.randn((2 * g.W.shape[0], g.ny, g.nx // 2 + 1, 2), generator=gen)],
        "gains": torch.randn((p.n_det,), generator=gen),
        "v": torch.randn((p.n_det, 2, m1), generator=gen),
        "modes": [torch.randn((sp.k_modes, 2, m1), generator=gen) for sp in specs],
    }
    total_c = p.total_power_fn()(draws=draws, device="cpu")
    total_g = sim_gpu.program().total_power_fn()(draws=draws, device=cuda_device)
    torch.cuda.synchronize()
    assert float((total_g.cpu() - total_c).abs().max()) <= 1e-4 * float(total_c.std())

    before = (shared_v.launches, pink_noise.launches)
    total = sim_gpu.program().total_power_fn()(generator=sim_gpu.generator, device=cuda_device)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(total).all()) and total.shape == (p.n_det, p.n_t)
    assert (shared_v.launches, pink_noise.launches) == (before[0] + 1, before[1])


def _stacked_process(n_ext, n_layer, n_layers):
    """A process over ``n_layers`` stacked cross-sections of ``n_layer``
    points, extruded ``n_ext`` steps: (209, 21, 12) is the shape of the
    AtLAST-50k 60 s 3-D process (n_cross 252, n_sample 510)."""
    heights = np.geomspace(50.0, 5000.0, n_layers)
    cross = np.concatenate([np.stack([12.5 * np.arange(n_layer), np.full(n_layer, h)], axis=-1) for h in heights])
    p = AutoregressiveProcess(cross, 12.5 * np.arange(n_ext), callback_kwargs={"nu": 1 / 3, "r0": 1000.0})
    p.run_setup()
    return p


ALL_SIZES = (1, 2, 4, 8)  # the cluster sizes the kernel runs on; the plan's rule picks from 1 and 8


def _check_ar(processes, device, seed=0, smem_limit=None, clusters=None):
    """The kernel (one launch a cluster size of ``processes``' plan, which
    must give them ``clusters`` when given) against the plain loop on the
    same draws: every screen within 1e-4 of its std (float32 dots summed
    in another order, the rounding carried through the lookback)."""
    plan = ar_plan(processes, device, smem_limit=smem_limit, sizes=ALL_SIZES if smem_limit else (1, 8))
    if clusters is not None:
        assert plan["cluster"] == clusters
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = [p.draw(gen, device) for p in processes]
    before = ar_extrude.launches
    out = ar_extrude(processes, [d[0] for d in draws], [d[1] for d in draws], plan=plan)
    torch.cuda.synchronize()
    assert ar_extrude.launches == before + len({max(c, 1) for c in plan["cluster"]}) == before + len(plan["groups"])
    for p, o, (b, e) in zip(processes, out, draws):
        t = p.tensors(device)
        ref = ar_extrude_reference(t["A"], t["B"], b, t["ext_idx"], t["cross_idx"], e)[: p.n_extrusion]
        assert o.shape == ref.shape == (p.n_extrusion, p.n_cross_section)
        assert bool(torch.isfinite(o).all())
        assert float((o - ref).abs().max()) <= 1e-4 * float(ref.std())


@pytest.mark.cuda
@pytest.mark.parametrize("duration", [60.0, 600.0])
def test_ar_kernel_matches_plain_at_mustang2_processes(cuda_device, duration):
    """Every process of the MUSTANG-2 2-D AR scene at 60 s and 600 s (8
    each, up to 174 and 1,686 extrusion steps), in one launch, each in one
    block with A and B in its shared memory."""
    from maria_torch.scenes import simulation

    processes = simulation("mustang2", duration, cuda_device, method="ar").program().ar_processes
    assert len(processes) == 8
    _check_ar(processes, cuda_device, clusters=[1] * 8)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [8, 4, 0])
def test_ar_kernel_matches_plain_at_the_3d_shape(cuda_device, cluster):
    """The AtLAST-50k 3-D process's shape, whose A and B (0.77 MB) do not
    fit one block's shared memory: on the cluster of eight the plan gives
    it on this card, on the smallest cluster that holds it, four, and read
    through L2 from one block (forced by a limit under its need at
    eight)."""
    p = _stacked_process(209, 21, 12)
    assert (p.n_cross_section, p.n_sample) == (252, 510)
    limit = {8: None, 4: ar_smem_bytes(252, 510, 4), 0: ar_smem_bytes(252, 510, 8) - 4}[cluster]
    _check_ar([p], cuda_device, smem_limit=limit, clusters=[cluster])


def _resampled(p, ext_idx, cross_idx):
    """``p`` with its lookback replaced by the samples (ext_idx, cross_idx)
    and A by a random stable operator of their width."""
    p.extrusion_sample_index, p.cross_section_sample_index = np.asarray(ext_idx), np.asarray(cross_idx)
    p.n_sample = len(ext_idx)
    p.A = np.random.default_rng(2).uniform(-1, 1, (p.n_cross_section, p.n_sample)) / p.n_sample
    p._device_cache = {}
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 0])
def test_ar_kernel_on_each_cluster_size(cuda_device, cluster):
    """Small processes on every cluster size, forced by the shared-memory
    limit given to ar_plan: a 40 x 87 process whose limit is its need at
    that size (0: four bytes under its need at eight, so through L2); a
    6 x 34 one (on eight blocks two own no row); one whose newest row is
    sampled at three of six columns, one of them twice; and one with 150
    older samples, more than the threads of a block of one or two rows
    load ahead in registers, so that the rest is loaded after the dot."""
    p = _stacked_process(30, 10, 4)
    assert (p.n_cross_section, p.n_sample) == (40, 87)
    limit = ar_smem_bytes(40, 87, cluster) if cluster else ar_smem_bytes(40, 87, 8) - 4
    _check_ar([p], cuda_device, smem_limit=limit, clusters=[cluster])
    if cluster:
        q = _stacked_process(36, 6, 1)
        _check_ar([q, q], cuda_device, seed=3, smem_limit=ar_smem_bytes(6, q.n_sample, cluster), clusters=[cluster] * 2)
        s = _resampled(_stacked_process(8, 6, 1), [1, 1, 1, 0, 0, 0, 0, 2, 4, 7, 7], [0, 2, 5, 4, 0, 2, 4, 1, 3, 0, 5])
        _check_ar([s], cuda_device, seed=4, smem_limit=ar_smem_bytes(6, 11, cluster), clusters=[cluster])
        rng = np.random.default_rng(5)
        long = _resampled(_stacked_process(8, 6, 1), np.r_[np.zeros(6, dtype=int), rng.integers(1, 8, 150)],
                          np.r_[np.arange(6), rng.integers(0, 6, 150)])
        _check_ar([long], cuda_device, seed=6, smem_limit=ar_smem_bytes(6, 156, cluster), clusters=[cluster])


@pytest.mark.cuda
def test_ar_kernel_mixed_batch(cuda_device):
    """Processes of mixed shapes in one call: small ones and one of 203 KB
    of A and B, just under the 227 KB limit, in one block each; one of 507
    KB on a cluster; one of 2 MB, too large for a cluster of eight, read
    through L2: one launch a cluster size."""
    processes = [_stacked_process(n, k, l)
                 for n, k, l in ((36, 6, 1), (90, 9, 3), (100, 32, 4), (80, 17, 12), (5, 3, 1), (60, 40, 10))]
    plan = ar_plan(processes, cuda_device)
    assert plan["cluster"] == [1, 1, 1, 8, 1, 0]
    assert len(plan["groups"]) == 2
    _check_ar(processes, cuda_device, seed=1)


@pytest.mark.cuda
def test_ar_scene_on_card_matches_cpu(cuda_device):
    """The MUSTANG-2 2-D AR scene's pwv on the card (kernel) and on the CPU
    (plain loop) given the same draws: within 1e-4 of the pwv std or 8 ulp
    of the mean pwv, whichever is larger (a 10 s scene's pwv varies by
    ~1e-4 of its ~19 mm mean, so the float32 sum of the mean and the
    layers rounds at the mean's ulp)."""
    from maria_torch.scenes import simulation

    p_cpu = simulation("mustang2", 10.0, "cpu", method="ar").program()
    p_gpu = simulation("mustang2", 10.0, cuda_device, method="ar").program()
    gen = torch.Generator().manual_seed(2)
    draws = {"ar": [q.draw(gen, "cpu") for q in p_cpu.ar_processes]}
    before = ar_extrude.launches
    ref = p_cpu.fields(draws=draws, device="cpu", upto="pwv")["pwv"]
    got = p_gpu.fields(draws=draws, device=cuda_device, upto="pwv")["pwv"]
    torch.cuda.synchronize()
    assert ar_extrude.launches == before + 1
    atol = max(1e-4 * float(ref.std()), 8 * float(np.spacing(np.float32(p_cpu.mean_pwv))))
    assert float((got.cpu() - ref).abs().max()) <= atol


@pytest.mark.cuda
def test_process_run_defaults_to_the_card(cuda_device):
    """AutoregressiveProcess.run() with no generator and no device draws on
    the card and extrudes with the kernel."""
    p = _stacked_process(36, 6, 1)
    before = ar_extrude.launches
    values = p.run()
    torch.cuda.synchronize()
    assert values.device.type == "cuda" and values.shape == (36, 6)
    assert ar_extrude.launches == before + 1 and bool(torch.isfinite(values).all())


@pytest.mark.cuda
def test_radec_pixel_ids_on_card_match_cpu(cuda_device):
    """The ra/dec ids of the 60 s sky scene on its 512 x 512 map: float32
    pointing rounds across a pixel border for at most 0.5% of the samples,
    each into a neighbouring pixel."""
    from maria_torch.mappers.bin_mapper import radec_pixel_ids
    from maria_torch.scenes import sky_simulation
    from maria_torch.tod import Pointing

    sim = sky_simulation(60.0, "cpu", atmosphere=None, noise=False)
    obs, sky = sim.obs_list[0], sim.map
    pointing = Pointing(obs.boresight, obs.offsets, obs.q)
    on_cpu = radec_pixel_ids(pointing, sky.center, sky.x_res, sky.n_x, sky.n_y, device="cpu")
    on_card = radec_pixel_ids(pointing, sky.center, sky.x_res, sky.n_x, sky.n_y, device=cuda_device)
    assert on_card.device.type == "cuda" and on_card.dtype == torch.int32 and int(on_cpu.min()) >= 0
    a, b = on_cpu.long(), on_card.cpu().long()
    moved = a != b
    assert float(moved.float().mean()) <= 5e-3
    assert int(((a // sky.n_x - b // sky.n_x).abs().max())) <= 1 and int((a % sky.n_x - b % sky.n_x).abs().max()) <= 1


def _pixel_id_case(scene, device):
    """(factors on ``device``, geometry) of a card test's scene
    (tests/pixel_id_scenes.py)."""
    import pixel_id_scenes as scenes

    if scene.startswith("edges"):
        factors, geometry = scenes.edge_scene("az/el" if scene == "edges_azel" else "ra/dec")
        return [None if x is None else x.to(device) for x in factors], geometry
    obs, geometry = scenes.act_scene() if scene == "act" else scenes.cmb_patch_scene()
    frame = "az/el" if scene == "cmb_patch_azel" else "ra/dec"
    if frame == "az/el":
        geometry = scenes.mapper_geometry(obs, "az/el", 2 / 60)
    if scene == "cmb_patch_cut":
        geometry = (*geometry[:2], 98, 98)
    return scenes.pointing(obs).factors(frame, device=device), geometry


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["act", "cmb_patch", "cmb_patch_cut", "cmb_patch_azel", "edges_radec",
                                   "edges_azel"])
def test_pixel_ids_kernel_bit_equal_to_plain(cuda_device, scene):
    """The pixel-id kernel against the plain chain on the card, bit for
    bit, one launch a call: the ACT cell's pointing (9,000 x 12,000 ra/dec
    into BinMapper's 577 x 577), the CMB patch's (1,052 x 12,000 into the
    ML mapper's 197 x 197, into a 98 x 98 cut of it off which samples
    fall, and in az/el), and the edge scene in both frames (r = 0, a
    half-pixel border, every edge, NaN boresight samples)."""
    from maria_torch.ops.pixel_ids import pixel_ids, pixel_ids_plain

    (offsets, phi, theta, cos_q, sin_q), geometry = _pixel_id_case(scene, cuda_device)
    before = pixel_ids.launches
    ids = pixel_ids(offsets, phi, theta, *geometry, cos_q, sin_q)
    assert pixel_ids.launches == before + 1
    ref = pixel_ids_plain(offsets, phi, theta, *geometry, cos_q, sin_q)
    torch.cuda.synchronize()
    assert ids.device.type == "cuda" and ids.dtype == torch.int32 and ids.shape == (len(offsets), len(phi))
    differ = (ids != ref).nonzero()
    assert torch.equal(ids, ref), (f"{len(differ)} of {ids.numel()} ids differ, first at {differ[:4].tolist()}: "
                                   f"{[(int(ids[i, j]), int(ref[i, j])) for i, j in differ[:4].tolist()]}")
    if scene == "act":
        assert geometry[2:] == (577, 577) and ids.shape == (9000, 12000)
    if scene in ("cmb_patch_cut", "edges_radec", "edges_azel"):
        assert bool((ids == -1).any()) and bool((ids >= 0).any())
    if scene.startswith("edges"):
        assert int(ids[0, 0]) % geometry[2] == 2  # 2.5 pixels from the first column: half to even


@pytest.mark.cuda
def test_map_stage_on_card_matches_cpu(cuda_device):
    """The card's beam smoothing 1e-5 of the map's maximum against float64
    on the CPU (its result stays on the card), offsets 2e-6 rad (float32
    both), the gather 1e-5 of the map's maximum against float64 at the
    same offsets, the whole field within one float32 ulp of ra over the
    map's steepest pixel."""
    from maria_torch.scenes import map_stage_errors, sky_simulation

    sim = sky_simulation(60.0, cuda_device, atmosphere=None, noise=False)
    assert sim.map.data.device.type == "cpu" and sim.map.smooth(1e-4).data.device.type == "cuda"
    e = map_stage_errors(sim, cuda_device)
    assert e["smooth"] <= 1e-5 and e["offsets_rad"] <= 2e-6 and e["gather"] <= 1e-5 and e["field"] <= e["field_limit"] < 1e-3, e


@pytest.mark.cuda
def test_sky_scene_on_card_recovers_its_input_map(cuda_device):
    """The 600 s scene without atmosphere or noise, binned in ra/dec on the
    input map's grid by one K2 launch: correlation with the beam-smoothed
    input above 0.95 over the better-covered half of the hit pixels."""
    from maria_torch.scenes import sky_mapper, sky_recovery, sky_simulation

    sim = sky_simulation(600.0, cuda_device, atmosphere=None, noise=False)
    tod = sim.run()[0]
    assert tod.device.type == "cuda" and tod.fields == ["map"] and tod.shape == (217, 30000)
    before = bin_map.launches
    out = sky_mapper([tod], sim.map).run()
    assert bin_map.launches == before + 1 and float(out.weight.sum()) == 217 * 30000
    assert sky_recovery(sim, out) > 0.95


def _sht_case(nside, lmax, S, spin, device, seed=0):
    """One spin's lane tables on ``device`` and S random planes of each
    kernel's input, made with numpy from ``seed``."""
    from maria_torch.healpix.sht import lane_tables

    t = lane_tables(lmax, nside, spin, device)
    rng = np.random.default_rng(seed)
    L, nh = lmax + 1, 2 * nside
    rows = torch.as_tensor(rng.standard_normal((S, L, L)).astype(np.float32), device=device)
    h = torch.as_tensor(rng.standard_normal((S, L, nh)).astype(np.float32), device=device)
    return t, rows, h


def _planes_within(out, ref, rel=1e-5):
    """Every plane of ``out`` within ``rel`` of its plain plane's maximum."""
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    for s in range(out.shape[0]):
        scale = float(ref[s].abs().max())
        assert scale > 0 and float((out[s] - ref[s]).abs().max()) <= rel * scale, s


# (nside, lmax, S, spin): odd nside; lmax below and above nh = 2 nside; one
# to eight planes; at nside 16 lanes of m up to 200, whose seeds lie far
# below float32's range and rescale through several exponents
SHT_CASES = [(8, 12, 1, 0), (8, 40, 4, 2), (33, 50, 8, -2), (33, 90, 3, 0), (64, 100, 4, 0), (64, 200, 4, 2),
             (16, 200, 4, 0), (16, 200, 8, -2)]


@pytest.mark.cuda
@pytest.mark.parametrize("nside,lmax,S,spin", SHT_CASES)
def test_sht_synth_kernel_matches_plain(cuda_device, nside, lmax, S, spin):
    """KS1 against its plain version on the same tables and rows: every
    acc plane within 1e-5 of its maximum, and equal element for element
    (both round every product and sum on its own)."""
    from maria_torch.ops.sht import sht_synth, sht_synth_plain

    t, rows, _ = _sht_case(nside, lmax, S, spin, cuda_device)
    before = sht_synth.launches
    out = sht_synth(t, rows)
    assert sht_synth.launches == before + 1
    ref = sht_synth_plain(t, rows)
    _planes_within(out, ref)
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("nside,lmax,S,spin", SHT_CASES)
def test_sht_anal_kernel_matches_plain(cuda_device, nside, lmax, S, spin):
    """KS2 against its plain version: every ys plane within 1e-5 of its
    maximum, and zero for l below each m's seed step."""
    from maria_torch.ops.sht import sht_anal, sht_anal_plain

    t, _, h = _sht_case(nside, lmax, S, spin, cuda_device)
    before = sht_anal.launches
    out = sht_anal(t, h)
    assert sht_anal.launches == before + 1
    _planes_within(out, sht_anal_plain(t, h))
    below = torch.arange(lmax + 1, device=cuda_device)[:, None] < t["seed_step"][None, :]
    assert float(out[:, below].abs().max()) == 0.0


@pytest.mark.cuda
def test_sht_transforms_on_card_match_cpu(cuda_device):
    """The four transforms at nside 64 and lmax 128 on the card against
    the CPU, 1e-5 of each output's maximum."""
    from maria_torch.healpix.sht import alm2map, alm2map_spin, map2alm, map2alm_spin, synalm

    lmax, nside = 128, 64
    cl = 1.0 / (np.arange(lmax + 1) + 1.0) ** 2
    a, e, b = (synalm(cl, lmax=lmax, seed=s) for s in (1, 2, 3))
    for fn, args in ((alm2map, (a, nside)), (alm2map_spin, (e, b, nside))):
        card, cpu = fn(*args, device=cuda_device), fn(*args, device="cpu")
        for x, y in zip(card if isinstance(card, tuple) else (card,), cpu if isinstance(cpu, tuple) else (cpu,)):
            assert x.device.type == "cuda"
            assert float((x.cpu() - y).abs().max()) <= 1e-5 * float(y.abs().max())
    m = alm2map(a, nside, device="cpu")
    Q, U = alm2map_spin(e, b, nside, device="cpu")
    for card, cpu in ((map2alm(m.to(cuda_device), lmax), map2alm(m, lmax)),
                      (map2alm_spin(Q.to(cuda_device), U.to(cuda_device), lmax), map2alm_spin(Q, U, lmax))):
        for x, y in zip(card if isinstance(card, tuple) else (card,), cpu if isinstance(cpu, tuple) else (cpu,)):
            assert float((x.cpu() - y).abs().max()) <= 1e-5 * float(y.abs().max())


# (nside, lmax, spin): 2, 4 and 8 rings a thread (nh 600, 1200, 2200 and 4096
# with padded lanes), and at nside 300 and lmax 220 warps of polar rings that
# walk chunks in the full rescale and skip steps without a contribution
SHT_WIDE_CASES = [(300, 220, 0), (600, 40, 2), (1100, 30, -2), (2048, 12, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("nside,lmax,spin", SHT_WIDE_CASES)
@pytest.mark.parametrize("S", [1, 2, 3, 4, 5, 8])
def test_sht_kernels_on_wide_rings(cuda_device, nside, lmax, spin, S):
    """KS1 equal element for element to its plain version and KS2 within
    1e-5 of each plane's maximum (zero below the seed steps) at every
    lanes-a-thread plan and at one to eight planes (one or two float4s of
    rows a step; butterfly groups of 32, 16, 8 and 4 steps)."""
    from maria_torch.ops.sht import sht_anal, sht_anal_plain, sht_synth, sht_synth_plain

    t, rows, h = _sht_case(nside, lmax, S, spin, cuda_device, seed=S)
    assert torch.equal(sht_synth(t, rows), sht_synth_plain(t, rows))
    out = sht_anal(t, h)
    _planes_within(out, sht_anal_plain(t, h))
    below = torch.arange(lmax + 1, device=cuda_device)[:, None] < t["seed_step"][None, :]
    assert not bool(below.any()) or float(out[:, below].abs().max()) == 0.0


@pytest.mark.cuda
def test_sht_packed_tables_on_card(cuda_device):
    """The kernels' packed coef on the card is the CPU's, and KS2 refuses
    more rings than one block holds."""
    from maria_torch.healpix.sht import lane_tables
    from maria_torch.ops import kernels
    from maria_torch.ops.sht import sht_anal

    card, cpu = lane_tables(60, 33, 2, cuda_device), lane_tables(60, 33, 2, "cpu")
    for key in ("coef", "alpha", "seed_val", "seed_exp", "seed_step", "z"):
        assert card[key].device.type == "cuda" and torch.equal(card[key].cpu(), cpu[key])
    big = kernels.load().maria_sht_max_rings() // 2 + 1  # nside with nh = 2 nside past the limit
    t = lane_tables(4, big, 0, cuda_device)
    with pytest.raises(ValueError, match="at most"):
        sht_anal(t, torch.zeros((1, 5, 2 * big), device=cuda_device))


@pytest.mark.cuda
def test_sht_transforms_copy_nothing_to_the_host(cuda_device, monkeypatch):
    """Once the tables are built, the four transforms on the card copy no
    map, accumulator or a_lm to the host (Tensor.cpu, numpy, tolist and
    item raise), and generate_cmb with one seed gives the same maps twice."""
    from maria_torch.cmb import generate_cmb
    from maria_torch.healpix.sht import alm2map, alm2map_spin, map2alm, map2alm_spin, synalm

    lmax, nside = 95, 32
    cl = 1.0 / (np.arange(lmax + 1) + 1.0) ** 2
    a, e = (torch.as_tensor(synalm(cl, lmax=lmax, seed=s), dtype=torch.complex64, device=cuda_device) for s in (1, 2))

    def run():
        T, (Q, U) = alm2map(a, nside), alm2map_spin(e, a, nside)
        return T, Q, U, map2alm(T, lmax), *map2alm_spin(Q, U, lmax)

    warm = run()

    def refuse(*args, **kwargs):
        raise AssertionError("a device-to-host copy in the transforms")

    for name in ("cpu", "numpy", "tolist", "item"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    again = run()
    torch.cuda.synchronize()
    monkeypatch.undo()
    for x, y in zip(warm, again):
        assert x.device.type == "cuda" and torch.equal(x, y)
    first, second = (generate_cmb(nside=64, seed=3, device=cuda_device).data for _ in range(2))
    assert torch.equal(first, second)


def _sky_tods(device, duration, atmosphere=None):
    """The sky scene's TOD on ``device`` and the same TOD with its fields
    copied to the CPU."""
    from maria_torch.scenes import sky_simulation
    from maria_torch.tod import TOD

    tod = sky_simulation(duration, device, atmosphere=atmosphere, noise=True).run()[0]
    cpu = TOD(data={k: v.cpu() for k, v in tod.data.items()}, pointing=tod.pointing, weight=tod.weight.cpu(),
              units=tod.units, dets=tod.dets, metadata=tod.metadata)
    return tod, cpu


@pytest.mark.cuda
@pytest.mark.parametrize("t_bins", [1, 2])
def test_bin_map_as_the_ml_pt(cuda_device, t_bins):
    """K2 as the ML mapper's P^T: one Stokes-weighted channel at the
    channel- and time-bin-offset ids of a 0.2 deg grid over the 10 s
    daisy, whose overflow buckets hold some of the samples: one launch,
    sums within 1e-5 of the maximum of the plain sums taken in float64."""
    import maria_torch

    tod, _ = _sky_tods(cuda_device, 10.0)
    mapper = maria_torch.MaximumLikelihoodMapper([tod], t_bins=t_bins, center=(150.0, 10.0), width=0.2,
                                                 resolution=0.2 / 64, frame="ra/dec")
    block = mapper.blocks[0]
    ids = block["pix"]
    assert all(block[k].device.type == "cuda" for k in ("pix", "sw", "data"))
    assert bool(((ids % mapper.n_pix1) == mapper.n_pix).any()) and int(ids.max()) < mapper.n_cpix
    v = torch.randn(ids.shape, generator=torch.Generator(device=cuda_device).manual_seed(0), device=cuda_device)
    before = bin_map.launches
    out = mapper._project_T(v, block)
    torch.cuda.synchronize()
    assert bin_map.launches == before + 1
    row = (block["sw"][:, 0, None] * v).reshape(-1).double()
    exact = torch.zeros(mapper.n_cpix, dtype=torch.float64, device=cuda_device).index_add_(0, ids.reshape(-1).long(), row)
    assert float((out.double() - exact).abs().max()) <= 1e-5 * float(exact.abs().max())
    plain = bin_map_plain((block["sw"].T[:, :, None] * v[None]).contiguous(), ids, mapper.n_cpix).reshape(-1)
    assert float((plain.double() - exact).abs().max()) <= 1e-5 * float(exact.abs().max())


@pytest.mark.cuda
def test_ml_fit_and_processing_on_card_match_cpu(cuda_device):
    """A small fit on the card (the 20 s scene, 64 x 64 at 0.5 deg, k = 2,
    2 epochs x 15 CG steps) against the same fit on the CPU from the card's
    blocks (the CPU's float32 ra/dec moves a few samples to the next
    pixel): within 1e-3 of the map's maximum, as
    tests/test_torch_ml_mapper.py holds the port to maria_tpu; the
    tutorial's processing chain on the scene with the atmosphere (whose
    common mode its remove_modes takes out) within 1e-5 of the input's
    maximum; the maps come back to the host."""
    import maria_torch
    from maria_torch.convert import ml_state_from_arrays

    tod, cpu = _sky_tods(cuda_device, 20.0)
    kw = dict(center=(150.0, 10.0), width=0.5, resolution=0.5 / 64, frame="ra/dec", n_epochs=2, n_cg_iters=15, k=2)
    on_card = maria_torch.MaximumLikelihoodMapper([tod], **kw)
    card_map = on_card.fit()
    block = {k: on_card.blocks[0][k].cpu().numpy() for k in ("pix", "sw", "data")} | {"fs": on_card.blocks[0]["fs"]}
    cpu_map = ml_state_from_arrays(maria_torch.MaximumLikelihoodMapper([cpu], **kw), [block]).fit()
    assert card_map.data.device.type == "cpu" and bool(torch.isfinite(card_map.data).all())
    scale = float(cpu_map.data.abs().max())
    assert float((card_map.data - cpu_map.data).abs().max()) <= 1e-3 * scale
    chain = {"remove_spline": {"knot_spacing": 60, "remove_el_gradient": True}, "remove_modes": {"modes_to_remove": 1}}
    tod, cpu = _sky_tods(cuda_device, 20.0, atmosphere="2d")
    on_card, on_cpu = tod.process(**chain), cpu.process(**chain)
    assert on_card.device.type == "cuda"
    assert float((on_card.signal.cpu() - on_cpu.signal).abs().max()) <= 1e-5 * float(cpu.signal.abs().max())


# -- polarization: K2 at the IQU shapes, the CMB patch on the card ---------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n_channels", [3, 6])
def test_bin_map_at_the_polarized_shapes(cuda_device, n_channels):
    """K2 with three channels (the IQU P^T of the CMB patch: ids in
    [0, n_pix), 2 x (197 x 197 + 1) pixels) and six (BinMapper's IQU
    band: -1 off the map) at 1,052 x 12,000 samples against its float64
    plain sums: within 1e-5 of their maximum."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    n_pix = 2 * (197 * 197 + 1)
    low = 0 if n_channels == 3 else -1
    ids = torch.randint(low, n_pix, (1052, 12000), generator=g, device=cuda_device, dtype=torch.int32)
    data = torch.randn((n_channels, 1052, 12000), generator=g, device=cuda_device)
    out = bin_map(data, ids, n_pix)
    keep = ids.reshape(-1) >= 0
    exact = torch.zeros((n_channels, n_pix), dtype=torch.float64, device=cuda_device)
    exact.index_add_(1, ids.reshape(-1)[keep].long(), data.reshape(n_channels, -1)[:, keep].double())
    assert float((out.double() - exact).abs().max()) <= 1e-5 * float(exact.abs().max())


@pytest.mark.cuda
def test_cmb_patch_on_card_matches_cpu(cuda_device):
    """The CMB patch of docs/tutorials.md (a 20 s cut, noise off, one CMB
    at nside 256 drawn on the card and one gains draw handed to both) on
    the card against the CPU, the CPU given the card's HEALPix pixels (a
    sample within an ulp of a pixel's edge may take the neighbour): within
    1e-5 of the TOD's maximum; and the IQU ML fit of both bands finite."""
    from maria_torch import scenes
    from maria_torch.cmb import generate_cmb
    from maria_torch.tod import Pointing

    cmb = generate_cmb(nside=256, seed=0, device=cuda_device)
    gains = torch.randn(1052, generator=torch.Generator().manual_seed(5))
    sims = {d: scenes.cmb_patch_simulation(20.0, d, cmb=cmb, noise=False) for d in ("cuda", "cpu")}
    card = sims["cuda"].run(draws=[{"gains": gains.cuda()}])[0]
    obs = sims["cuda"].obs_list[0]
    det_index = np.arange(obs.shape[0])
    pix = {}
    for band in obs.instrument.dets.bands:
        rows = det_index[obs.instrument.dets.band_name == band.name]
        ra, dec = Pointing(obs.boresight, obs.offsets[rows], obs.q).det_radec(device="cuda")
        pix[band.name] = cmb.radec_pixels(ra, dec).cpu()
    order = iter(pix.values())
    cmb.radec_pixels = lambda ra, dec: next(order)  # the bands in the order compute_cmb_loading takes them
    try:
        cpu = sims["cpu"].run(draws=[{"gains": gains}])[0]
    finally:
        del cmb.radec_pixels
    scale = float(cpu.signal.abs().max())
    assert float((card.signal.cpu() - cpu.signal).abs().max()) <= 1e-5 * scale
    out = scenes.cmb_patch_mapper([card]).fit(epochs=1, steps_per_epoch=5)
    assert out.stokes == "IQU" and out.data.shape[:2] == (3, 2) and bool(torch.isfinite(out.data).all())


@pytest.mark.cuda
def test_dp_dt_cmb_elevation_table_on_card_matches_cpu(cuda_device):
    """The K_CMB <-> W factor through the atmosphere: the host's float64
    elevation table of dP/dT_CMB interpolated on the card at 2,000
    elevations, against the same interpolation on the CPU and the host's
    float64 evaluation, within 1e-6 relative; and TOD.to's factor of a
    K_b field on the card against the CPU's."""
    from maria_torch.band import get_band
    from maria_torch.calibration import Calibration
    from maria_torch.spectrum import AtmosphericSpectrum

    spectrum, band = AtmosphericSpectrum("chajnantor"), get_band("act/pa5/f150")
    el = np.radians(np.linspace(20.0, 85.0, 2000))
    kw = dict(band=band, spectrum=spectrum, zenith_pwv=1.0, base_temperature=270.0)
    host = Calibration("K_CMB -> pW", elevation=el, **kw)(1.0)
    el32 = torch.as_tensor(el, dtype=torch.float32)
    cpu = Calibration("K_CMB -> pW", elevation=el32, **kw)(1.0)
    card = Calibration("K_CMB -> pW", elevation=el32.to(cuda_device), **kw)(1.0)
    assert card.device.type == cuda_device.type and card.dtype == torch.float32
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=1e-6)
    np.testing.assert_allclose(card.double().cpu().numpy(), host, rtol=1e-6)
    T_b = 3.0 + 0.1 * torch.randn((4, 2000), generator=torch.Generator().manual_seed(0))
    to_pw = Calibration("K_b -> pW", **kw)
    cpu_p = to_pw(T_b, elevation=el32.expand(4, -1))
    card_p = to_pw(T_b.to(cuda_device), elevation=el32.expand(4, -1).to(cuda_device))
    np.testing.assert_allclose(card_p.cpu().numpy(), cpu_p.numpy(), rtol=1e-6)


# -- the streaming slice: KC, the chunked AR extrusion, a streamed run --------------------------------------------


def _cascade_float64(w, state, p, a):
    """The cascade's recurrence in float64 on the host."""
    x = state.astype(np.float64).copy()
    out = np.empty(w.shape)
    p64, a64 = p.astype(np.float64), a.astype(np.float64)
    for t in range(w.shape[1]):
        x = p64 * x + w[:, t:t + 1]
        out[:, t] = x @ a64
    return out, x


def _cascade_inputs(device, rows, n, K, tables):
    """(w, state, p, a, row_table) tensors and the numpy arrays behind them:
    at K = 14 real cascades' poles and amplitudes, else log-spaced poles."""
    from maria_torch.noise.streaming import _fit_cascade

    rng = np.random.default_rng(rows + n + K)
    p = np.stack([np.exp(-2 * np.pi * np.geomspace(1e-5, 20.0, K) / 50.0)] * tables).astype(np.float32)
    a = (rng.standard_normal((tables, K)) * 0.3).astype(np.float32)
    if K == 14:
        fits = [_fit_cascade(50.0, knee, 1.0, 4096.0, 2.0) for knee in np.geomspace(0.05, 2.0, tables)]
        p, a = np.stack([f[0] for f in fits]), np.stack([f[1] for f in fits])
    table = rng.integers(0, tables, rows).astype(np.int32)
    w = rng.standard_normal((rows, n)).astype(np.float32)
    s0 = rng.standard_normal((rows, K)).astype(np.float32)
    args = [torch.as_tensor(x, device=device) for x in (w, s0, p, a)]
    tab = torch.as_tensor(table, device=device) if tables > 1 else None
    return args, tab, (w, s0, p, a, table)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,K,tables", [(1, 1, 3, 1), (37, 95, 3, 1), (130, 640, 14, 9), (65, 1000, 17, 2),
                                             (222, 3136, 14, 1), (7, 33, 32, 3), (222, 320, 14, 1),
                                             (5, 40000, 14, 1), (12671, 1000, 14, 9), (12672, 1000, 14, 9)])
def test_pink_cascade_kernel_matches_plain(cuda_device, rows, n, K, tables):
    """KC against its plain version (the Toeplitz form) and a float64
    recurrence: odd row counts, K = 3..32 (the kernel's three register
    counts), n not a multiple of the tile or of four, several tables a
    launch; slice (u)'s and (v)'s blocks (222 x 3,136 and 222 x 320: G 128
    and 64), 65 x 1,000 (G 128 at K 17), 5 x 40,000 (eight warps a row,
    five chunks through the ring) and both sides of the split's boundary
    (12,671 rows: a warp a row; 12,672: a thread a row)."""
    from maria_torch.ops.pink_cascade import pink_cascade, pink_cascade_plain

    args, tab, (w, s0, p, a, table) = _cascade_inputs(cuda_device, rows, n, K, tables)
    before = pink_cascade.launches
    pink, state = pink_cascade(*args, tab)
    assert pink_cascade.launches == before + (cuda_device.type == "cuda")
    plain, plain_state = pink_cascade_plain(*args, tab)
    ref = np.empty((rows, n))
    ref_state = np.empty((rows, K))
    for t in range(tables):
        m = table == t if tables > 1 else np.ones(rows, bool)
        ref[m], ref_state[m] = _cascade_float64(w[m], s0[m], p[t], a[t])
    scale = max(float(ref.std()), 1e-6)
    err = float(np.abs(pink.cpu().numpy() - ref).max())
    err_plain = float(np.abs(plain.cpu().numpy() - ref).max())
    assert err <= max(1e-4 * scale, 2 * err_plain), (err, err_plain, scale)
    np.testing.assert_allclose(state.cpu().numpy(), ref_state, rtol=1e-4, atol=1e-4 * np.abs(ref_state).max())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,tables", [(222, 3136, 1), (5, 40000, 1), (12671, 1000, 9), (12672, 1000, 9)])
def test_pink_cascade_kernel_repeats_bit_for_bit(cuda_device, rows, n, tables):
    """Two launches on the same inputs give the same bits (no atomics; the
    order of every sum is fixed by the shape), in every form of the split."""
    from maria_torch.ops.pink_cascade import pink_cascade

    args, tab, _ = _cascade_inputs(cuda_device, rows, n, 14, tables)
    pink_a, state_a = pink_cascade(*args, tab)
    pink_b, state_b = pink_cascade(*args, tab)
    assert torch.equal(pink_a, pink_b) and torch.equal(state_a, state_b)


@pytest.mark.cuda
def test_streamed_ar_chunks_on_card(cuda_device):
    """The chunked AR extrusion on the card: the chunks concatenate into
    one long extrusion on the same innovations, bit for bit, and match the
    CPU's chunks."""
    from maria_torch.atmosphere.streaming import StreamingExtrusion

    x, z = np.meshgrid(np.linspace(0, 200, 24), np.linspace(0, 60, 4))
    proc = AutoregressiveProcess(np.c_[x.ravel(), z.ravel()], np.arange(0, 300, 10.0),
                                 callback_kwargs={"nu": 1 / 3, "r0": 100.0})
    stream = StreamingExtrusion(proc, chunk_rows=17, device=cuda_device)
    g = torch.Generator(device=cuda_device)
    g.manual_seed(5)
    state = stream.initial_state(g)
    noise = torch.randn((4 * 17, proc.n_cross_section), generator=g, device=cuda_device)
    chunks, s = [], state
    for c in range(4):
        s, chunk = stream.step(s, noise[c * 17:(c + 1) * 17])
        chunks.append(chunk)
    long = torch.cat([torch.zeros((4 * 17, proc.n_cross_section), device=cuda_device), state])
    (one,) = ar_extrude([proc], [long], [noise], steps=[4 * 17], rows=4 * 17)
    torch.testing.assert_close(torch.cat(chunks), one.flip(0), rtol=0, atol=0)
    cpu = StreamingExtrusion(proc, chunk_rows=17, device="cpu")
    s_cpu, chunk_cpu = cpu.step(state.cpu(), noise[:17].cpu())
    np.testing.assert_allclose(chunks[0].cpu().numpy(), chunk_cpu.numpy(), atol=1e-4 * float(chunk_cpu.std()))


@pytest.mark.cuda
def test_streamed_run_on_card_matches_cpu(cuda_device):
    """A small streamed run on the card against the same run on the CPU
    (the same draws: the CPU's state and block normals handed over): TOD
    blocks, map and hits; KC and K2 each launch once a block."""
    import maria_torch
    from maria_torch.ops.bin_map import bin_map as k2
    from maria_torch.ops.pink_cascade import pink_cascade
    from maria_torch.ops.program import build_tod_program
    from maria_torch.ops.streaming_exec import StreamingExecutor

    plan = maria_torch.get_plan("daisy_5arcmin_60s", start_time=1.75e9, scan_center=(150.0, 41.0), frame="az/el",
                                duration=20.0, sample_rate=50.0)
    out = {}
    for dev in ("cpu", cuda_device):
        sim = maria_torch.Simulation(instrument="MUSTANG-2", plans=plan, site="GBT", atmosphere="2d", noise=True,
                                     seed=0, device=dev)
        program = build_tod_program(sim.obs_list[0], noise_kwargs=sim.noise_kwargs, device=dev)
        out[str(dev)] = StreamingExecutor(program, sim.obs_list[0], block_tc=16, device=dev)
    ex_cpu, ex = out["cpu"], out[str(cuda_device)]
    state_cpu = ex_cpu.init_state(3)
    gen = torch.Generator()
    gen.manual_seed(9)
    blocks = [[m.draw(len(b.det_index), ex.B, gen) for b, m in zip(ex.program.bands, ex.noise_models)]
              for _ in range(ex.n_blocks)]
    state = {k: ([tuple(x.to(cuda_device) for x in s) for s in v] if k == "noise" else
                 [x.to(cuda_device) for x in v] if isinstance(v, list) else
                 v.to(cuda_device) if isinstance(v, torch.Tensor) else v) for k, v in state_cpu.items()}
    before = (pink_cascade.launches, k2.launches)
    res = ex.run(3, state=state, draws={"blocks": blocks})
    assert (pink_cascade.launches - before[0], k2.launches - before[1]) == (ex.n_blocks, ex.n_blocks)
    ref = ex_cpu.run(3, state=state_cpu, draws={"blocks": blocks})
    # the card's pointing differs from the CPU's by float32 ulps, so a few
    # samples on a pixel's edge land in its neighbour
    assert res.map_wgt.sum() == ref.map_wgt.sum() == ex.n_det * ex.n_t
    assert np.abs(res.map_wgt - ref.map_wgt).sum() <= 1e-2 * ref.map_wgt.sum()
    np.testing.assert_allclose(res.map_sum.sum(), ref.map_sum.sum(), rtol=1e-5)
    tod = torch.cat([t.cpu() for _, t in ex.tod_blocks(3, state=state, draws={"blocks": blocks})], dim=-1)
    tod_cpu = torch.cat([t for _, t in ex_cpu.tod_blocks(3, state=state_cpu, draws={"blocks": blocks})], dim=-1)
    assert float((tod - tod_cpu).abs().max()) <= 1e-5 * float(tod_cpu.std())


@pytest.mark.cuda
def test_streamed_block_under_inference_mode_on_card(cuda_device):
    """Slice (u)'s block (MUSTANG-2, 600 s at 50 Hz, block_tc 64: 222 cascade rows x
    3,136, KC's split G 128) with a fresh cascade and no cached tables,
    inside torch.inference_mode (whose tensors track no version): it runs,
    and its TOD and state equal the same block's outside bit for bit, but
    the map's sums, which K2's float atomics add in any order (1e-6 of
    their maximum)."""
    import maria_torch
    from maria_torch.ops import pink_cascade as kc
    from maria_torch.ops.program import build_tod_program
    from maria_torch.ops.streaming_exec import StreamingExecutor

    plan = maria_torch.get_plan("daisy_5arcmin_60s", start_time=1.75e9, scan_center=(150.0, 41.0), frame="az/el",
                                duration=600.0, sample_rate=50.0)
    sim = maria_torch.Simulation(instrument="MUSTANG-2", plans=plan, site="GBT", atmosphere="2d", noise=True, seed=0,
                                 device=cuda_device)
    program = build_tod_program(sim.obs_list[0], noise_kwargs=sim.noise_kwargs, device=cuda_device)

    def block():
        kc._SPLIT_TABLES.clear()
        ex = StreamingExecutor(program, sim.obs_list[0], block_tc=64, device=cuda_device)
        assert kc.cascade_plan(ex._casc_rows["n"], ex.B)[0] == 128
        return ex.block(ex.init_state(3), 1)

    (state_out, tod_out) = block()
    with torch.inference_mode():
        before = kc.pink_cascade.launches
        (state_in, tod_in) = block()
        assert kc.pink_cascade.launches == before + 1
    assert torch.equal(tod_out, tod_in)
    for key in state_out:
        if key == "map_sum":  # K2's float atomics add a pixel's samples in any order
            torch.testing.assert_close(state_in[key], state_out[key], rtol=0,
                                       atol=1e-6 * float(state_out[key].abs().max()))
            continue
        flat_out, flat_in = (torch.utils._pytree.tree_flatten(x)[0] for x in (state_out[key], state_in[key]))
        assert len(flat_out) == len(flat_in)
        assert all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b for a, b in zip(flat_out, flat_in)), key


@pytest.mark.cuda
@pytest.mark.parametrize("slab_rows", [8192, 64], ids=["one-slab", "slabs"])
@pytest.mark.parametrize("frame", ["az/el", "ra/dec"])
@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded"])
def test_streamed_pixel_ids_equal_the_plain_chain(cuda_device, frame, padded, slab_rows, monkeypatch):
    """The streamed ids on the card, through the pixel-id kernel, are
    ``pixel_ids_plain`` on the same CUDA tensors (the block's slice of the
    device tracks, q's rotation in ra/dec) bit for bit, -1 on the samples
    past n_t of the last block and on the rows ``pad_detectors`` adds; one
    launch a slab of PIXEL_ROWS rows (also at 64 rows, so that the 217 or
    220 rows take four slabs, the last one short)."""
    import maria_torch
    from maria_torch.ops import streaming_exec
    from maria_torch.ops.pixel_ids import pixel_ids, pixel_ids_plain
    from maria_torch.ops.program import build_tod_program

    monkeypatch.setattr(streaming_exec, "PIXEL_ROWS", slab_rows)
    plan = maria_torch.get_plan("daisy_5arcmin_60s", start_time=1.75e9, scan_center=(150.0, 41.0), frame="az/el",
                                duration=30.0, sample_rate=50.0)
    sim = maria_torch.Simulation(instrument="MUSTANG-2", plans=plan, site="GBT", atmosphere="2d", noise=True, seed=0,
                                 device=cuda_device)
    p = build_tod_program(sim.obs_list[0], noise_kwargs=sim.noise_kwargs, device=cuda_device)
    if padded:
        assert p.pad_detectors(4) == 3 and p.n_real_det == 217
    ex = streaming_exec.StreamingExecutor(p, sim.obs_list[0], block_tc=16, frame=frame, device=cuda_device)
    assert ex.n_blocks >= 2 and ex.n_blocks * ex.B > ex.n_t
    tr = ex._device_tracks()
    tracks = ("ra", "dec", "cq", "sq") if frame == "ra/dec" else ("az", "el")
    offsets = p._tensors(cuda_device)["offsets"]
    real = torch.arange(p.n_det, device=cuda_device) < 217
    for b in range(ex.n_blocks):
        sl = slice(b * ex.B, (b + 1) * ex.B)
        phi, theta, *cq_sq = (tr[k][sl] for k in tracks)
        ref = pixel_ids_plain(offsets, phi, theta, ex.center, ex.res, ex.n_x, ex.n_y, *cq_sq)
        live = b * ex.B + torch.arange(ex.B, device=cuda_device) < ex.n_t
        before = pixel_ids.launches
        ids = ex.pixel_ids(b)
        torch.cuda.synchronize()
        assert pixel_ids.launches - before == -(-p.n_det // slab_rows)
        assert ids.device.type == "cuda" and ids.dtype == torch.int32 and ids.shape == (p.n_det, ex.B)
        expected = torch.where(live & real[:, None], ref, -1)
        differ = (ids != expected).nonzero()
        assert torch.equal(ids, expected), f"block {b}: {len(differ)} ids differ, first at {differ[:4].tolist()}"
        assert bool((ids[~real] == -1).all()) and bool((ids[:, ~live] == -1).all())
    assert bool((ids[real][:, live] >= 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["matmul_total", "fields_total"])
def test_same_seed_forwards_bit_equal_under_autograd(cuda_device, route):
    """MUSTANG-2 over 10 s with noise: the matrix product's route (V from
    K3) and, with NEP_per_loading, the fields route (K1). Two forwards on
    one seed, one without a gradient and one with the offsets requiring
    it, are bit-equal, each launching its kernel; the backward is finite."""
    from maria_torch.ops.pink_noise import pink_noise
    from maria_torch.ops.shared_v import shared_v
    from maria_torch.scenes import simulation

    program = simulation("mustang2", 10.0, cuda_device).program()
    band = program.bands[0]
    band.NEP_per_loading = band.NEP / 3e-12 if route == "fields_total" else 0.0
    try:
        fn = program.total_power_fn()
        assert fn.__name__ == route
        kernel = shared_v if route == "matmul_total" else pink_noise
        seed, offsets, bs_az, bs_el = program.example_args(6, device=cuda_device)
        before = kernel.launches
        with torch.no_grad():
            plain = fn(seed=seed, device=cuda_device)
        offsets.requires_grad_(True)
        total = fn(seed=seed, offsets=offsets, bs_az=bs_az, bs_el=bs_el, device=cuda_device)
        per_forward = 1 if route == "matmul_total" else 2  # K1: the band's rows and its correlated modes
        assert kernel.launches == before + 2 * per_forward
        assert torch.equal(total.detach(), plain)
        total.square().mean().backward()
    finally:
        band.NEP_per_loading = 0.0
    assert bool(torch.isfinite(offsets.grad).all()) and float(offsets.grad.abs().max()) > 0


@pytest.mark.cuda
def test_backward_on_card_matches_central_difference(cuda_device):
    """MUSTANG-2 over 10 s with noise on the card: the directional
    derivative of the mean square mismatch (summed in float64) against the
    observed TOD of the true offsets, at 0.3 arcmin rms from them, within
    10% of its central difference (the step as chip_smoke's phase (z2))."""
    from maria_torch.scenes import simulation

    program = simulation("mustang2", 10.0, cuda_device).program()
    fn = program.total_power_fn()
    seed, offsets, _, _ = program.example_args(7, device=cuda_device)
    with torch.no_grad():
        observed = fn(seed=seed, device=cuda_device)

    def loss(x):
        d = fn(seed=seed, offsets=x, device=cuda_device) - observed
        return d.square().sum(dtype=torch.float64) / d.numel()

    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = offsets + float(np.radians(0.3 / 60)) * torch.randn(offsets.shape, generator=g, device=cuda_device)
    v = torch.randn(offsets.shape, generator=g, device=cuda_device)
    v = v / v.norm()
    xr = x.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(loss(xr), xr)
    analytic = float((grad.double() * v.double()).sum())
    eps = 3 * 2e-5 * float(np.sqrt(x.numel() / 240))
    with torch.no_grad():
        xp, xm = x + eps * v, x - eps * v
        fd = (float(loss(xp)) - float(loss(xm))) / float(((xp.double() - xm.double()) * v.double()).sum())
    assert bool(torch.isfinite(grad).all())
    assert abs(analytic - fd) <= 0.1 * max(abs(analytic), abs(fd)), (analytic, fd)


# -- the device functions of the last names ported (chip_smoke phase (aa)) ----------------------


# of the values' scale: twice the largest difference read on an H100 (1.24e-6), about the 2-ulp
# bound worked out in the test
RGI_CARD_BOUND = 2.5e-6


@pytest.mark.cuda
def test_device_functions_on_card_match_cpu(cuda_device):
    """MaternInterpolator, RegularGridInterpolator, pointing_indices_and_weights
    and Band.atmosphere_power compute on the card's tensors and agree with
    the CPU: the Matérn, the bilinear weights and the loading within 1e-6
    of the scale, the 3-D interpolation with a log axis within
    RGI_CARD_BOUND, the pixel ids exact."""
    import maria_torch
    from maria_torch.functions import MaternInterpolator
    from maria_torch.ops.interp import RegularGridInterpolator
    from maria_torch.spectrum import AtmosphericSpectrum
    from maria_torch.utils.linalg import pointing_indices_and_weights

    rng = np.random.default_rng(0)
    r = torch.as_tensor(rng.uniform(0, 3000, 20000), dtype=torch.float32)
    interp = MaternInterpolator(nu=1 / 3, r0=1000.0)
    on_card = interp(r.to(cuda_device))
    assert on_card.device.type == "cuda"
    assert float((on_card.cpu() - interp(r)).abs().max()) <= 1e-6

    points = (np.linspace(260, 300, 5), np.geomspace(0.05, 100, 24), np.linspace(0.1, 1.57, 14))
    rgi = RegularGridInterpolator(points, rng.uniform(1, 5, (5, 24, 14)))
    xi = [torch.as_tensor(x, dtype=torch.float32) for x in
          (rng.uniform(255, 305, 5000), np.exp(rng.uniform(-3, 4.6, 5000)), rng.uniform(0, 1.7, 5000))]
    # the card's and the CPU's float32 log differ by up to ~2 ulp (9.5e-7 at |log x| < 8), which moves a
    # sample along the log axis by 2.9e-6 of a cell: up to 1.2e-5 between neighbours 4 apart, 2.3e-6 of
    # the values' scale of 5; printed so that a run shows the reading
    rgi_err = float((rgi([x.to(cuda_device) for x in xi]).cpu() - rgi(xi)).abs().max()) / 5
    print(f"RegularGridInterpolator card against CPU: {rgi_err:.3e} of the values' scale")
    assert rgi_err <= RGI_CARD_BOUND, rgi_err

    side = np.linspace(-1, 1, 64)
    xs = [torch.as_tensor(rng.uniform(-1.1, 1.1, (300, 700)), dtype=torch.float32) for _ in range(2)]
    ids, w, _ = pointing_indices_and_weights([x.to(cuda_device) for x in xs], [side, side])
    ids_cpu, w_cpu, _ = pointing_indices_and_weights(xs, [side, side])
    assert torch.equal(ids.cpu(), ids_cpu) and float((w.cpu() - w_cpu).abs().max()) <= 1e-6

    spectrum = AtmosphericSpectrum("chajnantor")
    band = maria_torch.get_band("atlast/f150")
    pwv = torch.as_tensor(np.exp(rng.uniform(-2, 2.5, 4000)), dtype=torch.float32)
    el = torch.as_tensor(rng.uniform(0.3, 1.5, 4000), dtype=torch.float32)
    p = band.atmosphere_power(spectrum, 270.0, pwv.to(cuda_device), el.to(cuda_device))
    p_cpu = band.atmosphere_power(spectrum, 270.0, pwv, el)
    assert p.device.type == "cuda" and float((p.cpu() - p_cpu).abs().max()) <= 1e-6 * float(p_cpu.abs().max())


@pytest.mark.cuda
def test_2d_fourier_noise_on_card(cuda_device):
    """generate_2d_fourier_noise draws on the generator's card: a
    standardized field whose PSD slope is -(beta + 1) within 5%."""
    from maria_torch.noise import generate_2d_fourier_noise

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    F = generate_2d_fourier_noise(1024, 1024, beta=8 / 3, generator=gen)
    assert F.device.type == "cuda" and abs(float(F.mean())) < 1e-4
    P = (torch.fft.fft2(F.double()).abs() ** 2).flatten()
    k = torch.fft.fftfreq(1024, 1 / 1024, device=cuda_device, dtype=torch.float64)
    kb = torch.round(torch.sqrt(k[:, None] ** 2 + k[None, :] ** 2)).long().flatten()
    psd = (torch.bincount(kb, P)[8:409] / torch.bincount(kb)[8:409]).cpu().numpy()
    slope = np.polyfit(np.log(np.sqrt(25 + np.arange(8, 409.0) ** 2)), np.log(psd), 1)[0]
    assert abs(slope + 8 / 3 + 1) <= 0.05 * (8 / 3 + 1)


# -- the line-of-sight layer sampler (csrc/los_sample.cu) ---------------------------------------

_LOS_PROGRAMS = {}


def _los_program(scene, method, device, duration=60.0):
    """The program of ``scenes.simulation(scene, duration, method=)`` on
    the card, built once for the module."""
    from maria_torch.scenes import simulation

    key = (scene, method, duration)
    if key not in _LOS_PROGRAMS:
        _LOS_PROGRAMS[key] = simulation(scene, duration, device, method=method).program()
    return _LOS_PROGRAMS[key]


def _los_inputs(program, device, seed=3):
    """(mean, layers, px, py, t_c) of one realization of ``program``, as
    ``fields()`` hands them to ``accumulate_pwv``."""
    from maria_torch.atmosphere.sampling import synthesize_layers
    from maria_torch.ops.program import ar_screen_values, line_of_sight

    tabs = program._tensors(device, None)
    _, _, px, py = line_of_sight(*program._pointing(tabs, device, None, None, None, None))
    gen = torch.Generator(device=device).manual_seed(seed)
    ar_values = ar_screen_values(program.screens, gen, None, device, plan=tabs["ar_plan"])
    layers = synthesize_layers(program.screens, device, W=tabs["W"], generator=gen, groups=program.groups,
                               group_tables=tabs["groups"], ar_values=ar_values, blur=tabs["blur"])
    return program.mean_pwv, layers, px, py, tabs["t_c"]


def _los_bit_equal(mean, layers, px, py, t, launches=1):
    from maria_torch.ops.los_sample import los_sample, los_sample_plain

    before = los_sample.launches
    ours = los_sample(mean, layers, px, py, t)
    ref = los_sample_plain(mean, layers, px, py, t)
    torch.cuda.synchronize()
    assert los_sample.launches == before + launches
    assert ours.shape == ref.shape and bool(torch.isfinite(ours).all())
    assert torch.equal(ours, ref), float((ours - ref).abs().max())
    return ours


@pytest.mark.cuda
@pytest.mark.parametrize("scene,method", [("atlast", "fourier"), ("mustang2", "fourier"), ("atlast", "ar")])
def test_los_sample_kernel_bit_equal_to_plain(cuda_device, scene, method):
    """The kernel against the plain path on the same card, bit for bit:
    the AtLAST-50k 60 s 3-D group (one group of 12 layers: the 3-D model
    is one process; 50,004 x 600), MUSTANG-2's 2-D Fourier screens, and
    the AtLAST 3-D AR screens, whose cross spacing ty_res differs from res
    and whose values are blurred."""
    program = _los_program(scene, method, cuda_device)
    mean, layers, px, py, t = _los_inputs(program, cuda_device)
    if scene == "atlast" and method == "fourier":
        assert (len(program.groups), len(layers), tuple(px.shape)) == (1, 12, (50004, 600))
    if method == "ar":
        assert all(s.ty_res != s.res and s.beam_sigma > 0 for s in program.screens)
    if scene == "mustang2":
        assert program.screens and all(s.W is not None for s in program.screens)
    _los_bit_equal(mean, layers, px, py, t)


@pytest.mark.cuda
def test_los_sample_kernel_off_grid_on_the_last_edge_and_in_chunks(cuda_device):
    """An empty table and points off every grid take the mean alone;
    points exactly on a grid's last cell edge (fx = nx - 1, fy = ny - 1)
    sample it; a table longer than one launch takes is sampled in launches
    that add to what the one before stored, bit-equal to the plain path,
    forward and backward."""
    from maria_torch.ops.los_sample import Layer, max_layers

    rng = np.random.default_rng(0)
    ny, nx, n_det, n_tc = 40, 64, 37, 300
    n_grids = max_layers() + 7
    grids = torch.as_tensor(rng.standard_normal((n_grids, ny, nx)), dtype=torch.float32, device=cuda_device)
    px = rng.uniform(-8.0, nx + 8.0, (n_det, n_tc))
    py = rng.uniform(-8.0, ny + 8.0, (n_det, n_tc))
    px[:5, :50], py[:5, :50] = nx - 1, rng.uniform(0, ny - 1, (5, 50))
    px[5:10, :50], py[5:10, :50] = rng.uniform(0, nx - 1, (5, 50)), ny - 1
    px[10, :50], py[10, :50] = nx - 1, ny - 1
    px[11, :50], py[11, :50] = 0.0, 0.0
    px, py = (torch.as_tensor(a, dtype=torch.float32, device=cuda_device) for a in (px, py))
    t = torch.linspace(0.0, 30.0, n_tc, device=cuda_device)
    # h 1, angle 0, no wind, unit cells at the origin: fx = px and fy = py exactly
    edge = Layer(grids[0], 1.0, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.5)
    assert bool((_los_bit_equal(1.25, [], px, py, t) == np.float32(1.25)).all())  # an empty table: the mean
    pwv = _los_bit_equal(1.25, [edge], px, py, t)
    off = (px < 0) | (px > nx - 1) | (py < 0) | (py > ny - 1)
    assert bool(off.any()) and bool((pwv[off] == np.float32(1.25)).all())
    assert bool((pwv[:12, :50] != np.float32(1.25)).all())
    layers = [edge] + [
        Layer(grids[k], float(rng.uniform(0.5, 2.0)), float(rng.uniform(-np.pi, np.pi)), float(rng.uniform(-1, 1)),
              float(rng.uniform(-1, 1)), float(rng.uniform(0.7, 1.3)), float(rng.uniform(0.7, 1.3)),
              float(rng.uniform(-20, 0)), float(rng.uniform(-20, 0)), float(rng.uniform(0.01, 0.1)))
        for k in range(1, n_grids)
    ]
    _los_bit_equal(1.25, layers, px, py, t, launches=2)
    # forward and backward, as the emulation of the kernel's arithmetic
    # (tests/test_torch_los_sample.py) computes them, bit for bit
    from test_torch_los_sample import emulate, emulate_backward

    from maria_torch.ops.los_sample import los_sample

    cpu_layers = [L._replace(values=L.values.cpu()) for L in layers]
    g = torch.as_tensor(rng.standard_normal((n_det, n_tc)), dtype=torch.float32, device=cuda_device)
    for n in (6, n_grids):
        a, b = px.clone().requires_grad_(True), py.clone().requires_grad_(True)
        out = los_sample(1.25, layers[:n], a, b, t)
        ga, gb = torch.autograd.grad(out, (a, b), g)
        pwv = emulate(1.25, cpu_layers[:n], px.cpu(), py.cpu(), t.cpu(), divide=False)
        gx, gy = emulate_backward(cpu_layers[:n], px.cpu(), py.cpu(), t.cpu(), g.cpu(), divide=False)
        for ours, ref in ((out.detach(), pwv), (ga, gx), (gb, gy)):
            assert np.array_equal(ours.cpu().numpy(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["fourier", "ar"])
def test_los_sample_backward_matches_plain_autograd(cuda_device, method):
    """MUSTANG-2's screens (Fourier, and AR blurred, whose smooth taps
    cancel): the kernel's route under autograd gives the forward of a
    launch without it bit for bit, and its backward (one launch) the
    gradients of sum(w * pwv) in px and py that the plain path's autograd
    gives on the same inputs: bit for bit, cell edges included, so within
    1e-6 relative L2."""
    from maria_torch.ops.los_sample import los_sample, los_sample_plain

    program = _los_program("mustang2", method, cuda_device)
    mean, layers, px, py, t = _los_inputs(program, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    w = torch.randn(px.shape, generator=g, device=cuda_device)
    with torch.no_grad():
        plain_forward = los_sample(mean, layers, px, py, t)
    grads = {}
    for name, fn in (("kernel", los_sample), ("plain", los_sample_plain)):
        a, b = px.clone().requires_grad_(True), py.clone().requires_grad_(True)
        before = los_sample.launches
        out = fn(mean, layers, a, b, t)
        if name == "kernel":
            assert torch.equal(out.detach(), plain_forward)
        grads[name] = torch.autograd.grad((w * out).sum(), (a, b))
        assert los_sample.launches == before + 2 * (name == "kernel")
    for ours, ref in zip(grads["kernel"], grads["plain"]):
        assert float(ref.abs().max()) > 0
        rel = float((ours.double() - ref.double()).norm() / ref.double().norm())
        assert rel <= 1e-6, rel
        assert torch.equal(ours, ref), rel


@pytest.mark.cuda
def test_los_sample_refuses_a_grid_or_t_that_requires_a_gradient(cuda_device):
    from maria_torch.ops.los_sample import Layer, los_sample

    grid = torch.zeros((4, 6), device=cuda_device)
    px = torch.zeros((3, 5), device=cuda_device)
    layer = Layer(grid.clone().requires_grad_(True), 1.0, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.1)
    with pytest.raises(ValueError, match="requires a gradient"):
        los_sample(1.0, [layer], px, px, torch.zeros(5, device=cuda_device))
    with pytest.raises(ValueError, match="requires a gradient"):
        los_sample(1.0, [layer._replace(values=grid)], px, px, torch.zeros(5, device=cuda_device, requires_grad=True))


@pytest.mark.cuda
@pytest.mark.parametrize("scene,method", [("mustang2", "fourier"), ("atlast", "fourier")])
def test_fields_launches_los_sample_once(cuda_device, scene, method, monkeypatch):
    """One fields() call samples every layer in one launch, and never
    through the plain path."""
    import maria_torch.ops.los_sample as los

    def plain(*args):
        raise AssertionError("the card's sampler fell back to the plain path")

    program = _los_program(scene, method, cuda_device)
    before = los.los_sample.launches
    monkeypatch.setattr(los, "los_sample_plain", plain)
    fields, _ = program.fields(seed=11, device=cuda_device)
    torch.cuda.synchronize()
    assert los.los_sample.launches == before + 1
    assert bool(torch.isfinite(fields["atmosphere"]).all())


# -- the band tables (csrc/band_tables.cu) ----------------------------------------------------------

_ACT_PROGRAMS = {}


def _act_program(device, duration=600.0):
    """The ACT camera's program at ``duration`` s (9,000 x 20 Hz samples)
    with its 2-D atmosphere and a CMB at nside 64, built once."""
    from maria_torch.scenes import act_simulation

    if duration not in _ACT_PROGRAMS:
        _ACT_PROGRAMS[duration] = act_simulation(duration, device, cmb_kwargs={"nside": 64}).program()
    return _ACT_PROGRAMS[duration]


def _stage_inputs(program, device, stage, seed=7):
    """(tables, pwv, el, mueller_I) of a program's stage ("power": the
    coarse loading, "cmb": the fine CMB stage) for one realization."""
    coarse = program.fields(seed=seed, device=device, upto="coarse")
    pwv, el = coarse["pwv_c"], coarse["el_c"]
    if stage == "cmb":
        pwv, el = program._upsample(pwv, "linear"), program._upsample(el, "cubic")
    tabs = program._tensors(device)
    return tabs[stage], pwv, el, tabs["mueller_I"]


def _band_tables_bit_equal(tables, pwv, el, mueller_I, launches=1):
    from maria_torch.ops.band_tables import band_tables, band_tables_plain

    before = band_tables.launches
    ours = band_tables(tables, pwv, el, mueller_I)
    ref = band_tables_plain(tables, pwv, el, mueller_I)
    torch.cuda.synchronize()
    assert band_tables.launches == before + launches
    assert ours.shape == ref.shape == (tables.n_rows, pwv.shape[1])
    differ = (ours != ref) & ~(ours.isnan() & ref.isnan())
    assert not bool(differ.any()), (f"{int(differ.sum())} of {ours.numel()} values differ, first at "
                                    f"{differ.nonzero()[:4].tolist()}, max |diff| {float((ours - ref).abs().max())}")
    return ours


@pytest.mark.cuda
@pytest.mark.parametrize("scene,stage", [("act", "cmb"), ("act", "power"), ("atlast", "power")])
def test_band_tables_kernel_bit_equal_to_plain(cuda_device, scene, stage):
    """The kernel against the plain version on the same card, bit for bit,
    one launch a stage: the ACT cell's CMB stage (six bands of 1,500 x
    12,000 fine samples) and loading (9,000 x 6,000 coarse), and AtLAST-50k's
    loading (nine bands, 50,004 x 600), on a realization's pwv and
    elevation."""
    program = _act_program(cuda_device) if scene == "act" else _los_program("atlast", "fourier", cuda_device)
    tables, pwv, el, mueller_I = _stage_inputs(program, cuda_device, stage)
    if scene == "act":
        assert len(tables.bands) == 6 and {len(b.rows) for b in tables.bands} == {1500}
        assert pwv.shape == ((9000, 12000) if stage == "cmb" else (9000, 6000))
    else:
        assert len(tables.bands) == 9 and pwv.shape == (50004, 600)
    assert tables.n_tables == (2 if stage == "cmb" else 1) and all(isinstance(r, slice) for r in tables.rows)
    out = _band_tables_bit_equal(tables, pwv, el, mueller_I)
    assert bool(torch.isfinite(out).all()) and float(out.abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_t", [1, 7, 53, 64, 4099])
@pytest.mark.parametrize("two", [False, True], ids=["one", "two"])
def test_band_tables_kernel_axes_odd_lengths_and_index_rows(cuda_device, n_t, two):
    """tests/test_torch_band_tables.py's bands on the card (uniform, log
    and general axes; runs and interleaved index rows; with two tables a
    band without tables, and rows of no band): points on every grid point
    and past every edge, n_t off and on a multiple of four, rows 16-byte
    aligned (the vector path) and not (a view one sample in)."""
    import test_torch_band_tables as cpu

    from maria_torch.ops.band_tables import BandTables

    rng = np.random.default_rng(n_t)
    kinds = ("log", "uniform", "general")
    stages = cpu.synthetic_stages(kinds, two, rng, without_tables=two)
    stages = [s._replace(samples=None if s.samples is None else torch.as_tensor(
        rng.standard_normal((len(s.rows), n_t)), dtype=torch.float32, device=cuda_device)) for s in stages]
    n_rows = cpu.N_ROWS + 3  # three rows that no band holds
    pwv, el = (np.resize(a.numpy(), (n_rows, n_t)) for a in cpu.edge_points(rng, kinds))
    mueller_I = torch.as_tensor(rng.uniform(0.5, 1.0, n_rows), dtype=torch.float32, device=cuda_device)
    tables = BandTables(stages, n_rows, cuda_device)
    for shift in (0, 1):
        big = [torch.zeros((n_rows, n_t + 2), device=cuda_device) for _ in range(2)]
        for b, a in zip(big, (pwv, el)):
            b[:, shift:shift + n_t] = torch.as_tensor(a, dtype=torch.float32)
        x, y = (b[:, shift:shift + n_t] for b in big)
        out = _band_tables_bit_equal(tables, x, y, mueller_I)
        assert bool((out[cpu.N_ROWS:] == 0).all())
        if two:
            assert bool((out[30:] == 0).all())
        contiguous = _band_tables_bit_equal(tables, x.contiguous(), y.contiguous(), mueller_I)
        assert torch.equal(out, contiguous)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["cmb", "power"])
def test_band_tables_backward_equals_the_plain_chain(cuda_device, stage):
    """Where pwv and el require a gradient (the ACT camera at 60 s): the
    forward is one launch, bit-equal to a launch without autograd, and the
    gradients of sum(w * field) in pwv and el are the plain version's
    autograd bit for bit; el alone requiring one too. Through
    TODProgram.fields, the gradient in the detector offsets of both stages'
    fields is the plain version's within 1e-6 relative L2."""
    import maria_torch.ops.band_tables as bt

    program = _act_program(cuda_device, 60.0)
    tables, pwv, el, mueller_I = _stage_inputs(program, cuda_device, stage)
    w = torch.randn(pwv.shape, generator=torch.Generator(device=cuda_device).manual_seed(5), device=cuda_device)
    with torch.no_grad():
        forward = bt.band_tables(tables, pwv, el, mueller_I)
    grads = {}
    for name, fn in (("kernel", bt.band_tables), ("plain", bt.band_tables_plain)):
        x, y = pwv.clone().requires_grad_(True), el.clone().requires_grad_(True)
        before = bt.band_tables.launches
        out = fn(tables, x, y, mueller_I)
        assert bt.band_tables.launches == before + (name == "kernel")
        if name == "kernel":
            assert torch.equal(out.detach(), forward)
        grads[name] = torch.autograd.grad((w * out).sum(), (x, y))
    for ours, ref in zip(grads["kernel"], grads["plain"]):
        assert float(ref.abs().max()) > 0 and torch.equal(ours, ref)
    y = el.clone().requires_grad_(True)
    (g_el,) = torch.autograd.grad((w * bt.band_tables(tables, pwv, y, mueller_I)).sum(), y)
    assert torch.equal(g_el, grads["plain"][1])


@pytest.mark.cuda
def test_fields_gradient_through_the_band_tables(cuda_device, monkeypatch):
    """The gradient of sum(w_a * atmosphere + w_c * cmb) in the detector
    offsets through TODProgram.fields (the ACT camera at 60 s): the kernel's
    route against the plain version's, within 1e-6 relative L2."""
    import maria_torch.ops.band_tables as bt

    program = _act_program(cuda_device, 60.0)
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    w = torch.randn((2, program.n_det, program.n_t), generator=gen, device=cuda_device)
    grads = []
    for route in ("kernel", "plain"):
        if route == "plain":
            monkeypatch.setattr(bt, "_launch", bt.band_tables_plain)
        offsets = torch.as_tensor(program.offsets, device=cuda_device).requires_grad_(True)
        fields = program.fields(seed=4, device=cuda_device, upto="signal", offsets=offsets)
        loss = (w[0] * fields["atmosphere"]).sum() + (w[1] * fields["cmb"]).sum()
        grads.append(torch.autograd.grad(loss, offsets)[0].double())
    rel = float((grads[0] - grads[1]).norm() / grads[1].norm())
    assert float(grads[1].abs().max()) > 0 and rel <= 1e-6, rel


@pytest.mark.cuda
def test_band_tables_launches_as_wired(cuda_device, monkeypatch):
    """One launch a stage and never the plain version on the card: the
    ACT camera's run() launches it twice (loading and CMB), AtLAST-50k's
    total_power_fn() once (loading; no CMB), the CMB patch's run() never
    (no atmosphere: Simulation.run's path without the program)."""
    import maria_torch.ops.band_tables as bt
    from maria_torch.scenes import act_simulation, cmb_patch_simulation

    def plain(*args):
        raise AssertionError("the card's band tables fell back to the plain version")

    monkeypatch.setattr(bt, "band_tables_plain", plain)
    counts = {}
    for name, run in (
        ("act", lambda: act_simulation(10.0, cuda_device, cmb_kwargs={"nside": 64}).run()),
        ("atlast", lambda: _los_program("atlast", "fourier", cuda_device).total_power_fn()(seed=3, device=cuda_device)),
        ("cmb_patch", lambda: cmb_patch_simulation(10.0, cuda_device, cmb_kwargs={"nside": 64}, noise=False).run()),
    ):
        before = bt.band_tables.launches
        run()
        torch.cuda.synchronize()
        counts[name] = bt.band_tables.launches - before
    assert counts == {"act": 2, "atlast": 1, "cmb_patch": 0}
