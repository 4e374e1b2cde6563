"""The hand-written CUDA kernels against their plain torch versions, on
a card (marker ``cuda``; they skip without one). This file imports no
jax, so it runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from maria_torch.noise import band_half_spectrum  # noqa: E402
from maria_torch.ops.bin_map import bin_map, bin_map_plain  # noqa: E402
from maria_torch.ops.pink_noise import pink_noise, pink_noise_plain  # noqa: E402


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
@pytest.mark.parametrize("n_det,n,n_fft", [(217, 3000, 3072), (217, 30000, 32768), (5, 500, 512)])
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
def test_bin_map_kernel_matches_plain(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    ids = torch.randint(-1, 128 * 128, (217, 3000), generator=gen, device=cuda_device, dtype=torch.int32)
    data = torch.randn((217, 3000), generator=gen, device=cuda_device)
    channels = torch.stack([data, torch.ones_like(data)]).contiguous()
    before = bin_map.launches
    out = bin_map(channels, ids, 128 * 128)
    ref = bin_map_plain(channels, ids, 128 * 128)
    torch.cuda.synchronize()
    assert bin_map.launches == before + 1
    assert torch.equal(out[1], ref[1])
    assert float((out[0] - ref[0]).abs().max()) <= 1e-5 * float(ref[0].abs().max())


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
