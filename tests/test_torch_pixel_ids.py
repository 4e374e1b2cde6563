"""The mappers' pixel ids (``maria_torch/ops/pixel_ids.py``) on the CPU:
the wrapper runs the plain chain there and launches nothing, the frame
ids equal the chain the port ran before the kernel (``det_radec`` or
``det_azel``, ``phi_theta_to_offsets``, the rounding) bit for bit, and
the wrapper refuses what the kernel does not take. The kernel itself is
held to the plain chain on the card in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import pixel_id_scenes as scenes
from maria_torch.coords import phi_theta_to_offsets
from maria_torch.mappers.bin_mapper import azel_pixel_ids, pixel_ids as flat_ids, radec_pixel_ids
from maria_torch.ops.pixel_ids import pixel_ids, pixel_ids_plain


@pytest.fixture(scope="module", autouse=True)
def private_cache(tmp_path_factory):
    import maria_torch

    old = maria_torch.io._cache_state["base"]
    maria_torch.set_cache_dir(str(tmp_path_factory.mktemp("maria_torch_cache")))
    yield
    maria_torch.set_cache_dir(old)


def _chain_before_the_kernel(pointing, frame, center, res, n_x, n_y):
    """The ids as the mappers computed them before ``ops.pixel_ids``."""
    phi, theta = pointing.det_radec(device="cpu") if frame == "ra/dec" else pointing.det_azel(device="cpu")
    offsets = phi_theta_to_offsets(torch.stack([phi, theta], dim=-1), *center)
    x0, y0 = -(n_x - 1) / 2 * res, -(n_y - 1) / 2 * res
    return flat_ids(offsets[..., 0], offsets[..., 1], x0, y0, res, n_x, n_y)


_SCENES = {}


def _scene(name):
    if name not in _SCENES:
        _SCENES[name] = scenes.sky_scene() if name == "sky" else scenes.cmb_patch_scene()
    return _SCENES[name]


@pytest.mark.parametrize("frame", ["ra/dec", "az/el"])
@pytest.mark.parametrize("name", ["sky", "cmb_patch"])
def test_frame_ids_on_the_cpu_equal_the_chain_before_the_kernel(name, frame):
    """radec_pixel_ids and azel_pixel_ids (the mappers' ids) on the CPU:
    the same int32 ids as before, bit for bit, and no kernel launch; the
    sky scene on its input map's grid, the CMB patch (1,052 x 12,000) on
    the ML mapper's 197 x 197 grid (in az/el on the grid it infers
    there)."""
    obs, geometry = _scene(name)
    if frame == "az/el":
        geometry = scenes.mapper_geometry(obs, "az/el", np.degrees(geometry[1]))
    pointing = scenes.pointing(obs)
    before = pixel_ids.launches
    frame_ids = radec_pixel_ids if frame == "ra/dec" else azel_pixel_ids
    ids = frame_ids(pointing, *geometry, device="cpu")
    assert pixel_ids.launches == before
    assert ids.dtype == torch.int32 and ids.shape == pointing.shape
    if name == "cmb_patch":
        assert ids.shape == (1052, 12000) and (frame == "az/el" or geometry[2:] == (197, 197))
    assert float((ids >= 0).double().mean()) > 0.5
    assert torch.equal(ids, _chain_before_the_kernel(pointing, frame, *geometry))


@pytest.mark.parametrize("frame", ["ra/dec", "az/el"])
def test_wrapper_runs_the_plain_chain_on_cpu_tensors(frame):
    """On CPU tensors ``pixel_ids`` is ``pixel_ids_plain`` and leaves the
    launch counter alone, at the edge scene: r = 0, a half-pixel border
    (rounded to the even column), every edge, NaN boresight samples."""
    factors, geometry = scenes.edge_scene(frame)
    offsets, phi, theta, cos_q, sin_q = factors
    before = pixel_ids.launches
    ids = pixel_ids(offsets, phi, theta, *geometry, cos_q, sin_q)
    assert pixel_ids.launches == before
    assert torch.equal(ids, pixel_ids_plain(offsets, phi, theta, *geometry, cos_q, sin_q))
    n_x = geometry[2]
    assert int(ids[0, 0]) % n_x == 2  # x exactly 2.5 pixels from the first column: half to even
    assert bool((ids == -1).any()) and bool((ids >= 0).any())
    assert int(ids[:, 17].max()) == -1 and int(ids[:, 40].max()) == -1  # NaN casts out of range on the CPU


def _edge_factors():
    return scenes.edge_scene("ra/dec")


@pytest.mark.parametrize("fault", ["float64 offsets", "float64 track", "offsets on another device",
                                   "track on another device", "non-contiguous offsets", "cos_q alone",
                                   "offsets not (n, 2)", "tracks of two lengths"])
def test_wrapper_refuses_what_the_kernel_does_not_take(fault):
    (offsets, phi, theta, cos_q, sin_q), geometry = _edge_factors()
    if fault == "float64 offsets":
        offsets = offsets.double()
    elif fault == "float64 track":
        theta = theta.double()
    elif fault == "offsets on another device":
        offsets = torch.empty(offsets.shape, dtype=torch.float32, device="meta")
    elif fault == "track on another device":
        sin_q = torch.empty(sin_q.shape, dtype=torch.float32, device="meta")
    elif fault == "non-contiguous offsets":
        offsets = torch.stack([offsets[:, 0], offsets[:, 1]], dim=0).t()
        assert not offsets.is_contiguous()
    elif fault == "cos_q alone":
        sin_q = None
    elif fault == "offsets not (n, 2)":
        offsets = offsets[:, :1].contiguous()
    elif fault == "tracks of two lengths":
        phi = phi[:-1].contiguous()
    with pytest.raises(ValueError):
        pixel_ids(offsets, phi, theta, *geometry, cos_q, sin_q)
