"""Pointings and map geometries at which the pixel-id tests hold
``maria_torch.ops.pixel_ids``: the benchmark's ACT cell, the CMB patch,
MUSTANG-2's sky scene and a hand-made scene of edge cases. Each is built
on the CPU; ``factors`` puts a scene's pointing on a device."""

import numpy as np
import torch


def mapper_geometry(obs, frame: str, resolution_deg: float):
    """(center, res, n_x, n_y) that a projection mapper given only its
    resolution infers from one TOD of ``obs`` (mappers/base.py): the
    boresight's centre in ``frame`` and 2.05 x the largest boresight offset
    plus the largest detector offset."""
    b = obs.boresight
    center = tuple(float(c) for c in b.center(frame=frame))
    half = float(np.abs(b.offsets(frame=frame, center=center)).max() + np.abs(obs.offsets).max())
    res = float(np.radians(resolution_deg))
    n = max(int(np.ceil(2.05 * half / res)), 1)
    return center, res, n, n


def act_scene():
    """The ACT cell's observation as its entry builds it (the atmosphere,
    the CMB and the noise left out: the pointing alone) and BinMapper's
    ra/dec geometry at the cell's resolution: 9,000 x 12,000 into
    577 x 577."""
    from portbench import run
    from portbench.entries import sim_bin_map

    _, _, config, traffic, _ = run.cell_spec("act.bf600-iqubin")
    config = {**config, "sky": {}, "noise": False}
    sim = sim_bin_map.simulation(config, traffic["duration_s"], 0, "cpu")
    return sim.obs_list[0], mapper_geometry(sim.obs_list[0], "ra/dec", traffic["mapper"]["resolution"])


def cmb_patch_scene(duration: float = 600.0):
    """The CMB patch's observation (docs/tutorials.md, no sky) and the IQU
    ML mapper's ra/dec geometry at 2 arcmin: 1,052 x 12,000 into
    197 x 197 at 600 s."""
    from maria_torch import scenes

    obs = scenes.cmb_patch_simulation(duration, "cpu", cmb=None, noise=False).obs_list[0]
    return obs, mapper_geometry(obs, "ra/dec", 2 / 60)


def sky_scene(duration: float = 20.0):
    """MUSTANG-2's ra/dec daisy over big_cluster (``scenes.sky_simulation``)
    and its input map's geometry."""
    from maria_torch.scenes import sky_simulation

    sim = sky_simulation(duration, "cpu", atmosphere=None, noise=False)
    sky = sim.map
    return sim.obs_list[0], (tuple(sky.center), sky.x_res, sky.n_x, sky.n_y)


def pointing(obs):
    from maria_torch.tod import Pointing

    return Pointing(obs.boresight, obs.offsets, obs.q)


def edge_scene(frame: str = "ra/dec"):
    """Hand-made factors of 8 detectors x 64 samples, (offsets, phi,
    theta, cos_q, sin_q) float32 on the CPU, and a 6 x 4 map of 2^-10 rad
    pixels centred on the first sample's boresight: a detector at zero
    offset (r = 0; at the first sample it lands on a pixel border, 2.5
    pixels from the first column's centre exactly), detectors off each of
    the map's four edges, one sample's boresight NaN in phi and another's
    in theta."""
    res = 2.0**-10
    offsets = torch.tensor([[0.0, 0.0], [res, -res], [2.5 * res, 0.5 * res], [-4 * res, 0.0], [4 * res, 0.0],
                            [0.0, -3 * res], [0.0, 3 * res], [-1.7 * res, 1.2 * res]], dtype=torch.float32)
    t = torch.arange(64, dtype=torch.float64)
    phi = (2.0 + 0.05 * res * t).to(torch.float32)
    theta = (-0.5 + 0.1 * res * torch.sin(t)).to(torch.float32)
    phi[17] = float("nan")
    theta[40] = float("nan")
    q = 0.3 + 0.01 * t
    cos_q, sin_q = torch.cos(q).to(torch.float32), torch.sin(q).to(torch.float32)
    if frame == "az/el":
        cos_q = sin_q = None
    center = (float(phi[0]), float(theta[0]))
    return (offsets, phi, theta, cos_q, sin_q), (center, res, 6, 4)
