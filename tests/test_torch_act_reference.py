"""maria_torch's 2-D atmosphere and BinMapper's IQU maps against the
benchmark's plain float64 references (``portbench/reference/``), on the
CPU at a small size: the ACT camera's three arrays at 7 beams each (84
polarized detectors in six bands) on 30 s of the registry's
back_and_forth_10deg_45el plan.

- every screen that ``synthesize_layers`` makes from given draws (four
  slabs as fine/coarse pairs, four whole) equals the reference's screen
  from its own spectral weights on the same draws, and the pwv that
  ``accumulate_pwv`` samples along the lines of sight equals the
  reference's;
- BinMapper's I, Q and U maps and weights of every band equal the
  reference's binning and postprocess of the same TOD at the same pixel
  ids, and the reference's float64 ids agree with the program's.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import maria_torch  # noqa: E402
from maria_torch.band import Band  # noqa: E402
from portbench.reference import bin_map as ref_map  # noqa: E402
from portbench.reference import screens_2d  # noqa: E402
from portbench.reference.common import F64  # noqa: E402
from portbench.reference.scene import beam_sigma  # noqa: E402

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "portbench" / "configs" / "act.json").read_text())


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    old = maria_torch.io._cache_state["base"]
    maria_torch.set_cache_dir(str(tmp_path_factory.mktemp("maria_torch_cache")))
    yield
    maria_torch.set_cache_dir(old)


def act_simulation(**sky):
    arrays = {name: {**{k: v for k, v in a.items() if k != "bands"}, "n": 7, "bands": [Band(**s) for s in a["bands"]]}
              for name, a in CONFIG["arrays"].items()}
    site = maria_torch.site.Site(**CONFIG["site"])
    plan = maria_torch.Plan.generate(duration=30.0, site=site, **CONFIG["plan"])
    return maria_torch.Simulation(maria_torch.get_instrument(arrays=arrays), plans=[plan], site=site, seed=11,
                                  device="cpu", **sky)


def test_2d_screens_and_pwv_match_the_reference(caches):
    from maria_torch.atmosphere.sampling import accumulate_pwv, synthesize_layers

    sim = act_simulation(atmosphere="2d", noise=False)
    program = sim.program()
    screens = program.screens
    assert {s.band for s in screens} == {"full", "fine", "coarse"}
    g = torch.Generator().manual_seed(5)
    draws = [torch.randn((s.ny, s.nx // 2 + 1, 2), generator=g) for s in screens]
    layers = synthesize_layers(screens, torch.device("cpu"), draws=draws)

    dets = sim.instrument.dets
    centers = [b.center for b in dets.bands]
    counts = [int((dets.band_name == b.name).sum()) for b in dets.bands]
    ref_screens = [{k: getattr(s, k) for k in ("h", "z", "res", "pwv_rms", "angle", "vx", "vy", "tx_min", "ty_min",
                                               "nx", "ny", "band")} for s in screens]
    sigmas = [beam_sigma(s["z"], float(np.unique(dets.primary_size).item()), centers, counts) for s in ref_screens]
    W = screens_2d.all_weights(ref_screens, sigmas, "cpu")
    values = [screens_2d.screen_values(s, w, d.to(F64)) for s, w, d in zip(ref_screens, W, draws)]
    for layer, want in zip(layers, values):
        assert layer.values.shape == want.shape
        assert float((layer.values.double() - want).abs().max()) <= 1e-5 * float(want.std())

    f32 = dict(dtype=torch.float32)
    offsets, az, el = (np.asarray(a) for a in (program.offsets, program.bs_az_coarse, program.bs_el_coarse))
    from maria_torch.ops.program import line_of_sight

    _, _, px, py = line_of_sight(torch.tensor(offsets, **f32), torch.tensor(az, **f32), torch.tensor(el, **f32))
    t_c = torch.tensor(np.asarray(program.t_coarse), **f32)
    got = accumulate_pwv(program.mean_pwv, screens, px, py, t_c, draws=draws)
    _, rpx, rpy = screens_2d.line_of_sight(torch.tensor(offsets, dtype=F64), torch.tensor(az, dtype=F64),
                                           torch.tensor(el, dtype=F64))
    want = screens_2d.pwv(program.mean_pwv, ref_screens, values, rpx, rpy, torch.tensor(program.t_coarse, dtype=F64))
    fluctuation = float((want - want.mean()).std())
    assert float((got.double() - want).abs().max()) <= 1e-3 * fluctuation


def test_bin_mapper_iqu_matches_the_reference(caches):
    from maria_torch.mappers.bin_mapper import radec_pixel_ids

    sim = act_simulation(cmb="generate", cmb_kwargs={"nside": 64}, noise=True)
    tod = sim.run()[0]
    mapper = maria_torch.BinMapper(tod, frame="ra/dec", resolution=1 / 30)
    out = mapper.run()
    assert mapper.stokes == "IQU" and len(mapper.bands) == 6

    ids = radec_pixel_ids(tod.pointing, mapper.center, mapper.res, mapper.n_x, mapper.n_y, device="cpu").long()
    sw = torch.as_tensor(tod.dets.stokes_weight()[:, :3], dtype=F64)
    data = tod.signal.double()
    n_pix = mapper.n_x * mapper.n_y
    bands = [{"name": b.name, "center": b.center} for b in tod.dets.bands]
    names = [bands[i]["name"] for i in ref_map.band_order(bands)]
    assert names == [b.name for b in mapper.bands]
    sums, wgts = torch.zeros((2, 3, 6, n_pix), dtype=F64)
    for k, name in enumerate(names):
        rows = torch.as_tensor(np.nonzero(tod.dets.band_name == name)[0])
        sums[:, k], wgts[:, k] = ref_map.bin(data[rows], ids[rows], sw[rows], n_pix)
    want = ref_map.postprocess(sums, wgts)
    got = torch.as_tensor(out.data).reshape(3, 6, n_pix).double()
    weight = torch.as_tensor(out.weight).reshape(3, 6, n_pix).double()
    valid = wgts > 0
    assert bool((got[~valid] == 0).all())
    torch.testing.assert_close(weight, wgts, rtol=1e-5, atol=1e-6 * float(wgts.max()))
    for s in range(3):
        e = torch.where(valid[s], got[s] - torch.nan_to_num(want[s]), 0.0)
        m = torch.nan_to_num(want[s])
        gap = ((wgts[s] * e**2).sum(-1) / (wgts[s] * m**2).sum(-1)).sqrt()
        assert float(gap.max()) <= 1e-5, ("IQU"[s], gap)

    # the reference's float64 ids in its own geometry: the same map, a sample in ~1e3 at a neighbour at most
    from portbench.reference.sim_tod import det_radec
    from portbench.reference.sky import boresight_radec

    b, site = tod.boresight, CONFIG["site"]
    ra, dec, q = boresight_radec(np.asarray(b.az), np.asarray(b.el), np.asarray(b.t), math.radians(site["latitude"]),
                                 math.radians(site["longitude"]))
    offsets = np.asarray(tod.pointing.offsets)
    geom = ref_map.geometry(torch.as_tensor(ra), torch.as_tensor(dec), offsets, mapper.res)
    assert geom["n_x"] == mapper.n_x == mapper.n_y
    assert max(abs(a - b) for a, b in zip(geom["center"], mapper.center)) < 1e-3 * mapper.res
    start = {"ra": ra, "dec": dec, "q": q, "offsets": offsets}
    det_ra, det_dec = det_radec(start, np.arange(len(offsets)), "cpu")
    assert float((ref_map.pixel_ids(det_ra, det_dec, geom) != ids).double().mean()) < 1e-3
