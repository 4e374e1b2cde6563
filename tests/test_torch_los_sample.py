"""The line-of-sight layer sampler (``maria_torch/ops/los_sample.py``) on
the CPU: a CPU tensor takes the plain path and gives the values of the
per-layer loop that ``accumulate_pwv`` ran before the kernel existed, bit
for bit; the kernel's descriptor table lists the layers in
``accumulate_pwv``'s order; constant grids only. A numpy float32
emulation of the kernel's arithmetic (``csrc/los_sample.cu``), forward
and backward, with torch's division of the device it runs on, equals
the plain path and its autograd bit for bit. The kernel itself runs in
tests/test_torch_cuda.py (``-k los``), held to the same emulation.
"""

import numpy as np
import pytest
import torch

from maria_torch.atmosphere.atmosphere import LayerScreen, ScreenGroup
from maria_torch.atmosphere.fourier import synthesize_layered_matern_2d, synthesize_matern_field_2d
from maria_torch.atmosphere.sampling import accumulate_pwv, synthesize_layers
from maria_torch.ops.interp import interp_bilinear_uniform
from maria_torch.ops.los_sample import Layer, LosLayer, layer_table, los_sample, los_sample_plain

def _weights(ny, nx, rng):
    """A Matérn-like (ny, nx//2+1) spectral weight table."""
    ky = np.fft.fftfreq(ny)[:, None]
    kx = np.fft.rfftfreq(nx)[None, :]
    return (0.1 + (ky**2 + kx**2) * 400) ** (-11 / 12) * rng.uniform(0.5, 1.5)


def _scene(seed=0, n_screens=2, n_group=3):
    """Fourier screens (one with ty_res != res) and a screen group on small
    grids, and lines of sight over (n_det, n_tc) that cross them, leave
    them and meet a grid's last cell edge exactly."""
    rng = np.random.default_rng(seed)
    screens = []
    for i in range(n_screens):
        ny, nx = 24 + 3 * i, 40 + 6 * i
        screens.append(LayerScreen(
            h=float(rng.uniform(300, 3000)), z=1.0, res=float(rng.uniform(8, 15)), pwv_rms=float(rng.uniform(0.01, 0.05)),
            angle=float(rng.uniform(-np.pi, np.pi)), vx=float(rng.uniform(-10, 10)), vy=float(rng.uniform(-10, 10)),
            tx_min=float(rng.uniform(-300, -100)), ty_min=float(rng.uniform(-200, -100)), nx=nx, ny=ny,
            W=_weights(ny, nx, rng).astype(np.float32), ty_res=None if i == 0 else float(rng.uniform(5, 9)),
        ))
    ny, nx, J = 30, 36, 2
    group = ScreenGroup(
        heights=np.geomspace(200.0, 4000.0, n_group), zs=np.ones(n_group), pwv_rms=rng.uniform(0.01, 0.05, n_group),
        angle=0.7, vx=6.0, vy=-3.0, res=12.0, tx_min=-250.0, ty_min=-180.0, nx=nx, ny=ny,
        W=np.stack([_weights(ny, nx, rng) for _ in range(J)]).astype(np.float32),
        M_cos=rng.uniform(0.2, 1.0, (n_group, J)).astype(np.float32),
        M_sin=rng.uniform(-0.3, 0.3, (n_group, J)).astype(np.float32),
    )
    n_det, n_tc = 7, 50
    px = rng.uniform(-0.15, 0.15, (n_det, 1)) + rng.uniform(-0.01, 0.01, (1, n_tc))
    py = rng.uniform(-0.1, 0.1, (n_det, 1)) + rng.uniform(-0.01, 0.01, (1, n_tc))
    px[0] = rng.uniform(-3, 3, n_tc)  # a detector that leaves every grid
    t = np.linspace(0.0, 20.0, n_tc)
    return screens, [group], torch.as_tensor(px, dtype=torch.float32), torch.as_tensor(py, dtype=torch.float32), \
        torch.as_tensor(t, dtype=torch.float32)


def _draws(screens, groups, seed):
    g = torch.Generator().manual_seed(seed)
    return ([torch.randn((s.ny, s.nx // 2 + 1, 2), generator=g) for s in screens],
            [torch.randn((2 * gr.W.shape[0], gr.ny, gr.nx // 2 + 1, 2), generator=g) for gr in groups])


def _loop_before_the_kernel(mean_pwv, screens, px, py, t_rel, draws, groups, group_draws):
    """accumulate_pwv's per-layer loop as it was before ops/los_sample.py."""
    def sample(values, h, angle, vx, vy, res_x, res_y, tx_min, ty_min):
        x = h * px + vx * t_rel
        y = h * py + vy * t_rel
        ca, sa = float(np.cos(angle)), float(np.sin(angle))
        tx = ca * x + sa * y
        ty = -sa * x + ca * y
        return interp_bilinear_uniform(values, tx, ty, tx_min, res_x, ty_min, res_y)

    pwv = torch.full(px.shape, float(np.float32(mean_pwv)), dtype=px.dtype, device=px.device)
    for i, s in enumerate(screens):
        values = synthesize_matern_field_2d(torch.as_tensor(s.W), s.ny, s.nx, draw=draws[i])
        ty_res = s.ty_res if s.ty_res is not None else s.res
        pwv = pwv + s.pwv_rms * sample(values, s.h, s.angle, s.vx, s.vy, s.res, ty_res, s.tx_min, s.ty_min)
    for g, gr in enumerate(groups):
        stack = synthesize_layered_matern_2d(torch.as_tensor(gr.W), torch.as_tensor(gr.M_cos),
                                             torch.as_tensor(gr.M_sin), None, gr.ny, gr.nx, draw=group_draws[g])
        for il, h in enumerate(gr.heights):
            pwv = pwv + float(gr.pwv_rms[il]) * sample(stack[il], float(h), gr.angle, gr.vx, gr.vy, gr.res, gr.res,
                                                       gr.tx_min, gr.ty_min)
    return pwv


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cpu_takes_the_plain_path_bit_for_bit(seed):
    screens, groups, px, py, t = _scene(seed)
    draws, group_draws = _draws(screens, groups, seed)
    before = los_sample.launches
    ours = accumulate_pwv(1.3, screens, px, py, t, draws=draws, groups=groups, group_draws=group_draws)
    ref = _loop_before_the_kernel(1.3, screens, px, py, t, draws, groups, group_draws)
    assert los_sample.launches == before
    assert torch.equal(ours, ref)
    assert float((ours - 1.3).abs().max()) > 0 and bool((ours[0] != ours[1]).any())


def test_layer_table_lists_screens_then_group_layers():
    """The table holds accumulate_pwv's layers in its order: each screen,
    then each height of each group, with their heights, rms and grids (a
    group's layers point into its stack), the constants as float32 and
    the spacings' reciprocals taken in double and rounded to float32."""
    screens, groups, _, _, _ = _scene(3, n_screens=3, n_group=4)
    draws, group_draws = _draws(screens, groups, 3)
    layers = synthesize_layers(screens, torch.device("cpu"), draws=draws, groups=groups, group_draws=group_draws)
    table, grids = layer_table(layers)
    assert len(table) == len(grids) == 3 + 4 and isinstance(table[0], LosLayer)
    gr = groups[0]
    stack = synthesize_layered_matern_2d(torch.as_tensor(gr.W), torch.as_tensor(gr.M_cos), torch.as_tensor(gr.M_sin),
                                         None, gr.ny, gr.nx, draw=group_draws[0])
    expect = [(s.h, s.pwv_rms, s.angle, s.res, s.ty_res or s.res, s.tx_min, s.ty_min,
               synthesize_matern_field_2d(torch.as_tensor(s.W), s.ny, s.nx, draw=draws[i]))
              for i, s in enumerate(screens)]
    expect += [(h, rms, gr.angle, gr.res, gr.res, gr.tx_min, gr.ty_min, stack[il])
               for il, (h, rms) in enumerate(zip(gr.heights, gr.pwv_rms))]
    f32 = np.float32
    for d, grid, layer, (h, rms, angle, res_x, res_y, x0, y0, values) in zip(table, grids, layers, expect):
        assert torch.equal(grid, values) and d.grid == grid.data_ptr() and (d.ny, d.nx) == tuple(values.shape)
        assert (d.h, d.rms, d.x0, d.y0) == (f32(h), f32(rms), f32(x0), f32(y0))
        assert (d.ca, d.sa) == (f32(np.cos(angle)), f32(np.sin(angle)))
        assert (d.inv_dx, d.inv_dy) == (f32(1 / res_x), f32(1 / res_y))
        assert layer.rms == rms and layer.h == h
    # a group's layers are views of one stack, in the order of its heights
    offsets = [g.data_ptr() - grids[3].data_ptr() for g in grids[3:]]
    assert offsets == [il * gr.ny * gr.nx * 4 for il in range(4)]


def test_grid_requiring_a_gradient_raises():
    values = torch.zeros((4, 5), requires_grad=True)
    layer = Layer(values, 1000.0, 0.1, 1.0, 2.0, 10.0, 10.0, -20.0, -20.0, 0.02)
    with pytest.raises(ValueError, match="requires a gradient"):
        layer_table([layer])
    with pytest.raises(ValueError, match="float32"):
        layer_table([layer._replace(values=torch.zeros((4, 5), dtype=torch.float64))])
    with pytest.raises(ValueError, match="ny, nx >= 2"):
        layer_table([layer._replace(values=torch.zeros((1, 5)))])


def _taps(L, a, b, tt, divide):
    """Layer L's taps at (a, b, tt) as the kernel computes them, in numpy
    float32, one operation a rounding: (inside, wx, wy, ox, oy, the four
    grid values, 1 / res_x, 1 / res_y)."""
    f = np.float32
    v = L.values.numpy()
    ny, nx = v.shape
    h, vx, vy, ca, sa = (f(c) for c in (L.h, L.vx, L.vy, np.cos(L.angle), np.sin(L.angle)))
    x, y = h * a + vx * tt, h * b + vy * tt
    tx, ty = ca * x + sa * y, -sa * x + ca * y
    # torch on a card multiplies by float32(1 / res), the reciprocal taken in double; the CPU divides
    inv_dx, inv_dy = (f(1) / f(L.res_x), f(1) / f(L.res_y)) if divide else (f(1 / L.res_x), f(1 / L.res_y))
    fx = (tx - f(L.tx_min)) / f(L.res_x) if divide else (tx - f(L.tx_min)) * inv_dx
    fy = (ty - f(L.ty_min)) / f(L.res_y) if divide else (ty - f(L.ty_min)) * inv_dy
    inside = (fx >= 0) & (fx <= nx - 1) & (fy >= 0) & (fy <= ny - 1)
    ix = np.minimum(np.floor(np.where(inside, fx, 0)).astype(np.int64), nx - 2)
    iy = np.minimum(np.floor(np.where(inside, fy, 0)).astype(np.int64), ny - 2)
    wx, wy = fx - ix.astype(f), fy - iy.astype(f)
    taps = v[iy, ix], v[iy, ix + 1], v[iy + 1, ix], v[iy + 1, ix + 1]
    return inside, wx, wy, f(1) - wx, f(1) - wy, taps, inv_dx, inv_dy, (h, ca, sa)


def emulate(mean_pwv, layers, px, py, t, divide: bool):
    """The kernel's pwv in numpy float32. ``divide``: the spacings divide,
    as torch divides a CPU tensor by a Python scalar; otherwise they
    multiply by the reciprocal taken in double and rounded to float32, as
    the kernel and torch on a card do."""
    f = np.float32
    a, b = px.numpy(), py.numpy()
    tt = np.broadcast_to(t.numpy(), a.shape)
    acc = np.full(a.shape, f(mean_pwv), dtype=f)
    with np.errstate(invalid="ignore"):
        for L in layers:
            inside, wx, wy, ox, oy, (v00, v01, v10, v11), *_ = _taps(L, a, b, tt, divide)
            sample = np.where(inside, v00 * oy * ox + v01 * oy * wx + v10 * wy * ox + v11 * wy * wx, f(0))
            acc = acc + f(L.rms) * sample
    return acc


def emulate_backward(layers, px, py, t, g, divide: bool):
    """The kernel's backward in numpy float32: the gradients of sum(g pwv)
    in px and py by the operations of the plain path's autograd, in the
    order its engine runs them (layers last to first; in a layer, its
    nodes latest created first)."""
    f = np.float32
    a, b, g = px.numpy(), py.numpy(), g.numpy()
    tt = np.broadcast_to(t.numpy(), a.shape)
    gpx = gpy = None
    with np.errstate(invalid="ignore"):
        for L in reversed(layers):
            inside, wx, wy, ox, oy, (v00, v01, v10, v11), inv_dx, inv_dy, (h, ca, sa) = _taps(L, a, b, tt, divide)
            p0, p1, p2, p3 = v00 * oy, v01 * oy, v10 * wy, v11 * wy
            go = np.where(inside, g * f(L.rms), f(0))
            gwx = ((go * p3 + -(go * p2)) + go * p1) + -(go * p0)
            gwy = (((go * wx) * v11 + (go * ox) * v10) + -((go * wx) * v01)) + -((go * ox) * v00)
            gtx, gty = (gwx / f(L.res_x), gwy / f(L.res_y)) if divide else (gwx * inv_dx, gwy * inv_dy)
            cx, cy = (gty * -sa + gtx * ca) * h, (gty * ca + gtx * sa) * h
            gpx = cx if gpx is None else gpx + cx
            gpy = cy if gpy is None else gpy + cy
    return gpx, gpy


@pytest.mark.parametrize("seed", [0, 4])
def test_emulated_kernel_equals_the_plain_path(seed):
    """The emulation with the CPU's division equals the plain path bit for
    bit, the last cell edge (fx = nx - 1) and the off-grid samples (0)
    included, and so does its backward the plain path's autograd."""
    screens, groups, px, py, t = _scene(seed)
    draws, group_draws = _draws(screens, groups, seed)
    layers = synthesize_layers(screens, torch.device("cpu"), draws=draws, groups=groups, group_draws=group_draws)
    edge = Layer(layers[0].values, 1.0, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.5)
    ny, nx = edge.values.shape
    px[1, :5] = float(nx - 1)  # x = h px + 0 t and tx = 1 x + 0 y: fx = nx - 1 exactly
    py[1, :5] = torch.tensor([0.0, 0.5, float(ny - 1), 3.25, float(ny - 1) + 1e-3])
    layers.append(edge)
    ref = los_sample_plain(1.3, layers, px, py, t)
    assert np.array_equal(emulate(1.3, layers, px, py, t, divide=True), ref.numpy())
    assert bool((ref[1, :4] != los_sample_plain(1.3, layers[:-1], px, py, t)[1, :4]).all())  # the edge's taps count

    a, b = px.clone().requires_grad_(True), py.clone().requires_grad_(True)
    g = torch.as_tensor(np.random.default_rng(seed).standard_normal(px.shape), dtype=torch.float32)
    ga, gb = torch.autograd.grad(los_sample_plain(1.3, layers, a, b, t), (a, b), g)
    gx, gy = emulate_backward(layers, px, py, t, g, divide=True)
    assert float(ga.abs().max()) > 0 and float(gb.abs().max()) > 0
    assert np.array_equal(gx, ga.numpy()) and np.array_equal(gy, gb.numpy())
