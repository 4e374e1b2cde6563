"""A stage's band tables (``maria_torch/ops/band_tables.py``) on the CPU:
the wrapper runs the plain version there and launches nothing, and that
version gives the program's band stages as the port computed them before
the kernel (a ``TableEval`` a table and band, the product with the
Mueller I factor, the CMB stage's product with its samples and sum, the
scatter into the field) bit for bit: uniform, log and general axes,
points below and beyond every table edge, a contiguous band, a band whose
rows interleave with another's (index rows), a mesh rank's rows, and a
band without a CMB left at zero; ``TODProgram.fields``' "atmosphere" and
"cmb" fields, and the gradients in pwv and el through both stages, the
autograd Function's recomputed backward among them. The kernel is held to
the plain version on the card in tests/test_torch_cuda.py. No JAX here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import maria_torch  # noqa: E402
from maria_torch.array.rows import device_rows  # noqa: E402
from maria_torch.instrument import Instrument  # noqa: E402
from maria_torch.ops import band_tables as bt  # noqa: E402
from maria_torch.ops.band_tables import BandStage, BandTables, band_tables, band_tables_plain  # noqa: E402
from maria_torch.ops.interp import TableEval  # noqa: E402

BANDS = ("act/pa5/f090", "act/pa5/f150")
SIDES = {
    "uniform": (np.linspace(0.2, 3.0, 6), np.linspace(0.3, 1.5, 5)),
    "log": (np.geomspace(0.1, 5.0, 7), np.linspace(0.3, 1.5, 4)),
    "general": (np.array([0.1, 0.3, 0.35, 0.9, 1.6, 3.0]), np.array([0.2, 0.25, 0.6, 1.0, 1.1, 1.57])),
}
N_ROWS, N_T = 40, 53


@pytest.fixture(scope="module", autouse=True)
def private_cache(tmp_path_factory):
    old = maria_torch.io._cache_state["base"]
    maria_torch.set_cache_dir(str(tmp_path_factory.mktemp("maria_torch_cache")))
    yield
    maria_torch.io._cache_state["base"] = old


def chain_before_the_kernel(stages, n_rows, pwv, el, mueller_I, two):
    """A stage as TODProgram.fields computed it before ``band_tables``:
    the loading into an empty field (rows of no band left as they were
    allocated), the CMB into zeros."""
    out = torch.zeros((n_rows, pwv.shape[1])) if two else torch.empty_like(pwv)
    for s in stages:
        if not s.tables:
            continue
        idx = device_rows(s.rows, "cpu")
        evals = [TableEval(s.pwv_side, s.el_side, t, device="cpu") for t in s.tables]
        if two:
            pwv_b, el_b = pwv[idx], el[idx]
            out[idx] = evals[0](pwv_b, el_b) * mueller_I[idx, None] + evals[1](pwv_b, el_b) * s.samples
        else:
            out[idx] = mueller_I[idx, None] * evals[0](pwv[idx], el[idx])
    return out


def synthetic_stages(kinds, two, rng, without_tables=False):
    """Bands over N_ROWS rows: rows 0-9 (a run), the even and odd rows of
    10-29 (two bands whose rows interleave: index rows), 30-39 (a run,
    without tables where ``without_tables``), each band on the sides of
    one of ``kinds`` in turn."""
    rows = [np.arange(0, 10), np.arange(10, 30, 2), np.arange(11, 30, 2), np.arange(30, 40)]
    stages = []
    for k, r in enumerate(rows):
        x_side, y_side = SIDES[kinds[k % len(kinds)]]
        if without_tables and k == 3:
            stages.append(BandStage(r, x_side, y_side))
            continue
        tables = tuple(rng.uniform(-2.0, 5.0, (len(x_side), len(y_side))).astype(np.float32) for _ in range(1 + two))
        samples = torch.as_tensor(rng.standard_normal((len(r), N_T)), dtype=torch.float32) if two else None
        stages.append(BandStage(r, x_side, y_side, tables, samples))
    return stages


def edge_points(rng, kinds):
    """pwv and el (N_ROWS, N_T): most inside the sides' span and beyond it
    on both ends, and exactly on every grid point of every kind's sides.
    pwv stays positive (log axes)."""
    pwv = rng.uniform(0.02, 4.5, (N_ROWS, N_T))
    el = rng.uniform(0.05, 1.8, (N_ROWS, N_T))
    for k, kind in enumerate(kinds):
        x_side, y_side = SIDES[kind]
        pwv[:, k * 8: k * 8 + len(x_side)] = x_side
        el[:, 30 + k * 7: 30 + k * 7 + len(y_side)] = y_side
    pwv[:, -1], el[:, -1] = 1e-3, 0.0  # below every edge
    pwv[:, -2], el[:, -2] = 40.0, 3.0  # beyond every edge
    return (torch.as_tensor(a, dtype=torch.float32) for a in (pwv, el))


@pytest.mark.parametrize("two", [False, True], ids=["loading", "cmb"])
@pytest.mark.parametrize("kinds", [("uniform",), ("log",), ("general",), ("log", "uniform", "general")],
                         ids=["uniform", "log", "general", "mixed"])
def test_plain_equals_the_chain_before_the_kernel(kinds, two):
    """Every row of every band bit for bit, the cells' corners, inner
    points and points off every edge among them; no launch on the CPU."""
    rng = np.random.default_rng(len(kinds) + 10 * two)
    stages = synthetic_stages(kinds, two, rng)
    assert {type(device_rows(s.rows, "cpu")) for s in stages} == {slice, torch.Tensor}
    tables = BandTables(stages, N_ROWS, "cpu")
    pwv, el = edge_points(rng, kinds)
    mueller_I = torch.as_tensor(rng.uniform(0.5, 1.0, N_ROWS), dtype=torch.float32)
    before = band_tables.launches
    ours = band_tables(tables, pwv, el, mueller_I)
    assert band_tables.launches == before
    ref = chain_before_the_kernel(stages, N_ROWS, pwv, el, mueller_I, two)
    assert ours.shape == (N_ROWS, N_T) and ours.dtype == torch.float32
    assert bool(torch.isfinite(ours).all())
    assert torch.equal(ours, ref)


def test_a_band_without_tables_and_rows_of_no_band_are_zero():
    """The CMB stage's band without a CMB, and rows that no band holds,
    stay at zero; the other rows are the chain's."""
    rng = np.random.default_rng(3)
    stages = synthetic_stages(("log", "uniform"), True, rng, without_tables=True)
    pwv, el = edge_points(rng, ("log", "uniform"))
    mueller_I = torch.as_tensor(rng.uniform(0.5, 1.0, N_ROWS), dtype=torch.float32)
    tables = BandTables(stages, N_ROWS, "cpu")
    assert not tables.covered and tables.held
    ours = band_tables(tables, pwv, el, mueller_I)
    assert torch.equal(ours, chain_before_the_kernel(stages, N_ROWS, pwv, el, mueller_I, True))
    assert bool((ours[30:] == 0).all()) and bool((ours[:30] != 0).all())
    # rows 30-39 in no band at all
    fewer = BandTables(stages[:3], N_ROWS, "cpu")
    assert not fewer.covered and not fewer.held
    assert torch.equal(band_tables(fewer, pwv, el, mueller_I), ours)


@pytest.mark.parametrize("two", [False, True], ids=["loading", "cmb"])
def test_a_rank_rows_are_the_whole_call_rows(two):
    """A mesh rank's rows (start, stop): each band's rows within them,
    counted from start, and its samples' rows: the whole call's rows bit
    for bit."""
    rng = np.random.default_rng(5)
    stages = synthetic_stages(("log", "general", "uniform"), two, rng)
    pwv, el = edge_points(rng, ("log", "general", "uniform"))
    mueller_I = torch.as_tensor(rng.uniform(0.5, 1.0, N_ROWS), dtype=torch.float32)
    whole = band_tables(BandTables(stages, N_ROWS, "cpu"), pwv, el, mueller_I)
    start, stop = 7, 25
    ranked = []
    for s in stages:
        keep = (s.rows >= start) & (s.rows < stop)
        ranked.append(s._replace(rows=s.rows[keep] - start, samples=None if s.samples is None else s.samples[keep]))
    part = band_tables(BandTables(ranked, stop - start, "cpu"), pwv[start:stop], el[start:stop],
                       mueller_I[start:stop])
    assert torch.equal(part, whole[start:stop])


def test_band_tables_refuses_what_the_kernel_does_not_take():
    rng = np.random.default_rng(7)
    stages = synthetic_stages(("uniform",), True, rng)
    with pytest.raises(ValueError, match="more than one band"):
        BandTables([stages[0], stages[0]._replace(rows=np.arange(5, 12), samples=stages[0].samples[:7])], N_ROWS,
                   "cpu")
    with pytest.raises(ValueError, match="one table each or two each"):
        BandTables([stages[0], synthetic_stages(("uniform",), False, rng)[1]], N_ROWS, "cpu")
    with pytest.raises(ValueError, match="static samples"):
        BandTables([stages[0]._replace(samples=None)], N_ROWS, "cpu")
    with pytest.raises(ValueError, match="must be"):
        BandTables([stages[0]._replace(tables=(stages[0].tables[0][:, :2], stages[0].tables[1]))], N_ROWS, "cpu")
    tables = BandTables(stages, N_ROWS, "cpu")
    pwv, el = edge_points(rng, ("uniform",))
    mueller_I = torch.ones(N_ROWS)
    with pytest.raises(ValueError, match="takes pwv and el"):
        band_tables(tables, pwv[1:], el[1:], mueller_I)
    with pytest.raises(ValueError, match="float32"):
        band_tables(tables, pwv.double(), el, mueller_I)
    with pytest.raises(ValueError, match="constant mueller_I"):
        band_tables(tables, pwv, el, mueller_I.clone().requires_grad_(True))


# -- the program's stages --------------------------------------------------------------------------


def simulation(instrument):
    plan = maria_torch.Plan.generate(duration=10, sample_rate=20, start_time="2026-03-05T12:00:00",
                                     scan_center=(45, 45), scan_pattern="back-and-forth",
                                     scan_options={"x_throw": 1, "y_throw": 0, "speed": 0.5}, frame="az/el",
                                     site="cerro_toco")
    return maria_torch.Simulation(instrument, plans=[plan], site="cerro_toco", atmosphere="2d", cmb="generate",
                                  cmb_kwargs={"nside": 64}, noise=True, seed=0, device="cpu")


@pytest.fixture(scope="module")
def programs():
    """Two polarized ACT bands of 40 detectors each with a CMB, sorted by
    band (slices) and with the bands alternating row by row (index rows)."""
    instrument = maria_torch.get_instrument(array={
        "n": 20, "field_of_view": 0.2, "primary_size": 6, "polarized": True, "bands": list(BANDS)})
    half = instrument.n_dets // 2
    perm = np.stack([np.arange(half), half + np.arange(half)], axis=1).ravel()
    sims = {"sorted": simulation(instrument)}
    sims["interleaved"] = simulation(Instrument([instrument.dets.take(perm)]))
    return {name: sim.program() for name, sim in sims.items()}


def stages_before_the_kernel(program, rows=None):
    """The program's loading and CMB stages as the chain computed them
    before the kernel, on the program's coarse pwv and elevation of seed
    11 (``rows`` = (start, stop) for a rank's)."""
    coarse = program.fields(seed=11, device="cpu", upto="coarse", rows=rows)
    pwv, el = coarse["pwv_c"], coarse["el_c"]
    tabs = program._tensors(torch.device("cpu"), program.check_rows(rows))
    mueller_I = tabs["mueller_I"]
    stages = [s for s in tabs["power"].bands]
    loading = chain_before_the_kernel(stages, len(mueller_I), pwv, el, mueller_I, False)
    pwv_f, el_f = program._upsample(pwv, "linear"), program._upsample(el, "cubic")
    cmb = chain_before_the_kernel(tabs["cmb"].bands, len(mueller_I), pwv_f, el_f, mueller_I, True)
    return {"loading_c": loading, "atmosphere": program._upsample(loading, "cubic"), "cmb": cmb}


@pytest.mark.parametrize("rows", [None, (13, 58)], ids=["whole", "rank"])
@pytest.mark.parametrize("name", ["sorted", "interleaved"])
def test_program_fields_equal_the_chain_before_the_kernel(programs, name, rows):
    """TODProgram.fields' "atmosphere" and "cmb" fields (and the coarse
    loading) on the CPU: today's bit for bit, with slices, with index
    rows, and on a rank's rows."""
    program = programs[name]
    tabs = program._tensors(torch.device("cpu"), program.check_rows(rows))
    kinds = {type(r) for r in tabs["power"].rows}
    assert kinds == ({slice} if name == "sorted" else {torch.Tensor})
    ref = stages_before_the_kernel(program, rows)
    coarse = program.fields(seed=11, device="cpu", upto="coarse", rows=rows)
    fields = program.fields(seed=11, device="cpu", upto="signal", rows=rows)
    assert sorted(fields) == ["atmosphere", "cmb"]
    assert torch.equal(coarse["loading_c"], ref["loading_c"])
    for k in ("atmosphere", "cmb"):
        assert torch.equal(fields[k], ref[k]), k
        assert float(fields[k].abs().max()) > 0
    if rows is not None:
        whole = program.fields(seed=11, device="cpu", upto="signal")
        for k in ("atmosphere", "cmb"):
            assert torch.equal(fields[k], whole[k][rows[0]:rows[1]])


def _grads(fn, pwv, el, w):
    x, y = pwv.clone().requires_grad_(True), el.clone().requires_grad_(True)
    return torch.autograd.grad((w * fn(x, y)).sum(), (x, y))


@pytest.mark.parametrize("stage", ["power", "cmb"])
@pytest.mark.parametrize("name", ["sorted", "interleaved"])
def test_gradients_equal_the_chain_before_the_kernel(programs, name, stage):
    """The gradients of sum(w * field) in pwv and el through each stage:
    the wrapper's (the plain version on the CPU), and the autograd
    Function's whose backward recomputes the plain version, equal the
    chain's before the kernel bit for bit."""
    program = programs[name]
    tabs = program._tensors(torch.device("cpu"))
    tables, mueller_I = tabs[stage], tabs["mueller_I"]
    coarse = program.fields(seed=11, device="cpu", upto="coarse")
    pwv, el = coarse["pwv_c"], coarse["el_c"]
    if stage == "cmb":
        pwv, el = program._upsample(pwv, "linear"), program._upsample(el, "cubic")
    w = torch.randn(pwv.shape, generator=torch.Generator().manual_seed(2))
    ref = _grads(lambda x, y: chain_before_the_kernel(tables.bands, len(mueller_I), x, y, mueller_I, stage == "cmb"),
                 pwv, el, w)
    wrapper = _grads(lambda x, y: band_tables(tables, x, y, mueller_I), pwv, el, w)
    function = _grads(lambda x, y: bt._BandTablesFn.apply(x, y, tables, mueller_I, band_tables_plain), pwv, el, w)
    for ours in (wrapper, function):
        for g, g_ref in zip(ours, ref):
            assert float(g_ref.abs().max()) > 0
            assert torch.equal(g, g_ref)
    # el alone requiring a gradient
    y = el.clone().requires_grad_(True)
    (g_el,) = torch.autograd.grad((w * bt._BandTablesFn.apply(pwv, y, tables, mueller_I, band_tables_plain)).sum(), y)
    assert torch.equal(g_el, ref[1])
