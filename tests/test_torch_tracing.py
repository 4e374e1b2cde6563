"""The port's spans and counters (maria_torch/io/logging.py), on CPU.

- tracing off, a span is the shared null context: no clock, no
  ``record_function``, nothing recorded;
- on, nested spans' self times and the counters add up, and the summary
  lists the kernels' launch counters;
- ``profiler()`` turns tracing on for its block: its trace.json holds the
  program's ``maria_torch.program.*`` stages around the aten operations
  they ran, and a realization computes the same bits traced or not;
- a run of the simulation and the ML mapper opens the documented spans
  and counts what the counters name;
- every span and counter named in maria_torch/ is a literal of the
  documented form, found by an AST walk.
"""

import ast
import json
import re
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import maria_torch  # noqa: E402
from maria_torch.io import logging as trace  # noqa: E402

PACKAGE = Path(maria_torch.__file__).resolve().parent
NAME = re.compile(r"^[a-z]+(\.[A-Za-z][A-Za-z0-9_]*)*$")
TINY_PLAN = dict(scan_pattern="daisy", start_time=1.75e9, scan_center=(150.0, 50.0), frame="az/el", duration=10,
                 sample_rate=20, scan_options={"radius": 0.25, "speed": 0.1})


@pytest.fixture(autouse=True)
def clean_trace():
    trace.set_tracing(False)
    trace.reset_trace()
    yield
    trace.set_tracing(False)
    trace.reset_trace()


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    old = maria_torch.io._cache_state["base"]
    maria_torch.set_cache_dir(str(tmp_path_factory.mktemp("maria_torch_cache")))
    yield
    maria_torch.set_cache_dir(old)


@pytest.fixture(scope="module")
def program(caches):
    """The test/1deg camera on a 10 s daisy through the 2-D atmosphere,
    with noise: the program's matrix-product route."""
    sim = maria_torch.Simulation(plans=maria_torch.plan.Plan.generate(**TINY_PLAN), instrument="test/1deg",
                                 site="green_bank", atmosphere="2d", noise=True, seed=7, device="cpu")
    return sim.program()


def test_off_records_nothing(monkeypatch, program):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(trace._time, "perf_counter", lambda: refuse("a clock"))
    assert trace.span("noise") is trace.span("mapper.cg_step")  # the shared null context
    with trace.span("noise"):
        trace.count("mapper.cg_steps", 3)
    program.total_power_fn()(seed=1, device="cpu")
    summary = trace.trace_summary()
    assert summary["spans"] == {}
    assert not any(v for v in summary["counters"].values())


def test_self_times_and_counters_add_up():
    with trace.tracing():
        with trace.span("mapper.cg_step"):
            time.sleep(0.02)
            for _ in range(2):
                with trace.span("mapper.P"):
                    time.sleep(0.01)
                    trace.count("mapper.cg_steps")
            with trace.span("mapper.PT"):
                time.sleep(0.01)
        trace.count("mapper.cg_steps", 5)
    spans, counters = trace.trace_summary()["spans"], trace.trace_summary()["counters"]
    step, p, pt = (spans[f"maria_torch.mapper.{n}"] for n in ("cg_step", "P", "PT"))
    assert (step["calls"], p["calls"], pt["calls"]) == (1, 2, 1)
    assert step["host_s"] == pytest.approx(step["self_s"] + p["host_s"] + pt["host_s"], abs=1e-9)
    assert p["self_s"] == p["host_s"] and step["self_s"] >= 0.02 and p["host_s"] >= 0.02
    assert counters["mapper.cg_steps"] == 7
    assert not trace.set_tracing(False)  # the block left tracing as it found it
    trace.reset_trace()
    assert trace.trace_summary()["spans"] == {} and "mapper.cg_steps" not in trace.trace_summary()["counters"]


def test_summary_lists_kernel_launches(monkeypatch):
    from maria_torch.ops.bin_map import bin_map
    from maria_torch.ops.pink_noise import pink_noise

    monkeypatch.setattr(bin_map, "launches", bin_map.launches + 3)  # launches before the reset are not counted
    trace.reset_trace()
    monkeypatch.setattr(bin_map, "launches", bin_map.launches + 2)
    monkeypatch.setattr(pink_noise, "launches", pink_noise.launches + 1)
    counters = trace.trace_summary()["counters"]
    assert counters["bin_map.launches"] == 2 and counters["pink_noise.launches"] == 1
    expected = {f"{op}.launches" for _, op in trace.KERNEL_COUNTERS}
    assert expected <= set(counters) and {"shared_v.launches", "ar_extrude.launches"} <= expected


def test_profiler_trace_holds_the_stages(tmp_path, program):
    fn = program.total_power_fn()
    plain = fn(seed=3, device="cpu")
    with trace.profiler(str(tmp_path)):
        traced = fn(seed=3, device="cpu")
    assert not trace.set_tracing(False)  # off again after the block
    torch.testing.assert_close(traced, plain, rtol=0, atol=0)

    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    stages = [e for e in events if e.get("cat") == "user_annotation" and e["name"].startswith("maria_torch.")]
    names = {e["name"] for e in stages}
    assert {"maria_torch.program.pointing", "maria_torch.program.loading", "maria_torch.program.upsample",
            "maria_torch.program.gains", "maria_torch.atmosphere.synthesize", "maria_torch.atmosphere.sample",
            "maria_torch.noise", "maria_torch.noise.v", "maria_torch.noise.gemm"} <= names
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]
    for e in stages:
        if e["name"].startswith("maria_torch.program."):
            inside = [o for o in ops if e["ts"] <= o["ts"] and o["ts"] + o["dur"] <= e["ts"] + e["dur"]]
            assert inside, f"{e['name']} encloses no aten operation"
    summary = trace.trace_summary()
    assert summary["spans"]["maria_torch.noise.gemm"]["calls"] == 1
    assert summary["counters"]["atmosphere.layers_sampled"] == len(program.screens)
    assert summary["counters"]["atmosphere.screens"] == len(program.screens)


def test_bin_mapper_spans_and_counters(caches):
    """BinMapper.run() opens ``mapper.ids`` once a TOD and
    ``mapper.postprocess`` once, and counts two copies to the host, the
    map and its weights (every band's sums stay on the device until the
    map is made); the 2-D atmosphere counts every screen its Atmosphere
    builds, a fine/coarse pair as two; with tracing off nothing is
    recorded."""
    sim = maria_torch.Simulation(plans=maria_torch.plan.Plan.generate(**TINY_PLAN), instrument="test/1deg",
                                 site="green_bank", atmosphere="2d", noise=True, seed=5, device="cpu")
    tods = sim.run() + sim.run()
    maria_torch.BinMapper(tods, frame="ra/dec", resolution=0.05).run()
    assert trace.trace_summary()["spans"] == {} and not trace.trace_summary()["counters"].get("mapper.host_copies")
    with trace.tracing():
        tods = sim.run() + sim.run()
        plain = maria_torch.BinMapper(tods, frame="ra/dec", resolution=0.05).run()
    summary = trace.trace_summary()
    calls = {name.removeprefix("maria_torch."): agg["calls"] for name, agg in summary["spans"].items()}
    n_bands, n_tods = len(tods[0].dets.bands), len(tods)
    screens = sim.obs_list[0].atmosphere.screens
    assert n_bands > 1 and any(s.band == "fine" for s in screens) and any(s.band == "coarse" for s in screens)
    assert n_tods > 1 and summary["counters"]["mapper.host_copies"] == 2
    assert calls["mapper.bin"] == calls["mapper.postprocess"] == 1 and calls["mapper.ids"] == n_tods
    assert summary["counters"]["atmosphere.screens"] == n_tods * len(screens)
    assert summary["spans"]["maria_torch.mapper.bin"]["host_s"] >= summary["spans"]["maria_torch.mapper.ids"]["host_s"]
    with trace.tracing(False):
        again = maria_torch.BinMapper(tods, frame="ra/dec", resolution=0.05).run()
    np.testing.assert_array_equal(again.data, plain.data)
    assert trace.trace_summary()["counters"]["mapper.host_copies"] == 2


def test_simulation_and_ml_mapper_spans(caches):
    sim = maria_torch.Simulation(plans=maria_torch.plan.Plan.generate(**TINY_PLAN), instrument="test/1deg",
                                 site="green_bank", noise=True, seed=7, device="cpu")
    with trace.tracing():
        tod = sim.run()[0]
        mapper = maria_torch.MaximumLikelihoodMapper(tods=[tod], frame="az/el", resolution=0.1,
                                                     tod_preprocessing={"remove_spline": {"knot_spacing": 5}})
        mapper.fit(epochs=2, steps_per_epoch=3)
    summary = trace.trace_summary()
    calls = {name.removeprefix("maria_torch."): agg["calls"] for name, agg in summary["spans"].items()}
    n_bands = len(tod.dets.bands)
    assert calls["sim.run_obs"] == calls["tod.to"] == calls["noise"] == 1
    assert calls["noise.basis"] == calls["noise.k1"] == n_bands
    assert summary["counters"]["noise.basis_builds"] == n_bands  # 60 detectors a band: each has a basis
    assert calls["mapper.cg_step"] == summary["counters"]["mapper.cg_steps"] == 6
    assert calls["mapper.noise_model"] == calls["mapper.rhs"] == calls["mapper.white_diag"] == 2
    # P^T N^-1 P: once a step and once to start each epoch
    assert calls["mapper.P"] == calls["mapper.inverse_N"] == calls["mapper.PT"] == 8
    assert calls["mapper.prepare"] == calls["mapper.preprocess"] == calls["mapper.naive_map"] == 1
    assert calls["mapper.grid_to_map"] == 2
    assert np.isfinite(mapper.m.numpy()).all()


def _traced_names(tree) -> list:
    """(function, first argument node) of each call of ``span`` or
    ``count`` imported from maria_torch's io.logging in a module."""
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and (node.module or "").endswith("io.logging"):
            imported |= {a.asname or a.name for a in node.names if a.name in ("span", "count")}
    return [(node.func.id, node.args[0] if node.args else None) for node in ast.walk(tree)
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id in imported]


def test_span_names_are_documented():
    seen = set()
    for path in PACKAGE.rglob("*.py"):
        for func, arg in _traced_names(ast.parse(path.read_text())):
            where = f"{path.relative_to(PACKAGE)}: {func}()"
            assert isinstance(arg, ast.Constant) and isinstance(arg.value, str), f"{where} names no literal"
            name = arg.value
            assert NAME.match(name) and name.split(".")[0] in trace.SPAN_LAYERS, f"{where} {name!r}"
            assert not name.startswith(trace.SPAN_PREFIX)
            seen.add((func, name))
    spans = {name for func, name in seen if func == "span"}
    assert {"program.pointing", "atmosphere.sample", "noise", "noise.basis", "mapper.cg_step", "mapper.bin",
            "tod.to", "sim.run_obs"} <= spans
    assert {"mapper.ids", "mapper.postprocess"} <= spans
    assert {name for func, name in seen if func == "count"} == {
        "noise.basis_builds", "mapper.cg_steps", "atmosphere.layers_sampled", "mapper.host_copies",
        "atmosphere.screens"}


def test_profile_slice_reads_the_spans(program):
    """profile_slice's stage table comes from one run's spans, and its
    busy time is the union of device intervals (none on the CPU)."""
    from maria_torch.profile_slice import profiled, stage_table, union_ms

    fn = program.total_power_fn()
    wall, busy, _ = profiled(lambda: fn(seed=2, device="cpu"))
    table = stage_table(trace.trace_summary())
    assert wall > 0 and busy == 0.0
    assert "maria_torch.atmosphere.sample" in table and "atmosphere.layers_sampled" in table
    assert not trace.set_tracing(False)
    assert union_ms([(0, 1000), (500, 2000), (3000, 3500)]) == pytest.approx(2.5)
