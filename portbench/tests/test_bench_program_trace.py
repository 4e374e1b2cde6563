"""The program's spans in a traced window (``portbench/program_trace.py``):
the correlation join on synthetic events, each per-layer reading on a
synthetic context (None where its span is absent), the coverage shares,
and the CMB patch's CPU rehearsal with the program's tracing on for the
window."""

import contextlib

import pytest
import torch

from portbench import program_trace as pt
from portbench import trace

HOST = {"pid": 1, "tid": 1}


def ann(name, ts, dur, **where):
    return {"name": name, "cat": "user_annotation", "ts": ts, "dur": dur, **{**HOST, **where}}


def call(name, ts, corr, cat="cuda_runtime", **where):
    return {"name": name, "cat": cat, "ts": ts, "dur": 2.0, "args": {"correlation": corr}, **{**HOST, **where}}


def kernel(name, ts, dur, corr):
    return {"name": name, "cat": "kernel", "ts": ts, "dur": dur, "pid": 0, "tid": 7, "args": {"correlation": corr}}


def events():
    """One realization: synthesis [10, 500) with the noise stage and its
    K3 draw, map [500, 900) with two CG steps; a launch through the CUDA
    driver API, a launch from a thread with no span, syncs in and out of
    the program's spans, and a kernel outside the window."""
    return [
        ann("portbench.window", 0.0, 1000.0),
        ann("portbench.synthesis", 10.0, 490.0),
        ann("maria_torch.noise", 20.0, 280.0),
        ann("maria_torch.noise.v", 30.0, 70.0),
        call("cudaLaunchKernel", 40.0, 1), kernel("k3", 200.0, 50.0, 1),  # under noise and noise.v
        call("cuLaunchKernel", 150.0, 2, cat="cuda_driver"), kernel("gemm", 260.0, 100.0, 2),  # under noise
        call("cudaStreamSynchronize", 250.0, 90),  # inside the program's span: counted
        call("cudaLaunchKernel", 400.0, 3), kernel("stray", 410.0, 10.0, 3),  # synthesis alone
        call("cudaStreamSynchronize", 480.0, 91),  # the harness's own: not counted
        call("cudaLaunchKernel", 50.0, 4, tid=2), kernel("other_thread", 430.0, 10.0, 4),
        ann("portbench.map", 500.0, 400.0),
        ann("maria_torch.mapper.cg_step", 520.0, 80.0),
        call("cudaLaunchKernel", 530.0, 5), kernel("p", 540.0, 20.0, 5),
        call("cudaLaunchKernel", 550.0, 6), kernel("pt", 570.0, 20.0, 6),
        ann("maria_torch.mapper.cg_step", 610.0, 90.0),
        call("cudaLaunchKernel", 620.0, 7), kernel("p", 640.0, 30.0, 7),
        call("cudaLaunchKernel", 650.0, 8), kernel("pt", 680.0, 40.0, 8),
        call("cudaLaunchKernel", 990.0, 9), kernel("late", 1200.0, 5.0, 9),
    ]


def ctx_of(evs, realizations=1, cuda=True, summary=None):
    return {"trace": {"program": pt.join(evs)}, "realizations": realizations, "cuda": cuda, "program": summary}


def test_join_puts_each_activity_under_its_launch_spans():
    joined = pt.join(events())
    names = [n for n, _, _ in joined["spans"]]
    under = {}
    for s, e, opened in joined["activities"]:
        under[(s, e)] = [names[j] for j in opened]
    assert under[(200.0, 250.0)] == ["portbench.synthesis", "maria_torch.noise", "maria_torch.noise.v"]
    assert under[(260.0, 360.0)] == ["portbench.synthesis", "maria_torch.noise"]  # a CUDA driver API launch
    assert under[(410.0, 420.0)] == ["portbench.synthesis"]
    assert under[(430.0, 440.0)] == []  # its launching thread opened no span
    assert (1200.0, 1205.0) not in under  # outside the window
    assert [(n, t) for n, t, _ in joined["syncs"]] == [("cudaStreamSynchronize", 250.0),
                                                       ("cudaStreamSynchronize", 480.0)]


def test_readings_on_a_synthetic_window():
    ctx = ctx_of(events(), realizations=2)
    assert pt.noise_device_ms(ctx) == pytest.approx(1e-3 * 150.0 / 2)  # [200, 250] and [260, 360]
    assert pt.device_ms_under(ctx, "maria_torch.noise.v") == pytest.approx(1e-3 * 50.0 / 2)
    assert pt.cg_step_ms(ctx) == pytest.approx(1e-3 * (50.0 + 80.0) / 2)  # extents [540, 590], [640, 720]
    assert pt.program_syncs_per_realization(ctx) == pytest.approx(0.5)
    assert pt.layer_sample_device_ms(ctx) is None  # no layer sampler in this window


def test_readings_without_the_programs_spans():
    bare = [e for e in events() if not e["name"].startswith("maria_torch.")]
    for read in (pt.layer_sample_device_ms, pt.noise_device_ms, pt.cg_step_ms, pt.program_syncs_per_realization):
        assert read(ctx_of(bare)) is None  # the program without spans
        assert read(ctx_of(events(), cuda=False)) is None  # a run on the CPU
        assert read({"trace": {}, "realizations": 1, "cuda": True}) is None  # a harness without the join
    assert pt.noise_basis_ms(ctx_of(events())) is None  # no summary
    summary = {"spans": {"maria_torch.noise.basis": {"calls": 4, "host_s": 0.06, "self_s": 0.06}}, "counters": {}}
    assert pt.noise_basis_ms(ctx_of(events(), realizations=2, summary=summary)) == pytest.approx(30.0)
    assert pt.noise_basis_ms(ctx_of(events(), summary={"spans": {}, "counters": {}})) is None


def test_coverage_shares():
    shares = pt.coverage(pt.join(events()))
    # launched inside the harness's spans: k3, gemm, stray and the four CG kernels; stray has no program span
    device = trace.union_length([(200, 250), (260, 360), (540, 560), (570, 590), (640, 670), (680, 720)])
    assert shares["device"] == pytest.approx(device / (device + 10.0))
    # idle inside [10, 900): [10, 200), [250, 260), [360, 410), [420, 430), [440, 540), [560, 570), [590, 640),
    # [670, 680), [720, 900); inside a program span: [20, 200), [250, 260), [520, 540), [560, 570), [590, 600),
    # [610, 640), [670, 680)
    idle = 190 + 10 + 50 + 10 + 100 + 10 + 50 + 10 + 180
    program = 180 + 10 + 20 + 10 + 10 + 30 + 10
    assert shares["idle"] == pytest.approx(program / idle)
    assert pt.coverage(pt.join([e for e in events() if not e["name"].startswith("portbench.s")
                                and e["name"] != "portbench.map"])) == {"device": None, "idle": None}


def test_cmb_patch_rehearsal_reads_the_noise_basis(monkeypatch, tmp_path):
    """The CMB patch at the rehearsal's size with the program's tracing on
    for the traced window alone: the basis's host time and its builds are
    read; the device's readings are left out on the CPU."""
    import maria_torch
    from maria_torch.io import logging as program_log
    from portbench import run
    from test_bench_cells_cpu import tiny

    monkeypatch.setattr(maria_torch.io, "_cache_state", {"base": str(tmp_path / "maria-torch-data")})
    profiler = trace.profiler

    @contextlib.contextmanager
    def with_program(cuda):
        program_log.reset_trace()
        with profiler(cuda) as prof, program_log.tracing():
            yield prof

    monkeypatch.setattr(trace, "profiler", with_program)
    cell = "act-cmb-patch.ml600-iqu"
    config, traffic, limits = tiny(cell)
    r = run.run_cell(cell, 2**31 + 99, 0.5, True, torch.device("cpu"), config, traffic, limits)
    summary = program_log.trace_summary()
    program_log.reset_trace()
    n = r["attempted"]
    ctx = {"program": summary, "realizations": n, "cuda": False, "trace": {}}
    assert pt.noise_basis_ms(ctx) > 0
    assert summary["counters"]["noise.basis_builds"] == 2 * n  # two bands, a basis each, every run()
    assert summary["counters"]["mapper.cg_steps"] == n * 2 * 25
    assert pt.noise_device_ms(ctx) is None and pt.cg_step_ms(ctx) is None
    assert {"synthesis_ms", "map_ms"} <= set(r["per_layer"])
