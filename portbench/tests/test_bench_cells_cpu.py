"""Every cell rehearsed on the CPU at a tiny size with the kernels' plain
versions: the harness's whole run but its look for a card, through the
same entries, references and checks. Also: the control and the faults
that a cell can have come out not correct; a configuration, a traffic
mix and a metric added as new files are picked up by name; and the
measuring command refuses to run without a card."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def tiny(cell: str):
    """(config, traffic, limits) of ``cell`` at the rehearsal's size: 19
    AtLAST beams in nine bands for 10 s; the CMB patch for 30 s over a
    CMB at nside 64. ``noise_scale_gap`` reads the noise's
    amplitude through the float32 total's rounding of the loading, which
    averages down with the samples: the rehearsal's 85,500 read 5e-4 to
    8e-4 (the cell's 1.5e8 under 1e-4), so it is held to 5e-3 here, 50
    times under the noise 25% too loud."""
    from portbench import run

    _, _, config, traffic, limits = run.cell_spec(cell)
    config, traffic = json.loads(json.dumps(config)), dict(traffic)
    if config["name"] == "atlast-50k":
        config["array"]["n"] = 19
        traffic["duration_s"] = 10.0
        return config, traffic, {**limits, "noise_scale_gap": 5e-3}
    config["sky"]["cmb_kwargs"] = {"nside": 64}
    traffic["duration_s"] = 30.0
    return config, traffic, limits


@pytest.fixture(autouse=True)
def private_cache(tmp_path, monkeypatch):
    import maria_torch

    monkeypatch.setattr(maria_torch.io, "_cache_state", {"base": str(tmp_path / "maria-torch-data")})


CELLS = ["atlast-50k.batch60-fieldmap", "act-cmb-patch.ml600-iqu"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearsal_is_correct(cell):
    from portbench import run

    config, traffic, limits = tiny(cell)
    r = run.run_cell(cell, 2**31 + 17, 0.5, False, torch.device("cpu"), config, traffic, limits)
    assert r["attempted"] >= 1 and r["checked"], r
    assert r["correct"], r["checks"]
    assert set(r["end_to_end"]) >= {"samples_per_s", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearsal_traced(cell):
    from portbench import run

    config, traffic, limits = tiny(cell)
    r = run.run_cell(cell, 99, 0.5, True, torch.device("cpu"), config, traffic, limits)
    # the device's metrics read nothing on the CPU and are left out, never 0
    assert {"synthesis_ms", "map_ms", "scene_setup_s"} <= set(r["per_layer"])
    assert not {"device_idle_pct", "k2_roofline", "noise_gemm_roofline"} & set(r["per_layer"])


def _faulty(entry, fault: str):
    """``entry.realize`` with the timed path broken underneath."""
    realize = entry.realize

    def broken(state, seed, span):
        if fault == "state_unchanged":  # every realization returns the same answer
            seed = 0
        out = realize(state, seed, span)
        if "m" in out:  # the CMB patch: its TOD's noise and its fitted map
            noise, m = out["tod"].data["noise"], out["m"]
            if fault == "half_left_out":
                noise[noise.shape[0] // 2:] = 0.0
            elif fault == "answer_altered":
                m[int(torch.argmax(out["hits"]))] += 20 * float(m.std())
            return out
        total = out["total"]
        if fault == "half_left_out":  # half of the detectors replaced by the mean of the rest
            total[total.shape[0] // 2:] = total[:total.shape[0] // 2].mean()
        elif fault == "answer_altered":  # one sample altered where it is produced
            total[3, 7] += 50 * float(total[3].std())
        elif fault == "noise_loud":  # the noise 25% too loud from the second realization on
            tabs = state["program"]._tensors(state["device"])
            if not state.get("loud"):
                tabs["row_scale"] = 1.25 * tabs["row_scale"]
                state["loud"] = True
        return out

    return broken


@pytest.mark.parametrize("cell, fault", [
    *((CELLS[0], f) for f in ("state_unchanged", "half_left_out", "answer_altered", "noise_loud")),
    *((CELLS[1], f) for f in ("state_unchanged", "half_left_out", "answer_altered")),
])
def test_faults_come_out_not_correct(cell, fault, monkeypatch):
    import importlib

    from portbench import run

    config, traffic, limits = tiny(cell)
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
    monkeypatch.setattr(entry, "realize", _faulty(entry, fault))
    r = run.run_cell(cell, 5, 0.5, False, torch.device("cpu"), config, traffic, limits)
    assert r["checked"] and not r["correct"], r["checks"]


@pytest.mark.parametrize("cell, kind", [(CELLS[0], "control"), (CELLS[0], "noise_loud"), (CELLS[0], "half_binned"),
                                        (CELLS[1], "control")])
def test_control_and_planted_faults_come_out_not_correct(cell, kind):
    """The control (the reference one step below the configuration's
    precision) and the faults that the calibration plants in the program."""
    import importlib

    from portbench import run

    config, traffic, limits = tiny(cell)
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
    state = entry.setup(config, traffic, 3, torch.device("cpu"))
    seed = run.realization_seed(3, 0)
    if kind == "control":
        out = entry.realize(state, seed, run.Spans(False, None))
        readings = entry.control(out, seed, torch.device("cpu"))
    else:
        readings = entry.fault(state, seed, torch.device("cpu"), kind)
    assert any(v > limits[k] for k, v in readings.items()), readings


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a metric and limits added as new
    files, and entries added to BENCHMARK.json, run with no file edited."""
    copy = tmp_path / "checkout"
    copy.mkdir()
    shutil.copytree(ROOT / "portbench", copy / "portbench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (copy / "portbench").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config, traffic, limits = tiny("atlast-50k.batch60-fieldmap")
    config["name"] = "atlast-19"
    (copy / "portbench/configs/atlast-19.json").write_text(json.dumps(config))
    (copy / "portbench/traffic/batch8-fieldmap.json").write_text(json.dumps({**traffic, "duration_s": 8.0}))
    (copy / "portbench/metrics/realizations_traced.py").write_text(
        "def read(ctx):\n    return float(ctx['realizations'])\n")
    (copy / "portbench/limits/atlast-19.batch8-fieldmap.json").write_text(json.dumps(limits))
    cell = "atlast-19.batch8-fieldmap"
    bench["configs"].append({"name": "atlast-19", "source": "https://example.org", "file":
                             "portbench/configs/atlast-19.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": cell, "config": "atlast-19", "traffic": "batch8-fieldmap", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "realizations_traced", "unit": "count", "better": "higher",
                               "source": "host_clock", "layer": "device", "moves": "samples_per_s",
                               "workloads": [cell]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys, torch\n"
        "import maria_torch\n"
        f"maria_torch.set_cache_dir({str(tmp_path / 'data')!r})\n"
        "from portbench import run\n"
        f"r = run.run_cell({cell!r}, 11, 0.3, True, torch.device('cpu'))\n"
        "print(json.dumps({'per_layer': sorted(r['per_layer']), 'correct': r['correct']}))\n"
    )
    env = {"PYTHONPATH": f"{copy}:{ROOT}", "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], cwd=copy, capture_output=True, text=True, timeout=600,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert "realizations_traced" in result["per_layer"] and result["correct"]
    for path, data in before.items():
        assert path.read_bytes() == data, path


def test_the_command_refuses_without_a_card(tmp_path):
    """With no card the command exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_command_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits non-zero and prints no result."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""
