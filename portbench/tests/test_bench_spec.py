"""BENCHMARK.json against the benchmark's rules: names, units, keys,
and the files that the harness finds by name."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PB = ROOT / "portbench"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer", "moves", "workloads"}


def names():
    out = [c["name"] for c in BENCH["configs"]]
    out += [w[k] for w in BENCH["workloads"] for k in ("name", "config", "traffic")]
    out += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    out += [k for c in BENCH["configs"] for k in c["reduced"]]
    return out


@pytest.mark.parametrize("name", names())
def test_name_is_plain(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    assert set(metric) <= METRIC_KEYS
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    all_names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    all_names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(all_names) == len(set(all_names))


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        reported = [m for m in e2e.values() if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2


def test_per_layer_metrics_move_a_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_exist(cell):
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    config = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert (ROOT / config["file"]).is_file() and config["file"].startswith("portbench/")
    traffic = json.loads((PB / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (PB / "entries" / f"{traffic['entry']}.py").is_file()
    assert (PB / "limits" / f"{cell['name']}.json").is_file()
    assert any(cell["name"] in m.get("workloads", [cell["name"]]) for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_exists(metric):
    assert (PB / "metrics" / f"{metric['name']}.py").is_file()


def test_roofline_names():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
            assert (PB / "kernels" / f"{m['name'][:-len('_roofline')]}.py").is_file()
