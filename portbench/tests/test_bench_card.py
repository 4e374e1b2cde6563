"""The benchmark's command on the card: one short run of each cell, its
result line and its check. Skips where there is no card.

    python -m pytest portbench/tests -q -m cuda
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell, trace):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell, "--seed", str(2**31 + 101),
                          "--seconds", "2", "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert list(result)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert len(result["breakdown"]["device_ops"]) <= 10
    else:
        assert "setup_s" in result["metrics"] and "samples_per_s" in result["metrics"]
