"""No module of the benchmark imports JAX or the JAX package, and the
plain references import nothing of the program. Top-level module names
are compared whole: "maria_torch" begins with "maria_t", so a prefix
test would be wrong."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "maria_tpu"}
MODULES = sorted(p for p in PB.rglob("*.py"))
REFERENCE = sorted((PB / "reference").glob("*.py"))


def imported(path: Path) -> tuple:
    """(absolute top-level names, relative imports as (level, module))."""
    absolute, relative = set(), []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            absolute |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                relative.append((node.level, node.module))
            else:
                absolute.add(node.module.split(".")[0])
    return absolute, relative


def test_top_level_names_are_compared_whole():
    assert "maria_torch".split(".")[0] not in FORBIDDEN
    assert "maria_tpu.ops".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_anywhere(path):
    absolute, _ = imported(path)
    assert not absolute & FORBIDDEN, sorted(absolute & FORBIDDEN)


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    absolute, relative = imported(path)
    assert not absolute & (FORBIDDEN | {"maria_torch", "portbench"}), sorted(absolute)
    assert all(level == 1 for level, _ in relative), relative  # only its sibling modules


def test_reference_loads_with_the_program_blocked():
    code = (
        "import sys\n"
        "for name in ('maria_torch', 'maria_tpu', 'jax', 'jaxlib', 'flax'):\n"
        "    sys.modules[name] = None\n"
        "import portbench.reference.common, portbench.reference.scene, portbench.reference.total_power\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=PB.parent, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
