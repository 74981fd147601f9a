"""No run loads JAX or the JAX package, and the reference loads nothing of
the program."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from port_bench import run

BENCH = Path(__file__).resolve().parents[1]


def imported(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "photo_slam_tpu_torch_fake", sys)
    assert "photo_slam_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "photo_slam_tpu.ops", sys)
    assert run.forbidden_modules() == ["photo_slam_tpu.ops"]


def test_no_source_names_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not imported(path) & {"jax", "jaxlib", "flax",
                                     "photo_slam_tpu"}, path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "photo_slam_tpu_torch" not in imported(path), path
    code = ("import sys, port_bench.reference.train, port_bench.roofline; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         cwd=BENCH.parent).stdout
    assert "photo_slam_tpu_torch" not in out and "jax" not in out


def test_a_run_loads_no_jax():
    """A tiny run of both kinds in a fresh process loads nothing forbidden."""
    code = (
        "import sys, tempfile, pathlib, torch; torch.set_num_threads(2)\n"
        "from port_bench import run\n"
        "from port_bench.tests import tinyroot\n"
        "root = tinyroot.make(pathlib.Path(tempfile.mkdtemp()), poses=4)\n"
        "for c in ('tinyroom.tinytrain', 'tinyroom.tinyview'):\n"
        "    run.run_cell(root, c, 3, 0.2, False, 'cpu')\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         cwd=BENCH.parent).stdout
    assert out.strip().splitlines()[-1] == "[]"
