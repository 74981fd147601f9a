"""The benchmark's parts found by name: a Python file
<root>/port_bench/<folder>/<name>.py, loaded from its path.

The folders: `kinds` (a traffic mix's "kind": the loop a cell runs and its
check), `maps` and `views` (a configuration's map and training views, by
their "kind"), and `metrics` (a per-layer metric's reader). A later
benchmark adds one as a new file and edits none.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path


def module(root: Path, folder: str, name: str):
    """The module of <root>/port_bench/<folder>/<name>.py."""
    path = Path(root) / "port_bench" / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"port_bench: no {folder} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"port_bench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
