"""Builds of a kernel's source with parts knocked out, or of another source
of it, for the timing tools (tools/time_blend.py, tools/time_sgm.py).

A knockout is a tuple of (old, new) text edits, each of which must match
the source exactly once. A variant is built with the kernels' nvcc flags
(kernels.nvcc_command, so csrc/'s headers are found) into
build/torch_kernels/, named by the digest of its source, and loaded with
the launcher `<launcher>_launch` and its ctypes signature from
kernels.LAUNCHERS.
"""
from __future__ import annotations

import ctypes
import subprocess

from photo_slam_tpu_torch import kernels


def knockout_source(source: str, edits, label: str) -> str:
    """`source` with each (old, new) edit applied; raises if an `old` does
    not occur exactly once."""
    for old, new in edits:
        if source.count(old) != 1:
            raise ValueError(f"knockout {label}: {old!r} occurs "
                             f"{source.count(old)} times in the source")
        source = source.replace(old, new)
    return source


def ptxas_lines(log: str) -> list[str]:
    """The register, shared memory and spill lines of an nvcc log."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def build(launcher: str, sources: dict[str, str]) -> dict[str, tuple]:
    """{name: (ctypes launcher, ptxas lines)} of each source, one nvcc per
    source, all started together; a failed build raises with its log."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        digest = kernels.source_digest(src.encode())
        cu = kernels.BUILD_DIR / f"{launcher}_variant-{digest}.cu"
        so = cu.with_suffix(".so")
        cu.write_text(src)
        procs[name] = (subprocess.Popen(
            kernels.nvcc_command(cu, so), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT), so)
    out = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} (exit {proc.returncode}):\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), f"{launcher}_launch")
        fn.argtypes = kernels.LAUNCHERS[launcher]
        fn.restype = ctypes.c_int
        out[name] = (fn, ptxas_lines(log))
    return out
