"""Build and load the hand-written CUDA kernels under csrc/.

Each `csrc/<name>.cu` exposes a plain C launcher (`<name>_launch`) and is
compiled by nvcc for sm_90a into its own shared library under
`<checkout>/build/torch_kernels/`, at first use, then loaded with ctypes.
A plain C interface keeps PyTorch's headers out of the build: nvcc takes
seconds per source, where a source that includes `torch/extension.h` takes
minutes. `build()` starts one nvcc per source, all at once, and waits for
them. Libraries are named by a hash of their source, the csrc/*.cuh
headers and the flags, so an edit rebuilds and a stale library is never
loaded.

Nothing here runs at import: this module is imported on machines without a
CUDA toolkit, where only the plain PyTorch versions of the kernels run.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"

# -Xptxas -v prints registers, shared memory and spills per kernel into the
# build log; no --use_fast_math, so expf is the full-precision exp and the
# kernels hold against their plain versions at float32 tolerances.
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-lineinfo", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# name -> argtypes of its C launcher `<name>_launch` (returns cudaError_t).
LAUNCHERS = {
    "blend_fwd": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "blend_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    "window_gather": [_P, _I, _P, _P, _I, _I, _P, _P],
    # The entry transpose in pointer form (ops/tiled.py), in index_add_'s
    # place: g, lists, P, n, k_dup, D, ptr scratch, repeats, out.
    "entry_sum": [_P, _P, _LL, _I, _I, _I, _P, _P, _P, _P],
    # Stereo path aggregation (ops/stereo.py), in OpenCV's StereoSGBM's place.
    "sgm": [_P, _I, _I, _P, _P],
    # The blend experiments (photo_slam_tpu_torch/tools/).
    "blend16_fwd": [_P, _P, _I, _I, _P, _P, _P, _P],
    "blend16_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    "blend_vec_fwd": [_P, _P, _I, _I, _I, _P, _P, _P, _P],
    "blend_bf16_fwd": [_P, _P, _I, _I, _I, _P, _P, _P, _P],
    "vpu_dtype": [_P, _P, _LL, _I, _I, _P],
    "vpu_dtype_exp": [_P, _P, _LL, _I, _I, _P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the kernels in " + str(CSRC_DIR))
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def nvcc_command(source: Path, output: Path) -> list[str]:
    """nvcc with the kernels' flags, compiling `source` (which may include
    the headers of csrc/ from any directory) into the library `output`."""
    return [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(output),
            str(source)]


def source_digest(source: bytes) -> str:
    """Hash of a kernel source, every csrc/*.cuh header it may include and
    the nvcc flags: a library built from them is named by it, so an edit
    to any of them rebuilds."""
    h = hashlib.sha256(source)
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(b"\0" + header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    return BUILD_DIR / f"{name}-{source_digest(src)}.so"


def build() -> dict[str, Path]:
    """Compile every kernel that is not built yet, one nvcc process per
    source, all started together. Raises with nvcc's output if any build
    fails. Returns {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in LAUNCHERS}
    procs = {}
    for n, p in paths.items():
        if not p.exists():
            tmp = p.with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (subprocess.Popen(
                nvcc_command(CSRC_DIR / f"{n}.cu", tmp),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        paths[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {proc.returncode})\n" + log)
            tmp.unlink(missing_ok=True)
        else:
            # Rename into place: a concurrent process never loads a partial
            # library.
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


@functools.lru_cache(maxsize=None)
def launcher(name: str):
    """The ctypes function `<name>_launch`, building the libraries if
    needed."""
    lib = ctypes.CDLL(str(build()[name]))
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = LAUNCHERS[name]
    fn.restype = ctypes.c_int
    return fn


def check_launch(name: str, err: int) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def launch(name: str, device, *args) -> None:
    """Call `<name>_launch(*args, stream)` on `device`'s current stream and
    raise on a CUDA error. The raw stream handle and the current device are
    read without building a Stream object or running the lazy-init check,
    and a device guard is entered only when `device` is not the current
    device: for a kernel of a few microseconds these cost more than it."""
    fn = launcher(name)
    args = (*args, torch._C._cuda_getCurrentRawStream(device.index))
    if device.index == torch._C._cuda_getDevice():
        err = fn(*args)
    else:
        with torch.cuda.device(device):
            err = fn(*args)
    check_launch(name, err)
