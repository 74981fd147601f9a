"""Time the blend backward K2 against builds of its source with a part
knocked out, on the production pass-1 tiles, in turns.

The room scene (bench_room.room_view, 300,000 Gaussians, seed 0) binned at
32 px (k_dup 6, K 1024: [836, 1024, 16]), blended forward by K1, with
seeded random cotangents of the colour and of final_T. Each build is
checked against blend_bwd_plain as chip_smoke.py checks K2 (per-lane error
within 1e-4 of the lane's max, rows past counts_eff and lanes 9-15 zero),
then the builds are timed `--rounds` times in turns, each time the mean of
`--reps` launches from CUDA events. A knockout edits the checkout's
csrc/blend_bwd.cu by text (each edit must match exactly once) and is built
with the same nvcc flags as the kernel (kernels.NVCC_FLAGS):

  without-box  no per-entry box: a warp skips an entry only by n_contrib
               (cull_box is not called and the box test folds away).

    python -m photo_slam_tpu_torch.tools.time_blend_bwd --knockout without-box

Prints each build's registers and spills, then one JSON line: the card's
`nvidia-smi` name and power limit, and ms per round for each build.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess

import torch

from photo_slam_tpu_torch import kernels
from photo_slam_tpu_torch.ops import blend as blend_mod
from photo_slam_tpu_torch.tools import bench_room

RTOL = 1e-4
KNOCKOUTS = {
    "without-box": (
        ("      s_box[tid] = cull_box(r0.x, r0.y, r0.z, r0.w, r1.x, r1.y);\n",
         ""),
        ("const float4 box = s_box[i];",
         "const float4 box = make_float4(-CUDART_INF_F, CUDART_INF_F, "
         "-CUDART_INF_F, CUDART_INF_F);"),
    ),
}


def knockout_source(source: str, name: str) -> str:
    for old, new in KNOCKOUTS[name]:
        if source.count(old) != 1:
            raise ValueError(f"knockout {name}: {old!r} occurs "
                             f"{source.count(old)} times in blend_bwd.cu")
        source = source.replace(old, new)
    return source


def build(sources: dict[str, str]) -> dict[str, tuple]:
    """{name: (ctypes launcher, the build log's register lines)}, one nvcc
    per source, all started together."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        digest = hashlib.sha256(
            (src + "\0".join(kernels.NVCC_FLAGS)).encode()).hexdigest()[:16]
        cu = kernels.BUILD_DIR / f"blend_bwd_variant-{digest}.cu"
        so = cu.with_suffix(".so")
        cu.write_text(src)
        procs[name] = (subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), so)
    out = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} (exit {proc.returncode}):\n{log}")
        fn = ctypes.CDLL(str(so)).blend_bwd_launch
        fn.argtypes = kernels.LAUNCHERS["blend_bwd"]
        fn.restype = ctypes.c_int
        out[name] = (fn, [ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--knockout", action="append", default=[],
                    choices=sorted(KNOCKOUTS))
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_blend_bwd needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]

    source = (kernels.CSRC_DIR / "blend_bwd.cu").read_text()
    sources = {"checkout": source}
    for name in args.knockout:
        sources[name] = knockout_source(source, name)
    builds = build(sources)
    for name, (_, lines) in builds.items():
        for ln in lines:
            print(f"[time_blend_bwd] {name}: {ln}", flush=True)

    t = bench_room.tiles32(bench_room.room_view(device=dev))
    nb = t.num_tiles
    color, final_t, n_contrib = blend_mod.blend_fwd(t.data, t.counts,
                                                    t.tiles_x, nb)
    counts_eff = torch.minimum(t.counts, n_contrib.reshape(nb, -1).amax(-1)
                               ).to(torch.int32)
    gen = torch.Generator(device=dev).manual_seed(1)
    g_color = torch.randn(color.shape, generator=gen, device=dev)
    g_t = torch.randn(final_t.shape, generator=gen, device=dev)
    ids = torch.arange(nb, dtype=torch.int32, device=dev)
    inputs = (t.data, counts_eff, ids, final_t, n_contrib, g_color, g_t)
    want = blend_mod.blend_bwd_plain(t.data, counts_eff, final_t, n_contrib,
                                     g_color, g_t, t.tiles_x, nb)
    rows_past = (torch.arange(t.data.shape[1], device=dev)[None, :]
                 >= counts_eff[:, None])

    def call(fn):
        out = torch.empty_like(t.data)
        err = fn(*(x.data_ptr() for x in inputs), nb, t.data.shape[1],
                 t.tiles_x, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        kernels.check_launch("blend_bwd", err)
        return out

    for name, (fn, _) in builds.items():
        got = call(fn)
        err = (got - want).abs().amax(dim=(0, 1))[:9]
        scale = want.abs().amax(dim=(0, 1))[:9]
        rel = float((err / scale.clamp_min(1e-30)).max())
        if not (rel <= RTOL and bool((got[..., 9:] == 0).all())
                and bool((got[rows_past] == 0).all())):
            raise AssertionError(f"{name}: per-lane error / max {rel:.3e}, "
                                 f"or nonzero padding")
        print(f"[time_blend_bwd] {name}: per-lane error / lane max "
              f"{rel:.3e}", flush=True)

    ms = {name: [] for name in builds}
    for _ in range(args.rounds):
        for name, (fn, _) in builds.items():
            ms[name].append(bench_room.time_ms(lambda: call(fn), args.reps,
                                               dev))
    print(json.dumps({"card": smi, "tiles": list(t.data.shape),
                      "reps": args.reps, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
