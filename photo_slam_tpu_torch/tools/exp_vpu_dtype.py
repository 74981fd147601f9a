"""X2: elementwise throughput, float32 against bf16, on the card.

Counterpart of tools/exp_vpu_dtype.py. If bf16 arithmetic runs at twice
the float32 rate (two elements per packed bf16x2 instruction), the blend
kernels' pixel-side chains could run in bf16 with f32 accumulation (X1).
Two chains over [num_blocks, 64, 1024] elements, each held in registers:
  X2a (`chain`, csrc/vpu_dtype.cu; the tool's make_kernel): INNER
      iterations of a = a b + one, b = max(b half, a - b);
  X2b (`exp_chain`, csrc/vpu_dtype_exp.cu; the kernel inside run_exp):
      EXP_STEPS steps of acc = acc + exp(-a) 0.01, a = a 1.01.
`chain_plain` and `exp_chain_plain` are their plain versions. The X2a chain
overflows (a reaches inf after ~10 iterations, then NaN): at INNER = 256
only its time means anything.

main() times both chains in both types on [512, 64, 1024] and prints
Tops/s (4 operations per iteration, as the tool counts) and Gexp/s.

    python -m photo_slam_tpu_torch.tools.exp_vpu_dtype [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from photo_slam_tpu_torch import kernels
from photo_slam_tpu_torch.tools.bench_room import parse_device, time_ms

ROWS = 64
P = 1024
INNER = 256     # X2a chain length
EXP_STEPS = 32  # X2b chain length
OPS_PER_ITER = 4  # X2a operations per element and iteration (the tool's)
DTYPES = (torch.float32, torch.bfloat16)


def chain_plain(x: torch.Tensor, inner: int = INNER) -> torch.Tensor:
    """X2a's chain in x's type, each operation rounded on its own."""
    one = torch.tensor(1.000001, dtype=x.dtype, device=x.device)
    half = torch.tensor(0.5, dtype=x.dtype, device=x.device)
    a = x
    b = a * half + one
    for _ in range(inner):
        a = a * b + one
        b = torch.maximum(b * half, a - b)
    return a + b


def exp_chain_plain(x: torch.Tensor, steps: int = EXP_STEPS) -> torch.Tensor:
    """X2b's chain in x's type; exp is the float exp rounded to the type."""
    c = torch.tensor(0.01, dtype=x.dtype, device=x.device)
    r = torch.tensor(1.01, dtype=x.dtype, device=x.device)
    a = x
    acc = a
    for _ in range(steps):
        acc = acc + torch.exp(-a.float()).to(x.dtype) * c
        a = a * r
    return acc


def _launch_chain(kernel: str, wrapper, x: torch.Tensor, count: int):
    if x.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: unsupported device {x.device}")
    if (x.dtype not in DTYPES or not x.is_contiguous()
            or (x.dtype == torch.bfloat16
                and (x.numel() % 2 or x.data_ptr() % 4))):
        raise ValueError(f"{wrapper.__name__}: expected a contiguous float32 "
                         f"or bfloat16 tensor (bf16: an even number of "
                         f"elements, 4-byte aligned), got {x.dtype} "
                         f"{tuple(x.shape)}")
    out = torch.empty_like(x)
    fn = kernels.launcher(kernel)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(), count,
                 int(x.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
    kernels.check_launch(kernel, err)
    wrapper.launches += 1
    return out


def chain(x: torch.Tensor, inner: int = INNER) -> torch.Tensor:
    """X2a on float32 or bf16 elements. On a CUDA tensor it launches
    csrc/vpu_dtype.cu (or raises); on a CPU tensor it runs chain_plain.
    `chain.launches` counts kernel launches."""
    if x.device.type == "cpu":
        return chain_plain(x, inner)
    return _launch_chain("vpu_dtype", chain, x, inner)


chain.launches = 0


def exp_chain(x: torch.Tensor, steps: int = EXP_STEPS) -> torch.Tensor:
    """X2b on float32 or bf16 elements. On a CUDA tensor it launches
    csrc/vpu_dtype_exp.cu (or raises); on a CPU tensor it runs
    exp_chain_plain. `exp_chain.launches` counts kernel launches."""
    if x.device.type == "cpu":
        return exp_chain_plain(x, steps)
    return _launch_chain("vpu_dtype_exp", exp_chain, x, steps)


exp_chain.launches = 0


def inputs(dtype, num_blocks: int = 512, *, device, scale: float = 0.001):
    """[num_blocks, 64, 1024] uniform [0, scale) inputs from
    np.random.RandomState(0), made in float32 and rounded to `dtype` (the
    tool scales X2a's by 0.001 and leaves X2b's unscaled)."""
    x = (np.random.RandomState(0).rand(num_blocks, ROWS, P) * scale).astype(
        np.float32)
    return torch.as_tensor(x, device=device).to(dtype)


def run(dtype, num_blocks: int = 512, reps: int = 30, *, device,
        log=print) -> dict:
    """Time X2a on [num_blocks, 64, 1024] (tool :36-59)."""
    x = inputs(dtype, num_blocks, device=device)
    ms = time_ms(lambda: chain(x), reps, device)
    ops = num_blocks * ROWS * P * INNER * OPS_PER_ITER
    tops = ops / (ms * 1e-3) / 1e12
    log(f"{str(dtype):16s} {ms:9.4f} ms  {tops:7.2f} Tops/s")
    return dict(x=x, ms=ms, ops=ops, tops=tops)


def run_exp(dtype, num_blocks: int = 512, reps: int = 30, *, device,
            log=print) -> dict:
    """Time X2b on [num_blocks, 64, 1024] (tool :62-92)."""
    x = inputs(dtype, num_blocks, device=device, scale=1.0)
    ms = time_ms(lambda: exp_chain(x), reps, device)
    exps = num_blocks * ROWS * P * EXP_STEPS
    gexps = exps / (ms * 1e-3) / 1e9
    log(f"exp {str(dtype):16s} {ms:9.4f} ms  {gexps:8.1f} Gexp/s")
    return dict(x=x, ms=ms, exps=exps, gexps=gexps)


def main(argv=None):
    device = parse_device(argv, "X2: float32 against bf16 elementwise and "
                          "exp throughput")
    blocks, reps = (512, 30) if device.type == "cuda" else (8, 1)
    for dtype in DTYPES:
        run(dtype, blocks, reps, device=device)
    for dtype in DTYPES:
        run_exp(dtype, blocks, reps, device=device)


if __name__ == "__main__":
    main()
