"""X1, the bf16 blend (photo_slam_tpu_torch/tools/exp_blend_bf16.py),
against the JAX tool tools/exp_blend_bf16.py run interpreted on the CPU,
and against the f32 blend K1 as the tool compares them (PSNR)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photo_slam_tpu_torch.ops.blend import blend_fwd_plain
from photo_slam_tpu_torch.tools import exp_blend_bf16 as tx1
from photo_slam_tpu_torch.tools.bench_room import psnr_max_diff
from test_torch_blend import one_torch_thread, packed_tiles  # noqa: F401
from test_torch_exp_blend_vec import assert_blend_close, interpret, tool_module

jx1 = tool_module("exp_blend_bf16")


def one_tile(seed, count=60):
    """One tile (origin 0, 0) of K 64 packed entries: tile 1 of a 1x2 grid
    of packed_tiles moved up by 32 px."""
    data, _ = packed_tiles(2, 64, 1, seed)
    d = data[1:2].copy()
    d[..., 1] -= 32.0
    return d, np.array([count], np.int32)


@pytest.mark.parametrize("seed", [0, 2])
def test_plain_matches_jax_call_bf16(seed, monkeypatch):
    """Colour and T within 1e-6 and n_contrib equal (measured on these
    tiles: colour 1.2e-7, T and n_contrib exact; both sides round each bf16
    operation and the exp's result to bf16). Seed 2 saturates half of the
    pixels, so the stop at 1e-4 is exercised."""
    interpret(monkeypatch, jx1)
    data, counts = one_tile(seed)
    want = jx1.call_bf16(jnp.asarray(data), jnp.asarray(counts), 1, 1)
    before = tx1.call_bf16.launches
    got = tx1.call_bf16(torch.from_numpy(data), torch.from_numpy(counts), 1,
                        1)
    assert tx1.call_bf16.launches == before
    assert_blend_close(got, want, atol=1e-6, nc_share=0.0)


def test_bf16_against_f32_psnr():
    """bf16 inner math against K1's f32 on six saturating tiles: the tool's
    colour PSNR, and how far T and n_contrib move."""
    data, counts = packed_tiles(6, 256, 3, seed=1)
    d, c = torch.from_numpy(data), torch.from_numpy(counts)
    f32 = blend_fwd_plain(d, c, 3, 6)
    bf = tx1.call_bf16_plain(d, c, 3, 6)
    psnr, max_d = psnr_max_diff(f32[0], bf[0])
    assert 50.0 < psnr < 80.0, psnr   # 59.6 dB measured
    assert max_d < 0.05
    assert float((f32[1] - bf[1]).abs().max()) < 0.05
    assert float((f32[2] != bf[2]).float().mean()) < 0.1   # 4.5 %


def test_wrapper_raises_off_the_cpu():
    data, counts = one_tile(0)
    d, c = torch.from_numpy(data), torch.from_numpy(counts)
    for bad in (d.to("meta"), d.double().to("meta")):
        with pytest.raises(ValueError):
            tx1.call_bf16(bad, c.to("meta"), 1, 1)
    assert tx1.ALPHA_MAX_BF16 == 0.98828125
    assert tx1.ALPHA_MIN_BF16 == 0.003936767578125
