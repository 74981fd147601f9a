"""X1, the bf16 blend (photo_slam_tpu_torch/tools/exp_blend_bf16.py),
against the JAX tool tools/exp_blend_bf16.py run interpreted on the CPU,
and against the f32 blend K1 as the tool compares them (PSNR)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photo_slam_tpu_torch.ops import blend as blend_mod
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


def bf16_rows(kind, n, rng):
    """Packed rows [n, 16] and their tiles' origins ox, oy [n] (f32, tiles
    of a 40 x 40 grid), each splat's ellipse edge at alpha = bf16(1/255)
    passing through or near its tile, where the box is hardest to hold:
    `threshold` with opacities within a few bf16 ulp (2^-15 there) of the
    threshold and a few f32 ulp off them, `degenerate` with b^2 / (a c)
    from 1 - 1e-4 to 0.8 (the bf16 box is unbounded above ~0.905),
    `far` with means 0-600 px outside the tile and the ellipse reaching in
    by a few px."""
    ox = (32.0 * rng.randint(0, 40, n)).astype(np.float32)
    oy = (32.0 * rng.randint(0, 40, n)).astype(np.float32)
    amin = tx1.ALPHA_MIN_BF16
    if kind == "threshold":
        o = amin + 2.0 ** -15 * rng.randint(-3, 4, n)
        o = o * (1 + 2.0 ** -23 * rng.randint(-4, 5, n))
    else:
        o = rng.uniform(0.01, 0.99, n)
    el = np.log(np.maximum(o, amin) / amin)
    th = rng.uniform(0, 2 * np.pi, n)
    if kind == "far":
        dist = 16.0 * np.sqrt(2) + rng.uniform(0, 600, n)
    else:
        dist = rng.uniform(0, 40, n)
    mx = ox + 16.0 + dist * np.cos(th)
    my = oy + 16.0 + dist * np.sin(th)
    # The axis of the ellipse towards the tile reaches it within +-3 px.
    reach = np.maximum(dist - 16.0 + rng.uniform(-3, 3, n), 2.0)
    s_long = reach / np.sqrt(2 * np.maximum(el, 1e-3))
    s_short = s_long * rng.uniform(0.2, 1.0, n)
    rows = np.zeros((n, 16), np.float32)
    rows[:, 0], rows[:, 1] = mx, my
    for i in range(n):
        rot = np.array([[np.cos(th[i]), -np.sin(th[i])],
                        [np.sin(th[i]), np.cos(th[i])]])
        conic = np.linalg.inv(rot @ np.diag([s_long[i] ** 2,
                                             s_short[i] ** 2]) @ rot.T)
        a, b, c = conic[0, 0], conic[0, 1], conic[1, 1]
        if kind == "degenerate":
            b = rng.choice([-1, 1]) * np.sqrt(a * c * (1 - 10.0 ** rng.uniform(
                -4, np.log10(0.2))))
        rows[i, 2:5] = a, b, c
    rows[:, 5] = o
    rows[:, 6:9] = rng.rand(n, 3)
    return rows, ox, oy


@pytest.mark.parametrize("kind", ["threshold", "degenerate", "far"])
def test_bf16_boxes_hold_every_pair_the_chain_takes(kind):
    """Every tile-local pixel at which X1's bf16 chain (power_alpha_bf16)
    takes a pair, power <= 0 and alpha >= bf16(1/255), lies inside the
    entry's box from entry_cull_boxes_bf16 (the plain cull_box_bf16 by
    which csrc/blend_bf16_fwd.cu skips its warps), on the tile's pixels
    and 32 px around them (all exact in bf16)."""
    rng = np.random.RandomState({"threshold": 31, "degenerate": 32,
                                 "far": 33}[kind])
    rows, ox, oy = bf16_rows(kind, 96, rng)
    pix = torch.arange(-32, 64, dtype=torch.float32)
    gy, gx = torch.meshgrid(pix, pix, indexing="ij")
    lx = gx.reshape(1, -1).to(torch.bfloat16)
    ly = gy.reshape(1, -1).to(torch.bfloat16)
    t, tox, toy = (torch.from_numpy(x) for x in (rows, ox, oy))
    power, alpha = tx1.power_alpha_bf16(t, tox[:, None], toy[:, None], lx, ly)
    taken = ((power <= 0) & (alpha >= tx1.ALPHA_MIN_BF16)).numpy()
    box = blend_mod.entry_cull_boxes_bf16(t, tox, toy).numpy()
    x, y = gx.reshape(-1).numpy(), gy.reshape(-1).numpy()
    inside = ((box[:, 0:1] <= x) & (x <= box[:, 1:2])
              & (box[:, 2:3] <= y) & (y <= box[:, 3:4]))
    assert not (taken & ~inside).any(), rows[(taken & ~inside).any(1), :6]
    bounded = np.isfinite(box).all(1)
    empty = box[:, 0] > box[:, 1]
    # The chain takes pairs in the tile region for most rows, and the box
    # bounds all of them but the degenerate ones past det' > 0.
    assert taken.any(1).mean() > 0.5
    if kind == "degenerate":
        b2 = rows[:, 3].astype(np.float64) ** 2 / (rows[:, 2] * rows[:, 4])
        assert not bounded[b2 > 0.91].any() and bounded[b2 < 0.9].all()
        assert 0 < bounded.mean() < 1
    else:
        assert (bounded | empty).all()
    o16 = torch.from_numpy(rows[:, 5]).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(empty, o16 < tx1.ALPHA_MIN_BF16)
    assert not taken[empty].any()
    if kind == "threshold":
        assert empty.any() and not empty.all()


def test_bf16_boxes_empty_and_unbounded_as_entry_cull_boxes():
    """entry_cull_boxes_bf16's empty box (opacity below the threshold) and
    unbounded box (a non-finite term, a <= 0, det' <= 0) where
    entry_cull_boxes has them too, and its one more unbounded case: an
    opacity or a tile-local mean of 2^64 or more. The threshold and the
    slack are those of csrc/cull_box.cuh's cull_box_bf16."""
    assert blend_mod.BF16_ALPHA_MIN == tx1.ALPHA_MIN_BF16
    base = np.array([40.0, 50.0, 0.1, 0.01, 0.2, 0.5], np.float32)
    cases = {"empty": (5, 0.001), "nan_mean": (0, np.nan),
             "inf_conic": (3, np.inf), "nan_opacity": (5, np.nan),
             "a_negative": (2, -0.1), "det_negative": (3, 0.2)}
    rows = np.zeros((len(cases) + 3, 16), np.float32)
    rows[:, :6] = base
    for i, (lane, v) in enumerate(cases.values()):
        rows[i, lane] = v
    rows[-3, 5] = 2.0 ** 70           # opacity past 2^64
    rows[-2, 0] = 2.0 ** 66           # mean past 2^64
    # rows[-1]: an ordinary splat.
    t = torch.from_numpy(rows)
    org = torch.full((len(rows),), 32.0)
    got = blend_mod.entry_cull_boxes_bf16(t, org, org).numpy()
    ref = blend_mod.entry_cull_boxes(t).numpy()
    inf = np.inf
    for i, name in enumerate(cases):
        want = [inf, -inf, inf, -inf] if name == "empty" else [
            -inf, inf, -inf, inf]
        np.testing.assert_array_equal(got[i], want, err_msg=name)
        np.testing.assert_array_equal(ref[i], want, err_msg=name)
    for i in (-3, -2):
        np.testing.assert_array_equal(got[i], [-inf, inf, -inf, inf])
        assert np.isfinite(ref[i]).all()
    # The ordinary splat: both boxes bounded, the bf16 one in the tile's
    # frame and no narrower than the f32 one shifted into it.
    assert np.isfinite(got[-1]).all()
    shifted = ref[-1] - 32.0
    assert got[-1][0] <= shifted[0] and got[-1][1] >= shifted[1]
    assert got[-1][2] <= shifted[2] and got[-1][3] >= shifted[3]
