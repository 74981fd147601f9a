"""X3, the group-vectorized blend (photo_slam_tpu_torch/tools/
exp_blend_vec.py), against the JAX tool tools/exp_blend_vec.py run
interpreted on the CPU, and against the port's K1 plain version, which
computes the same function; plus the room scene the experiments share.

The JAX tools call pl.pallas_call without interpret=; `interpret` swaps the
tool module's `pl` for a namespace whose pallas_call runs interpreted, so
no file under tools/ changes. The other test_torch_exp_* files import these
helpers."""
import functools
import importlib
import importlib.util
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from photo_slam_tpu_torch.ops.blend import blend_fwd_plain
from photo_slam_tpu_torch.tools import bench_room
from photo_slam_tpu_torch.tools import exp_blend_vec as tx3
from test_torch_blend import one_torch_thread, packed_tiles  # noqa: F401

TOOLS = Path(__file__).resolve().parents[1] / "tools"


def tool_module(name):
    """Load a JAX experiment from the repository's tools/ directory by its
    file path, once per process, under a name of its own: sys.path is left
    as it was, so no later import resolves against tools/."""
    key = f"_jax_tool_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key,
                                                      TOOLS / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key]


def interpret(monkeypatch, module):
    """Run the module's pl.pallas_call interpreted for this test."""
    ns = types.SimpleNamespace(**vars(pl))
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(module, "pl", ns)


def assert_blend_close(got, want, atol=1e-5, nc_share=1e-4):
    """Colour and T within atol; n_contrib differs at no more than
    nc_share of the pixels."""
    gc, gt, gn = (np.asarray(x) for x in got)
    wc, wt, wn = (np.asarray(x) for x in want)
    assert gc.shape == wc.shape and gn.dtype == np.int32
    np.testing.assert_allclose(gc, wc, atol=atol, rtol=0)
    np.testing.assert_allclose(gt, wt, atol=atol, rtol=0)
    assert (gn != wn).mean() <= nc_share


jx3 = tool_module("exp_blend_vec")


def test_make_data_is_the_tools():
    data, counts = tx3.make_data(4, 64, 2, seed=3)
    j_data, j_counts = jx3.make_data(4, 64, 2, seed=3)
    np.testing.assert_array_equal(data, np.asarray(j_data))
    np.testing.assert_array_equal(counts, np.asarray(j_counts))


def test_plain_matches_jax_blend_vec(monkeypatch):
    """The tool's synthetic tiles, 2 tiles of K 128 (within 1e-5: the JAX
    kernel forms S by a roll-ladder prefix product and the colour by a
    matmul, the plain version by cumprod and a sum)."""
    interpret(monkeypatch, jx3)
    data, counts = tx3.make_data(2, 128, 2)
    want = jx3.blend_vec(data, counts, 2, 2)
    got = tx3.blend_vec(torch.from_numpy(data), torch.from_numpy(counts), 2,
                        2)
    assert_blend_close(got, want)
    assert (np.asarray(want[2]) > 0).mean() > 0.5


@pytest.mark.parametrize("case", ["synthetic", "saturating"])
def test_plain_matches_k1_plain(case):
    """X3 is K1's function with another rounding: on the tool's larger
    synthetic input (no pixel saturates) and on tiles whose pixels mostly
    stop early (group-level death), within K1's tolerances."""
    if case == "synthetic":
        data, counts = tx3.make_data(12, 512, 4, seed=1)
        tiles_x = 4
    else:
        data, counts = packed_tiles(6, 256, 3, seed=8)
        tiles_x = 3
    d, c = torch.from_numpy(data), torch.from_numpy(counts)
    want = blend_fwd_plain(d, c, tiles_x, d.shape[0])
    got = tx3.blend_vec_plain(d, c, tiles_x, d.shape[0])
    assert_blend_close(got, want)
    if case == "saturating":
        assert (want[1] < 1e-3).float().mean() > 0.1


def test_wrapper_device_and_main():
    data, counts = tx3.make_data(2, 64, 2)
    before = tx3.blend_vec.launches
    d, c = torch.from_numpy(data), torch.from_numpy(counts)
    for a, b in zip(tx3.blend_vec(d, c, 2, 2), tx3.blend_vec_plain(d, c, 2,
                                                                   2)):
        assert torch.equal(a, b)
    assert tx3.blend_vec.launches == before
    for bad in (d.to("meta"), d.double().to("meta")):
        with pytest.raises(ValueError):
            tx3.blend_vec(bad, c.to("meta"), 2, 2)


@pytest.mark.parametrize("module", ["exp_blend16", "exp_blend_vec",
                                    "exp_vpu_dtype", "exp_blend_bf16"])
def test_main_raises_without_a_card(module, monkeypatch):
    mod = importlib.import_module(f"photo_slam_tpu_torch.tools.{module}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--device", "cuda"])


def test_room_scene_is_the_tools():
    """The port's copy of the bench scene gives the JAX tool's arrays."""
    jroom = tool_module("bench_room")
    pts, cols = bench_room.room_scene(70_000, 0)
    j_pts, j_cols = jroom.room_scene(70_000, 0)
    np.testing.assert_array_equal(pts, j_pts)
    np.testing.assert_array_equal(cols, j_cols)
    assert pts.dtype == np.float32 and pts.shape == (70_000, 3)


def test_real_data_path_on_cpu():
    """The real-data path at a small size: the pass-1 tiles of the room
    through K1 and X3 on the CPU agree."""
    view = bench_room.room_view(70_000, device="cpu", width=96, height=64)
    t = bench_room.tiles32(view)
    assert t.data.shape == (t.num_tiles, 1024, 16) and t.num_tiles == 6
    res = tx3.compare("real", t.data, t.counts, t.tiles_x, t.num_tiles, 1,
                      log=lambda *a: None)
    assert res["diffs"]["color"] <= 1e-5 and res["diffs"]["T"] <= 1e-5
