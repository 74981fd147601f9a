"""The harness end to end on the CPU at a tiny size: a cell whose
configuration, traffic mix, limits, kind, generators and per-layer metric
exist only as new files is found by name and run, and comes out correct;
with the timed path broken underneath, `correct` comes out false."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from port_bench import run
from port_bench.tests import tinyroot

SEED = 2 ** 31 + 977   # wider than 32 signed bits


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tinyroot.make(tmp_path_factory.mktemp("bench"))


def run_tiny(root, cell, trace=False):
    return run.run_cell(root, cell, SEED, 0.5, trace, "cpu")


@pytest.mark.parametrize("cell, e2e", [
    ("tinyroom.tinytrain", {"train_it_s", "setup_s"}),
    ("tinyroom.tinyview", {"view_fps", "setup_s"}),
    ("tinywall.tinykind", {"tiny_frames", "setup_s"})])
def test_cell_found_by_its_files_and_correct(root, cell, e2e):
    r = run_tiny(root, cell)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == e2e
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


def test_new_metric_read_by_name(root):
    """A traced run reports the per-layer metric that only the test's own
    reader file (port_bench/metrics/tiny_count.py under its root) gives."""
    r = run_tiny(root, "tinyroom.tinytrain", trace=True)
    assert set(r["metrics"]) == {"tiny_count"}
    assert r["metrics"]["tiny_count"]["value"] == r["attempted"]


def test_new_kind_and_generators_found_by_their_files(root):
    """The kind, map and views of tinywall.tinykind exist only under the
    test's root; the run drives them and reports the kind's own metric."""
    spec = run.load_cell(root, "tinywall.tinykind")
    assert spec["kind"].__file__ == str(root / "port_bench/kinds/tinykind.py")
    r = run_tiny(root, "tinywall.tinykind")
    assert r["correct"], r["checks"]
    assert r["metrics"]["tiny_frames"]["value"] == r["attempted"] > 0


@pytest.mark.parametrize("config", ["tinyroom", "tinywall"])
def test_same_seed_same_inputs(root, config):
    import json

    from port_bench import scenes

    cfg = json.loads((root / f"port_bench/configs/{config}.json")
                     .read_text())
    maps = [scenes.make_map(root, cfg["map"], torch.Generator()
                            .manual_seed(SEED % 2 ** 63), "cpu")
            for _ in range(2)]
    for k in maps[0]:
        assert torch.equal(maps[0][k], maps[1][k])
    rngs = [np.random.default_rng(SEED) for _ in range(2)]
    a, b = (scenes.views(root, cfg["views"], g) for g in rngs)
    assert len(a) == len(b) > 0
    for (qa, ta), (qb, tb) in zip(a, b):
        assert np.array_equal(qa, qb) and np.array_equal(ta, tb)


def unchanged_step(params, grads, opt_state, lrs, live):
    return params, opt_state


def half_rows_loss(pred, gt, lambda_dssim):
    from photo_slam_tpu_torch.ops import losses

    h = pred.shape[1] // 2
    return (1.0 - lambda_dssim) * losses.l1_loss(pred[:, :h], gt[:, :h]) \
        + lambda_dssim * (1.0 - losses.ssim(pred[:, :h], gt[:, :h]))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch"])
def test_broken_training_step_is_not_correct(root, monkeypatch, fault):
    from photo_slam_tpu_torch.models import optimizer
    from photo_slam_tpu_torch.ops import losses

    if fault == "state_unchanged":
        monkeypatch.setattr(optimizer, "adam_step", unchanged_step)
    else:
        monkeypatch.setattr(losses, "training_loss", half_rows_loss)
    r = run_tiny(root, "tinyroom.tinytrain")
    assert not r["correct"], r["checks"]


def test_altered_frame_is_not_correct(root, monkeypatch):
    """Every frame that the view service produces one row off."""
    from photo_slam_tpu_torch.mapper.mapper import GaussianMapper

    render = GaussianMapper.render_from_pose

    def shifted(self, *a, **k):
        return np.roll(render(self, *a, **k), 1, axis=1)

    monkeypatch.setattr(GaussianMapper, "render_from_pose", shifted)
    r = run_tiny(root, "tinyroom.tinyview")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("tf32", [False, True])
def test_precision_as_the_configuration_states(tf32):
    """The TF32 flags follow the configuration's "precision"; the
    reference's products stay float32 inside `exact`; a dtype the program
    does not run is refused."""
    from port_bench import cells

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        cells.set_precision({"precision": {"dtype": "float32",
                                           "tf32": tf32}})
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        assert torch.backends.cudnn.allow_tf32 is tf32
        with cells.exact():
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cudnn.allow_tf32 is tf32
        with pytest.raises(ValueError):
            cells.set_precision({"precision": {"dtype": "bfloat16",
                                               "tf32": False}})
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
