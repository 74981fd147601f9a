"""The port's serving entry point and checkpoint I/O: the view_result CLI
on the CPU against the JAX app, PLY files crossing between the packages
bit for bit, and the port importing with JAX blocked."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from photo_slam_tpu.config import Config as JConfig
from photo_slam_tpu.utils import ply as jply
from photo_slam_tpu_torch.apps import view_result as tview
from photo_slam_tpu_torch.config import Config
from photo_slam_tpu_torch.io.images import load_image_chw
from photo_slam_tpu_torch.utils import ply as tply

REPO = Path(__file__).resolve().parent.parent


def checkpoint_arrays(n=300, k_rest=15, seed=0):
    rng = np.random.RandomState(seed)
    xyz = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                    rng.uniform(2.5, 6.0, n)], 1).astype(np.float32)
    return (xyz,
            rng.randn(n, 1, 3).astype(np.float32),
            (rng.randn(n, k_rest, 3) * 0.2).astype(np.float32),
            rng.randn(n, 1).astype(np.float32),
            np.log(rng.uniform(0.03, 0.15, (n, 3))).astype(np.float32),
            rng.randn(n, 4).astype(np.float32))


@pytest.mark.parametrize("writer,reader", [(tply, jply), (jply, tply)])
def test_ply_crosses_packages_bit_exact(tmp_path, writer, reader):
    arrays = checkpoint_arrays(k_rest=8)
    path = tmp_path / "map.ply"
    writer.save_gaussian_ply(path, *arrays)
    back = reader.load_gaussian_ply(path)
    for a, b in zip(arrays, back):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    other = tmp_path / "again.ply"
    reader.save_gaussian_ply(other, *back)
    assert other.read_bytes() == path.read_bytes()


def test_load_state_matches_jax_trainer(tmp_path):
    from photo_slam_tpu.mapper.trainer import GaussianTrainer
    from photo_slam_tpu.models.scene import Scene

    path = tmp_path / "map.ply"
    tply.save_gaussian_ply(path, *checkpoint_arrays(k_rest=3))
    trainer = GaussianTrainer(JConfig(), Scene())
    trainer.load_ply(path)
    state, sh = tview.load_state(path, Config(), device="cpu")
    assert sh == trainer.default_sh == 1
    assert state.capacity == trainer.state.capacity
    np.testing.assert_array_equal(state.live.numpy(),
                                  np.asarray(trainer.state.live))
    for name, arr in trainer.state.params._asdict().items():
        np.testing.assert_array_equal(getattr(state.params, name).numpy(),
                                      np.asarray(arr))


def test_view_result_cli_matches_jax_app(tmp_path):
    from photo_slam_tpu.apps import view_result as jview

    path = tmp_path / "map.ply"
    tply.save_gaussian_ply(path, *checkpoint_arrays())
    args = ["--ply", str(path), "--width", "96", "--height", "64",
            "--fx", "80", "--fy", "80", "--max-views", "2"]
    tview.main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    jview.main(args + ["--out", str(tmp_path / "jax")])
    names = sorted(p.name for p in (tmp_path / "port").glob("*.png"))
    assert names == ["sweep_000.png", "sweep_001.png"]
    assert names == sorted(p.name for p in (tmp_path / "jax").glob("*.png"))
    for name in names:
        a = load_image_chw(tmp_path / "port" / name)
        b = load_image_chw(tmp_path / "jax" / name)
        assert a.shape == (3, 64, 96) and a.max() > 0.05
        # 8-bit files: a 1e-7 difference can round to the next level.
        assert np.abs(a - b).max() <= 1.0 / 255.0 + 1e-6


def test_view_result_requires_available_device(tmp_path):
    path = tmp_path / "map.ply"
    tply.save_gaussian_ply(path, *checkpoint_arrays(n=10))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tview.main(["--ply", str(path), "--out", str(tmp_path / "o")])


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['photo_slam_tpu'] = None\n"
        "import photo_slam_tpu_torch\n"
        "import photo_slam_tpu_torch.ops.render\n"
        "import photo_slam_tpu_torch.apps.view_result\n"
        "import photo_slam_tpu_torch.apps.train_colmap\n"
        "import photo_slam_tpu_torch.mapper.trainer\n"
        "import photo_slam_tpu_torch.models.densify\n"
        "import photo_slam_tpu_torch.models.optimizer\n"
        "import photo_slam_tpu_torch.kernels\n"
        "import photo_slam_tpu_torch.mapper.mapper\n"
        "import photo_slam_tpu_torch.mapper.mapping_ops\n"
        "import photo_slam_tpu_torch.mapper.recorder\n"
        "import photo_slam_tpu_torch.tracking.gt_tracker\n"
        "import photo_slam_tpu_torch.apps.online_slam\n"
        "import photo_slam_tpu_torch.apps.replay_stream\n"
        "import photo_slam_tpu_torch.io.datasets\n"
        "import photo_slam_tpu_torch.tools.synth_replica\n"
        "import photo_slam_tpu_torch.models.transforms\n"
        "import photo_slam_tpu_torch.ops.point_ops\n"
        "import photo_slam_tpu_torch.ops.depth_ops\n"
        "import photo_slam_tpu_torch.utils.trajectory\n"
        "import photo_slam_tpu_torch.utils.profiling\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m, v in\n"
        "               sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
