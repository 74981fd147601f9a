"""photo_slam_tpu_torch/tools/synth_colmap.py against tools/
gen_synth_colmap.py (its main run in-process, its Pallas render
interpreted) at 3 views of 64x48: cameras.bin equal byte for byte, the
poses and names of images.bin equal, points3D.bin equal (the same draws
from the same stream), each image within one 8-bit level; then the
dataset read back by train_colmap's build_scene_from_colmap."""
import signal
import sys

import numpy as np
import pytest
import torch

from photo_slam_tpu_torch.config import Config
from photo_slam_tpu_torch.io import colmap
from photo_slam_tpu_torch.io.images import load_image_chw
from photo_slam_tpu_torch.tools import synth_colmap
from test_torch_blend import one_torch_thread  # noqa: F401

VIEWS, W, H = 3, 64, 48


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """(JAX tool's dataset, the port's) at VIEWS views of W x H. The JAX
    tool imports bench.py, which installs signal handlers: they are put
    back (tests/test_bench_quality.py:14-23)."""
    root = tmp_path_factory.mktemp("synth_colmap")
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    argv = sys.argv
    sys.argv = ["gen_synth_colmap.py", str(root / "jax"), str(VIEWS), str(W),
                str(H)]
    try:
        from tools import gen_synth_colmap
        gen_synth_colmap.main()
    finally:
        sys.argv = argv
        for s, h in old.items():
            signal.signal(s, h)
    port = synth_colmap.write(root / "port", VIEWS, W, H, device="cpu")
    return root / "jax", port


def test_bins_equal_the_jax_tool(datasets):
    jax_root, port_root = datasets
    js, ps = jax_root / "sparse" / "0", port_root / "sparse" / "0"
    assert (ps / "cameras.bin").read_bytes() == (
        js / "cameras.bin").read_bytes()
    jimg = colmap.read_images_bin(js / "images.bin")
    pimg = colmap.read_images_bin(ps / "images.bin")
    assert sorted(pimg) == sorted(jimg) == [1, 2, 3]
    for i in jimg:
        assert pimg[i].name == jimg[i].name == f"frame_{i - 1:04d}.png"
        assert pimg[i].camera_id == jimg[i].camera_id
        np.testing.assert_array_equal(pimg[i].quat_wxyz, jimg[i].quat_wxyz)
        np.testing.assert_array_equal(pimg[i].trans, jimg[i].trans)
    assert (ps / "images.bin").read_bytes() == (
        js / "images.bin").read_bytes()
    assert (ps / "points3D.bin").read_bytes() == (
        js / "points3D.bin").read_bytes()
    ids, xyz, _ = colmap.read_points3d_bin(ps / "points3D.bin")
    assert ids.shape == (synth_colmap.INIT_POINTS,)
    assert np.isfinite(xyz).all()


def test_images_within_one_level(datasets):
    jax_root, port_root = datasets
    for i in range(VIEWS):
        name = f"frame_{i:04d}.png"
        got = load_image_chw(port_root / "images" / name)
        want = load_image_chw(jax_root / "images" / name)
        assert got.shape == want.shape == (3, H, W)
        assert np.abs(got - want).max() <= 1.0 / 255 + 1e-6, name
        assert got.mean() > 0.05, f"{name} is blank"


def test_dataset_builds_the_train_colmap_scene(datasets):
    from photo_slam_tpu_torch.apps.train_colmap import \
        build_scene_from_colmap

    _, port_root = datasets
    scene, (xyz, rgb) = build_scene_from_colmap(port_root, Config(),
                                                device="cpu")
    assert len(scene.keyframes) == VIEWS
    cam = scene.cameras[1]
    assert (cam.width, cam.height) == (W, H)
    assert cam.fx == pytest.approx(0.55 * W) and cam.cx == W / 2 - 0.5
    assert xyz.shape == (synth_colmap.INIT_POINTS, 3)
    assert rgb.min() >= 0.0 and rgb.max() <= 1.0
    kf = scene.keyframes[1]
    # The default config's pyramid: two sub-levels below the full image.
    assert [lv.shape for lv in kf.pyramid] == [(3, H // 4, W // 4),
                                                (3, H // 2, W // 2)]
    assert isinstance(kf.matrices.viewmatrix, torch.Tensor)
