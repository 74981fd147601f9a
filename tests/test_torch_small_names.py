"""The last small names of the JAX package's surface, in the port against
their JAX counterparts on identical inputs: save_trajectory_tum (the same
file, byte for byte), SequenceInfo, quat_to_rotmat_nonorm and sh_to_rgb_dc
(float32, 1e-6), Keyframe.image_width and image_height."""
import dataclasses

import numpy as np
import torch

from photo_slam_tpu.apps import online_slam as japp
from photo_slam_tpu.io import datasets as jdatasets
from photo_slam_tpu.models.camera import Camera as JCamera
from photo_slam_tpu.models.keyframe import Keyframe as JKeyframe
from photo_slam_tpu.ops import sh as jsh
from photo_slam_tpu.utils import math as jmath
from photo_slam_tpu_torch.apps import online_slam as tapp
from photo_slam_tpu_torch.io import datasets as tdatasets
from photo_slam_tpu_torch.models.camera import PINHOLE
from photo_slam_tpu_torch.models.camera import Camera as TCamera
from photo_slam_tpu_torch.models.keyframe import Keyframe as TKeyframe
from photo_slam_tpu_torch.ops import sh as tsh
from photo_slam_tpu_torch.utils import math as tmath

CAM = dict(camera_id=0, model_id=PINHOLE, width=320, height=240, fx=260.0,
           fy=250.0, cx=160.0, cy=120.0)


def test_save_trajectory_tum_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    frames = {}
    for fid in (7, 0, 3, 12):
        q = rng.normal(size=4)
        frames[fid] = (q / np.linalg.norm(q), rng.normal(0, 2, 3))
    for mod, cam_cls, kf_cls, name in (
            (japp, JCamera, JKeyframe, "jax"),
            (tapp, TCamera, TKeyframe, "port")):
        kfs = {}
        for fid, (q, t) in frames.items():
            kf = kf_cls(fid=fid, camera=cam_cls(**CAM))
            kf.quat, kf.trans = q, t
            kfs[fid] = kf
        mod.save_trajectory_tum(tmp_path / name / "traj.txt", kfs)
    got = (tmp_path / "port" / "traj.txt").read_bytes()
    assert got == (tmp_path / "jax" / "traj.txt").read_bytes()
    assert [int(r.split()[0]) for r in got.decode().splitlines()] == [
        0, 3, 7, 12]


def test_sequence_info_matches_jax():
    fields = [(f.name, f.default) for f in
              dataclasses.fields(tdatasets.SequenceInfo)]
    assert fields == [(f.name, f.default) for f in
                      dataclasses.fields(jdatasets.SequenceInfo)]
    info = tdatasets.SequenceInfo(TCamera(**CAM), 42)
    assert (info.num_frames, info.depth_scale) == (42, 1.0)
    assert info.camera.width == 320


def test_quat_to_rotmat_nonorm_matches_jax():
    rng = np.random.default_rng(1)
    q = (rng.normal(size=(200, 4)) * rng.uniform(0.2, 3.0, (200, 1))).astype(
        np.float32)
    got = tmath.quat_to_rotmat_nonorm(torch.from_numpy(q)).numpy()
    want = np.asarray(jmath.quat_to_rotmat_nonorm(q))
    assert got.shape == (200, 3, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # Without normalization: a unit quaternion gives a rotation, a longer
    # one does not, unlike quat_to_rotmat.
    unit = q / np.linalg.norm(q, axis=1, keepdims=True)
    R = tmath.quat_to_rotmat_nonorm(torch.from_numpy(unit)).numpy()
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-5)
    np.testing.assert_allclose(tmath.quat_to_rotmat(torch.from_numpy(q))
                               .numpy(), R, atol=1e-5)


def test_sh_to_rgb_dc_matches_jax():
    rng = np.random.default_rng(2)
    sh = rng.normal(0, 1.5, (50, 1, 3)).astype(np.float32)
    got = tsh.sh_to_rgb_dc(torch.from_numpy(sh)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsh.sh_to_rgb_dc(sh)),
                               rtol=1e-6, atol=1e-6)
    rgb = torch.from_numpy(rng.uniform(0, 1, (50, 3)).astype(np.float32))
    np.testing.assert_allclose(tsh.sh_to_rgb_dc(tsh.rgb_to_sh(rgb)).numpy(),
                               rgb.numpy(), atol=1e-6)


def test_keyframe_image_size_matches_jax():
    cam = dict(CAM, width=1200, height=680)
    port = TKeyframe(fid=0, camera=TCamera(**cam))
    jax = JKeyframe(fid=0, camera=JCamera(**cam))
    assert (port.image_width, port.image_height) == (
        jax.image_width, jax.image_height) == (1200, 680)
