"""The port's semi-global matching (photo_slam_tpu_torch/ops/stereo.py)
against OpenCV's StereoSGBM as the JAX package calls it
(cv2.StereoSGBM_create(0, 128, 5), output / 16), and the stereo path of
the port's mapper against the JAX mapper.

The port computes SGBM's integer function, so its plain version must give
OpenCV's disparities; the stated bounds (of the pixels OpenCV marks valid,
at least 95 % valid in the port and within 1 px; validity agreeing on at
least 95 % of pixels) hold, and so does bit equality, which is what the
port measures (PERF.md). The mapper's stereo densify then reproduces the
JAX mapper's points and colours within 1e-6, with OpenCV's SGBM swapped
into the port and with the port's own SGM; the scenarios of
tests/test_stereo.py run on the port's mapper."""
import numpy as np
import pytest
import torch

from photo_slam_tpu.mapper import mapper as jmapper
from photo_slam_tpu.mapper.mapping_ops import KeyframeData as JKeyframeData
from photo_slam_tpu.models.camera import Camera as JCamera
from photo_slam_tpu_torch.config import Config
from photo_slam_tpu_torch.mapper.mapper import GaussianMapper, SensorType
from photo_slam_tpu_torch.mapper.mapping_ops import KeyframeData
from photo_slam_tpu_torch.models.camera import PINHOLE, Camera
from photo_slam_tpu_torch.ops import stereo
from test_stereo import BASELINE, DEPTH, FX, H, W, make_pair
from test_torch_blend import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

AGREE = 0.95


def cv2_disparity(left_u8, right_u8, device=None):
    return cv2.StereoSGBM_create(
        minDisparity=0, numDisparities=128, blockSize=5).compute(
            left_u8, right_u8).astype(np.float32) / 16.0


def slanted_pair(seed=0, h=240, w=320):
    """A textured surface whose disparity grows from 8 px at the top to
    70 px at the bottom, with independent noise in each eye."""
    rng = np.random.default_rng(seed)
    tex = cv2.GaussianBlur(rng.random((h, w + 160)).astype(np.float32),
                           (7, 7), 1.5)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    left = tex[:, 150:150 + w]
    right = np.stack([tex[y, 150 - int(8 + 62 * y / h):][:w]
                      for y in range(h)])
    noise = rng.normal(0, 0.01, (2, h, w))
    return tuple(np.clip(255 * (img + n), 0, 255).astype(np.uint8)
                 for img, n in zip((left, right), noise))


def plane_pair():
    left, right, _ = make_pair()
    return stereo.gray_u8(left), stereo.gray_u8(right)


@pytest.mark.parametrize("scene", ["plane", "slanted", "slanted_seed1",
                                   "noise"])
def test_plain_sgm_matches_opencv(scene):
    if scene == "plane":
        left, right = plane_pair()
    elif scene == "noise":
        rng = np.random.default_rng(3)
        left, right = rng.integers(0, 256, (2, 60, 200), np.uint8)
    else:
        left, right = slanted_pair(seed=int(scene.endswith("1")))
    want = cv2_disparity(left, right)
    got = stereo.sgm_disparity_plain(torch.from_numpy(left),
                                     torch.from_numpy(right)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    ok_cv, ok_port = want >= 0, got >= 0
    near = ok_port & (np.abs(got - want) <= 1.0)
    assert near[ok_cv].mean() >= AGREE
    assert (ok_cv == ok_port).mean() >= AGREE
    # What the port measures: the same integers, so the same disparities.
    np.testing.assert_array_equal(got, want)
    if scene != "noise":
        assert ok_cv.mean() > 0.3


def test_wrapper_on_cpu_is_the_plain_version():
    left, right = slanted_pair(seed=2, h=48, w=180)
    before = stereo.sgm_aggregate.launches
    got = stereo.sgm_disparity(torch.from_numpy(left),
                               torch.from_numpy(right))
    assert stereo.sgm_aggregate.launches == before
    np.testing.assert_array_equal(got.numpy(), cv2_disparity(left, right))
    # Too narrow for 128 disparities (OpenCV 5 refuses such images): every
    # pixel invalid.
    narrow = stereo.sgm_disparity(torch.from_numpy(left[:, :100].copy()),
                                  torch.from_numpy(right[:, :100].copy()))
    assert (narrow == -1).all() and narrow.shape == (48, 100)
    with pytest.raises(ValueError, match="uint8"):
        stereo.sgm_disparity(torch.zeros(8, 200), torch.zeros(8, 200))


def test_aggregate_refuses_devices_without_a_kernel():
    with pytest.raises(ValueError, match="unsupported device"):
        stereo.sgm_aggregate(torch.zeros((4, 4, 128), dtype=torch.int16,
                                         device="meta"))


def test_disparity_chw_matches_jax_mapper_function():
    left, right, _ = make_pair()
    want = jmapper.GaussianMapper._stereo_disparity(left, right)
    np.testing.assert_array_equal(stereo.disparity(left, right, "cpu"),
                                  want)
    np.testing.assert_array_equal(
        stereo.disparity(left[0], right[0], "cpu"),
        jmapper.GaussianMapper._stereo_disparity(left[0], right[0]))


# ---------------------------------------------------------------------------
# The mapper's stereo path
# ---------------------------------------------------------------------------

def stereo_mapper(jax=False, min_disparity=1):
    cfg = Config()
    cfg.renderer.initial_capacity = 2048
    cfg.mapper.do_gaus_pyramid_training = False
    cfg.mapper.stereo_min_disparity = min_disparity
    cam = dict(camera_id=0, model_id=PINHOLE, width=W, height=H, fx=FX,
               fy=FX, cx=W / 2, cy=H / 2, stereo_bf=FX * BASELINE)
    if jax:
        from photo_slam_tpu.config import Config as JConfig
        jcfg = JConfig()
        jcfg.renderer.initial_capacity = 2048
        jcfg.mapper.do_gaus_pyramid_training = False
        jcfg.mapper.stereo_min_disparity = min_disparity
        m = jmapper.GaussianMapper(jcfg, jmapper.SensorType.STEREO)
        m.add_camera(JCamera(**cam))
        return m
    m = GaussianMapper(cfg, SensorType.STEREO, device="cpu")
    m.add_camera(Camera(**cam))
    return m


def stereo_keyframe(cls, aux, seed=1, n=100):
    left, right, _ = make_pair()
    rng = np.random.RandomState(seed)
    kps = np.stack([rng.uniform(W * 0.3, W * 0.7, n),
                    rng.uniform(H * 0.3, H * 0.7, n)], 1).astype(np.float32)
    return cls(kfid=0, camera_id=0, quat_wxyz=np.array([1.0, 0, 0, 0]),
               trans=np.zeros(3), image=left,
               aux_image=right if aux is None else aux, kps_pixel=kps,
               kps_point_local=np.zeros((n, 3), np.float32))


@pytest.mark.parametrize("sgbm", ["opencv", "port"])
def test_stereo_densify_matches_jax(sgbm, monkeypatch):
    """The keyframe intake's stereo densify gives the JAX mapper's points
    and colours (1e-6), with OpenCV's SGBM swapped into the port and with
    the port's own SGM."""
    if sgbm == "opencv":
        monkeypatch.setattr(stereo, "disparity_u8", cv2_disparity)
    jm = stereo_mapper(jax=True)
    tm = stereo_mapper()
    jm.handle_new_keyframe(stereo_keyframe(JKeyframeData, None))
    tm.handle_new_keyframe(stereo_keyframe(KeyframeData, None))
    assert tm._cached_points and jm._cached_points
    for got, want in ((tm._cached_points, jm._cached_points),
                      (tm._cached_colors, jm._cached_colors)):
        np.testing.assert_allclose(np.concatenate(got),
                                   np.concatenate(want), atol=1e-6, rtol=0)


def test_port_sgm_recovers_plane_depth():
    """tests/test_stereo.py::test_sgbm_disparity_recovers_depth through
    the port's mapper."""
    left, right, disp_true = make_pair()
    disp = stereo_mapper()._stereo_disparity(left, right)
    center = disp[H // 4: 3 * H // 4, W // 4: 3 * W // 4]
    valid = center > 0
    assert valid.mean() >= 0.3, "SGM failed to match the textured plane"
    assert np.median(center[valid]) == pytest.approx(disp_true, abs=1.0)


def test_port_stereo_inactive_geo_densify():
    """tests/test_stereo.py::test_stereo_inactive_geo_densify on the
    port."""
    mapper = stereo_mapper()
    mapper.handle_new_keyframe(stereo_keyframe(KeyframeData, None))
    assert mapper._cached_points, "stereo densify produced no points"
    pts = np.concatenate(mapper._cached_points)
    assert pts.shape[0] > 30
    assert np.median(pts[:, 2]) == pytest.approx(DEPTH, rel=0.15)


def test_port_stereo_densify_accepts_depth_map_aux():
    """tests/test_stereo.py::test_stereo_densify_accepts_depth_map_aux on
    the port: a [H, W] aux is the frontend's depth, not a right image."""
    mapper = stereo_mapper()
    depth_map = np.full((H, W), DEPTH, np.float32)
    mapper.handle_new_keyframe(stereo_keyframe(KeyframeData, depth_map,
                                               seed=2, n=80))
    assert mapper._cached_points, "depth-map aux produced no points"
    pts = np.concatenate(mapper._cached_points)
    assert np.median(pts[:, 2]) == pytest.approx(DEPTH, rel=0.05)
