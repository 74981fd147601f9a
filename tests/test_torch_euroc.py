"""The EuRoC side of the port against the JAX package and OpenCV: the
rectification functions of photo_slam_tpu_torch/tracking/vision.py
against cv2.stereoRectify (alpha 0, CALIB_ZERO_DISPARITY; R1, R2, P1, P2
within 1e-6 relative), cv2.initUndistortRectifyMap (1e-3 px) and
cv2.remap (1e-6: OpenCV 5 blends float images at the maps' exact
positions); the port's EurocDataset against the JAX one on
tests/test_euroc.py::write_euroc_like's tree (rectified images within the
stated 0.04 max, 0.002 mean, and equal with OpenCV swapped in; camera,
pairing, IMU spans, ImuCalib and ground-truth poses within 1e-9); the
port's PNG codec against cv2.imread / cv2.imwrite, bit for bit; and
tools/synth_euroc.py against tools/gen_synth_euroc.py."""
import sys
from pathlib import Path

import numpy as np
import pytest

from photo_slam_tpu.io.datasets import EurocDataset as JEuroc
from photo_slam_tpu.io.datasets import \
    _parse_euroc_sensor_yaml as j_parse_yaml
from photo_slam_tpu_torch.io import images
from photo_slam_tpu_torch.io.datasets import (EurocDataset,
                                              _parse_euroc_sensor_yaml)
from photo_slam_tpu_torch.models.camera import PINHOLE, Camera
from photo_slam_tpu_torch.tracking import vision
from test_euroc import write_euroc_like
from test_torch_blend import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

REL = 1e-6
POSE_TOL = 1e-9


def euroc_like_calibration():
    """(K0, D0, K1, D1, size, R, T) of write_euroc_like's two cameras."""
    W, H = 160, 120
    K = np.array([[140.0, 0, W / 2], [0, 138.0, H / 2], [0, 0, 1]])
    T0 = np.eye(4)
    T0[:3, :3] = cv2.Rodrigues(np.array([0.0, 0.02, 0.0]))[0]
    T1 = np.eye(4)
    T1[:3, 3] = [0.11, 0.002, 0.001]
    T10 = np.linalg.inv(T1) @ T0
    return (K, np.array([-0.05, 0.01, 0.0005, -0.0003]), K,
            np.array([-0.06, 0.012, -0.0002, 0.0004]), (W, H), T10[:3, :3],
            T10[:3, 3])


def strong_calibration():
    """The app's fallback intrinsics with a strong radial-tangential lens
    and a 1 degree relative rotation."""
    K = np.array([[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1]])
    axis = np.array([0.3, 0.8, -0.5]) / np.linalg.norm([0.3, 0.8, -0.5])
    R = cv2.Rodrigues(axis * np.deg2rad(1.0))[0]
    D = np.array([-0.2834, 0.0740, 0.00019, 1.76e-05])
    return K, D, K, D * 1.02, (752, 480), R, np.array([-0.11, 0.001, 0.0005])


CALIBRATIONS = {"euroc_like": euroc_like_calibration,
                "strong": strong_calibration}


def cv2_rectify(K0, D0, K1, D1, size, R, T):
    return cv2.stereoRectify(K0, D0, K1, D1, size, R,
                             np.asarray(T, np.float64).reshape(3, 1),
                             flags=cv2.CALIB_ZERO_DISPARITY, alpha=0)[:4]


@pytest.mark.parametrize("calib", sorted(CALIBRATIONS))
def test_stereo_rectify_matches_opencv(calib):
    args = CALIBRATIONS[calib]()
    for name, got, want in zip(("R1", "R2", "P1", "P2"),
                               vision.stereo_rectify(*args),
                               cv2_rectify(*args)):
        assert np.abs(got - want).max() <= REL * np.abs(want).max(), name


@pytest.mark.parametrize("calib", sorted(CALIBRATIONS))
def test_rectify_maps_and_remap_match_opencv(calib):
    K0, D0, K1, D1, size, R, T = CALIBRATIONS[calib]()
    R1, R2, P1, P2 = vision.stereo_rectify(K0, D0, K1, D1, size, R, T)
    rng = np.random.default_rng(0)
    for K, D, Rk, P in ((K0, D0, R1, P1), (K1, D1, R2, P2)):
        want = cv2.initUndistortRectifyMap(K, D, Rk, P, size, cv2.CV_32FC1)
        got = vision.init_undistort_rectify_map(K, D, Rk, P, size)
        for g, w in zip(got, want):
            assert g.dtype == np.float32 and np.abs(g - w).max() < 1e-3
        img = rng.random((size[1], size[0], 3)).astype(np.float32)
        for src in (img, img[..., 0].copy()):
            np.testing.assert_allclose(
                vision.remap_linear(src, *want),
                cv2.remap(src, *want, cv2.INTER_LINEAR), atol=REL, rtol=0)


def test_remap_border_matches_opencv():
    """Source positions outside the image and across its edges: the
    neighbours outside count as 0 (BORDER_CONSTANT)."""
    rng = np.random.default_rng(1)
    img = rng.random((30, 40)).astype(np.float32)
    mx = rng.uniform(-3, 43, (25, 35)).astype(np.float32)
    my = rng.uniform(-3, 33, (25, 35)).astype(np.float32)
    mx[0, :5] = [-1.0, -0.5, 39.0, 39.5, 40.0]
    np.testing.assert_allclose(vision.remap_linear(img, mx, my),
                               cv2.remap(img, mx, my, cv2.INTER_LINEAR),
                               atol=REL, rtol=0)


def test_undistort_points_matches_opencv():
    K, D = strong_calibration()[:2]
    rng = np.random.default_rng(2)
    px = rng.uniform([0, 0], [752, 480], (50, 2))
    R = cv2.Rodrigues(np.array([0.01, -0.02, 0.005]))[0]
    P = np.array([[400.0, 0, 370, 0], [0, 400, 250, 0], [0, 0, 1, 0]])
    for kw in ({}, {"R": R, "P": P}):
        want = cv2.undistortPoints(px.reshape(-1, 1, 2), K, D, **kw)
        np.testing.assert_allclose(vision.undistort_points(px, K, D, **kw),
                                   want.reshape(-1, 2), atol=1e-9, rtol=0)


# ---------------------------------------------------------------------------
# The loader against the JAX one
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def euroc_imu_root(tmp_path_factory):
    return write_euroc_like(tmp_path_factory.mktemp("euroc") / "MH_imu",
                            num=4, imu=True)


def cv2_rectification(monkeypatch):
    """OpenCV's functions swapped into the port's vision module."""
    monkeypatch.setattr(vision, "stereo_rectify", lambda *a: cv2_rectify(*a))
    monkeypatch.setattr(
        vision, "init_undistort_rectify_map",
        lambda K, D, R, P, size: cv2.initUndistortRectifyMap(
            K, D, R, P, size, cv2.CV_32FC1))
    monkeypatch.setattr(vision, "remap_linear",
                        lambda img, mx, my: cv2.remap(img, mx, my,
                                                      cv2.INTER_LINEAR))


def assert_frames_match(got, want, img_tol=None):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in ((g.image, w.image), (g.right, w.right)):
            assert a.shape == b.shape and a.dtype == b.dtype == np.float32
            err = np.abs(a - b)
            if img_tol is None:
                np.testing.assert_array_equal(a, b)
            else:
                assert err.max() <= img_tol[0] and err.mean() <= img_tol[1]
        np.testing.assert_allclose(g.quat_wxyz, w.quat_wxyz, atol=POSE_TOL,
                                   rtol=0)
        np.testing.assert_allclose(g.trans, w.trans, atol=POSE_TOL, rtol=0)
        assert g.timestamp == w.timestamp and g.filename == w.filename
        assert (g.imu is None) == (w.imu is None)
        if g.imu is not None:
            for a, b in zip(g.imu, w.imu):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rectification", ["port", "opencv"])
def test_loader_matches_jax(euroc_imu_root, rectification, monkeypatch):
    if rectification == "opencv":
        cv2_rectification(monkeypatch)
    ds, jds = EurocDataset(euroc_imu_root), JEuroc(euroc_imu_root)
    for f in ("width", "height", "fx", "fy", "cx", "cy", "stereo_bf"):
        assert getattr(ds.camera, f) == pytest.approx(
            getattr(jds.camera, f), rel=1e-12, abs=0), f
    assert ds.camera.model_id == PINHOLE and len(ds) == len(jds)
    for f in ("R1", "T_BC0", "_R2dbg", "_P1dbg", "_P2dbg", "gt_times",
              "gt_T_WB", "imu_stamps", "imu_gyro", "imu_acc"):
        np.testing.assert_allclose(getattr(ds, f), getattr(jds, f),
                                   atol=1e-12, rtol=1e-12, err_msg=f)
    for f in ("noise_gyro", "noise_acc", "walk_gyro", "walk_acc", "freq"):
        assert getattr(ds.imu_calib, f) == getattr(jds.imu_calib, f)
    np.testing.assert_allclose(ds.imu_calib.Tbc, jds.imu_calib.Tbc,
                               atol=1e-12, rtol=0)
    # The images: within the stated tolerance of cv2.remap's with the
    # port's functions, equal with OpenCV's swapped in.
    tol = (0.04, 0.002) if rectification == "port" else None
    assert_frames_match(list(ds.frames()), list(jds.frames()), tol)


def test_loader_pairs_like_jax_with_a_dropped_right_frame(tmp_path):
    root = write_euroc_like(tmp_path / "MH_drop", num=6)
    cam1 = root / "mav0" / "cam1"
    csv = (cam1 / "data.csv").read_text().splitlines()
    (cam1 / "data" / f"{csv[1].split(',')[0]}.png").unlink()
    (cam1 / "data.csv").write_text("\n".join([csv[0]] + csv[2:]) + "\n")
    got, want = list(EurocDataset(root).frames()), list(JEuroc(root).frames())
    assert len(got) == 5
    assert_frames_match(got, want, (0.04, 0.002))


def test_loader_without_calibration_takes_the_camera(tmp_path):
    root = write_euroc_like(tmp_path / "MH_nocal", num=3)
    for name in ("cam0", "cam1"):
        (root / "mav0" / name / "sensor.yaml").unlink()
    with pytest.raises(FileNotFoundError):
        EurocDataset(root)
    cam = Camera(camera_id=0, model_id=PINHOLE, width=160, height=120,
                 fx=140.0, fy=138.0, cx=80.0, cy=60.0, stereo_bf=15.4)
    ds = EurocDataset(root, cam)
    assert ds.camera is cam and ds._maps is None
    from photo_slam_tpu.models.camera import Camera as JCamera
    jds = JEuroc(root, JCamera(camera_id=0, model_id=PINHOLE, width=160,
                               height=120, fx=140.0, fy=138.0, cx=80.0,
                               cy=60.0, stereo_bf=15.4))
    assert_frames_match(list(ds.frames()), list(jds.frames()))


def test_sensor_yaml_parser_matches_jax(euroc_imu_root):
    for name in ("cam0", "cam1", "imu0"):
        path = euroc_imu_root / "mav0" / name / "sensor.yaml"
        got, want = _parse_euroc_sensor_yaml(path), j_parse_yaml(path)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


def test_loader_reads_without_an_image_library(euroc_imu_root, monkeypatch):
    """The card's machine has neither cv2 nor PIL: the port's PNG codec
    reads the same pixels."""
    want = list(EurocDataset(euroc_imu_root).frames())
    monkeypatch.setattr(images, "cv2", None)
    monkeypatch.setattr(images, "Image", None)
    assert_frames_match(list(EurocDataset(euroc_imu_root).frames()), want)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def png_samples():
    rng = np.random.default_rng(4)
    smooth = cv2.GaussianBlur(rng.random((37, 53, 3)), (5, 5), 2.0)
    return {"gray8": (smooth[..., 0] * 255).astype(np.uint8),
            "rgb8": (smooth * 255).astype(np.uint8),
            "gray16": (smooth[..., 1] * 65535).astype(np.uint16),
            "gray8_noise": rng.integers(0, 256, (40, 31), np.uint8)}


@pytest.mark.parametrize("kind", sorted(png_samples()))
@pytest.mark.parametrize("level", [0, 9])
def test_png_reader_reads_opencv_files(kind, level, tmp_path):
    img = png_samples()[kind]
    path = tmp_path / "cv.png"
    cv2.imwrite(str(path), img[..., ::-1] if img.ndim == 3 else img,
                [cv2.IMWRITE_PNG_COMPRESSION, level])
    got = images.read_png(path)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("kind", sorted(png_samples()))
def test_opencv_reads_png_writer_files(kind, tmp_path):
    img = png_samples()[kind]
    path = tmp_path / "port.png"
    images.write_png(path, img)
    got = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if got.ndim == 3:
        got = got[..., ::-1]
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(images.read_png(path), img)


def filtered_png(img: np.ndarray, filters) -> bytes:
    """An 8-bit gray PNG whose rows use the given filter types in turn
    (the encoder side of ISO/IEC 15948's five filters)."""
    import struct
    import zlib

    h, w = img.shape
    rows, prev = [], np.zeros(w, np.int64)
    for y in range(h):
        cur, kind = img[y].astype(np.int64), filters[y % len(filters)]
        a = np.concatenate([[0], cur[:-1]])
        c = np.concatenate([[0], prev[:-1]])
        if kind == 0:
            pred = np.zeros(w, np.int64)
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (a + prev) >> 1
        else:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prev, c))
        rows.append(bytes([kind]) + ((cur - pred) & 255).astype(
            np.uint8).tobytes())
        prev = cur

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF))

    return (images.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_png_reader_undoes_all_five_filters(tmp_path):
    img = png_samples()["gray8_noise"]
    path = tmp_path / "filters.png"
    path.write_bytes(filtered_png(img, [0, 1, 2, 3, 4]))
    np.testing.assert_array_equal(images.read_png(path), img)
    np.testing.assert_array_equal(cv2.imread(str(path),
                                             cv2.IMREAD_UNCHANGED), img)


def test_png_reader_refuses_other_kinds(tmp_path):
    with pytest.raises(FileNotFoundError):
        images.read_png(tmp_path / "missing.png")
    rgba = np.zeros((4, 5, 4), np.uint8)
    cv2.imwrite(str(tmp_path / "rgba.png"), rgba)
    with pytest.raises(ValueError, match="RGBA"):
        images.read_png(tmp_path / "rgba.png")
    with pytest.raises(ValueError):
        images.write_png(tmp_path / "f.png", np.zeros((4, 5), np.float32))


def test_image_loaders_without_a_library(tmp_path, monkeypatch):
    """load_image_chw / load_depth / save_image_chw through the port's codec
    give what they give through cv2."""
    s = png_samples()
    cv2.imwrite(str(tmp_path / "g.png"), s["gray8"])
    cv2.imwrite(str(tmp_path / "c.png"), s["rgb8"][..., ::-1])
    cv2.imwrite(str(tmp_path / "d.png"), s["gray16"])
    want = [images.load_image_chw(tmp_path / "g.png"),
            images.load_image_chw(tmp_path / "c.png"),
            images.load_depth(tmp_path / "d.png", 5000.0)]
    monkeypatch.setattr(images, "cv2", None)
    monkeypatch.setattr(images, "Image", None)
    got = [images.load_image_chw(tmp_path / "g.png"),
           images.load_image_chw(tmp_path / "c.png"),
           images.load_depth(tmp_path / "d.png", 5000.0)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    images.save_image_chw(tmp_path / "out.png", want[1])
    np.testing.assert_array_equal(images.load_image_chw(tmp_path / "out.png"),
                                  want[1])
    with pytest.raises(RuntimeError, match="PNG only"):
        images.load_image_chw(tmp_path / "x.jpg")
    with pytest.raises(FileNotFoundError):
        images.load_image_chw(tmp_path / "none.png")


# ---------------------------------------------------------------------------
# The synthetic sequence
# ---------------------------------------------------------------------------

def test_synth_imu_and_yaml_match_the_jax_tool(tmp_path):
    import gen_synth_euroc as jtool

    from photo_slam_tpu_torch.tools import synth_euroc

    for tool, out in ((jtool, tmp_path / "jax"), (synth_euroc,
                                                  tmp_path / "port")):
        (out / "mav0").mkdir(parents=True)
        tool.write_imu(out / "mav0", 30, tool.trajectory(30))
    for f in ("data.csv", "sensor.yaml"):
        assert ((tmp_path / "port/mav0/imu0" / f).read_text()
                == (tmp_path / "jax/mav0/imu0" / f).read_text())
    t_bs = np.eye(4)
    t_bs[0, 3] = synth_euroc.BASELINE
    assert synth_euroc.sensor_yaml(t_bs) == jtool.sensor_yaml(t_bs)


def test_synth_tree_loads_as_its_frames(tmp_path):
    """SynthEuroc.frames() is what both packages' loaders read back from
    its written tree (identity rectification, exact 8-bit gray)."""
    from photo_slam_tpu_torch.tools.synth_euroc import SynthEuroc

    seq = SynthEuroc(3, 160, 96, device="cpu", n_splats=4000)
    root = seq.write(tmp_path / "synth")
    mem = list(seq.frames())
    ds = EurocDataset(root)
    assert ds.camera.fx == pytest.approx(seq.camera.fx, rel=1e-12)
    assert ds.camera.stereo_bf == pytest.approx(seq.camera.stereo_bf,
                                                rel=1e-9)
    got = list(ds.frames())
    want = list(JEuroc(root).frames())
    assert_frames_match(got, want, (0.04, 0.002))
    for g, m in zip(got, mem):
        np.testing.assert_allclose(g.image, m.image, atol=1e-6, rtol=0)
        np.testing.assert_allclose(g.right, m.right, atol=1e-6, rtol=0)
        np.testing.assert_allclose(g.trans, m.trans, atol=1e-6, rtol=0)
        assert (g.imu is None) == (m.imu is None)
        if g.imu is not None:
            np.testing.assert_allclose(g.imu[0], m.imu[0], atol=1e-9)
            np.testing.assert_allclose(g.imu[1], m.imu[1], atol=1e-8)
