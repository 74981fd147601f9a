"""The port's web viewer: the scenarios of tests/test_viewer.py on the
port's server over a port mapper on the CPU; the port's server against the
JAX package's over the same map (/render PNGs within 3/255 per pixel, the
render_from_pose bound of 1e-2 after 8-bit rounding; /map within 1e-5;
/status keys and /params equal); a /render that waits for the render lock;
renders served while the mapper trains; and the PNG codec."""
import io
import json
import os
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from photo_slam_tpu.config import Config as JConfig
from photo_slam_tpu.mapper.mapper import GaussianMapper as JMapper
from photo_slam_tpu.mapper.mapper import SensorType as JSensorType
from photo_slam_tpu.models.camera import Camera as JCamera
from photo_slam_tpu.models.keyframe import Keyframe as JKeyframe
from photo_slam_tpu.viewer.server import ViewerServer as JServer
from photo_slam_tpu_torch.config import Config
from photo_slam_tpu_torch.io.images import decode_png, encode_png
from photo_slam_tpu_torch.mapper.mapper import GaussianMapper, SensorType
from photo_slam_tpu_torch.models import gaussian_model as tgm
from photo_slam_tpu_torch.models.camera import PINHOLE, Camera
from photo_slam_tpu_torch.models.keyframe import Keyframe
from photo_slam_tpu_torch.viewer.server import ViewerServer
from test_torch_blend import one_torch_thread  # noqa: F401

W, H = 64, 48
POSE = "qw=1&qx=0&qy=0&qz=0&tx=0&ty=0&tz=0"


def camera(cls=Camera):
    return cls(camera_id=0, model_id=PINHOLE, width=W, height=H, fx=60.0,
               fy=60.0, cx=32, cy=24)


def scene_points():
    rng = np.random.RandomState(0)
    pts = (rng.randn(50, 3) * 0.5 + [0, 0, 5]).astype(np.float32)
    return pts, rng.rand(50, 3).astype(np.float32)


def port_mapper():
    """tests/test_viewer.py::viewer's mapper on the port, on the CPU."""
    cfg = Config()
    cfg.renderer.initial_capacity = 256
    mapper = GaussianMapper(cfg, SensorType.RGBD, device="cpu")
    mapper.add_camera(camera())
    mapper.trainer.initialize_map(*scene_points())
    mapper.initial_mapped = True
    return mapper


@pytest.fixture(scope="module")
def viewer():
    srv = ViewerServer(port_mapper(), port=0, width=W, height=H)
    srv.start()
    yield srv, srv.mapper
    srv.stop()


def _get(srv, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}",
                                timeout=60) as r:
        return r.status, r.read(), r.headers.get("Content-Type")


class TestViewer:
    """tests/test_viewer.py::TestViewer on the port."""

    def test_index_page(self, viewer):
        srv, _ = viewer
        code, body, ctype = _get(srv, "/")
        assert code == 200 and b"photo_slam_tpu" in body
        assert "text/html" in ctype

    def test_status(self, viewer):
        srv, _ = viewer
        code, body, _ = _get(srv, "/status")
        s = json.loads(body)
        assert code == 200
        assert "iteration" in s and "num_gaussians" in s

    def test_render_endpoint(self, viewer):
        srv, _ = viewer
        code, body, ctype = _get(srv, f"/render?{POSE}&w={W}&h={H}")
        assert code == 200
        assert ctype == "image/png"
        assert body[:8] == b"\x89PNG\r\n\x1a\n"

    def test_render_size_ladder_crop(self, viewer):
        """Arbitrary sizes are served by a ladder render and a center crop:
        the PNG has the requested size."""
        srv, _ = viewer
        code, body, ctype = _get(srv, f"/render?{POSE}&w=100&h=70")
        assert code == 200 and ctype == "image/png"
        assert decode_png(body).shape == (70, 100, 3)

    def test_map_endpoint(self, viewer):
        srv, mapper = viewer
        cam = mapper.scene.cameras[0]
        for fid in (0, 1):
            kf = Keyframe(fid=fid, camera=cam)
            kf.set_pose(np.array([1.0, 0, 0, 0]),
                        np.array([0.1 * fid, 0, 0]), device="cpu")
            mapper.scene.add_keyframe(kf)
        mapper._sparse_log_pts = [np.random.rand(20, 3).astype(np.float32)]
        mapper._sparse_log_cols = [np.random.rand(20, 3).astype(np.float32)]
        code, body, _ = _get(srv, "/map")
        m = json.loads(body)
        assert code == 200
        assert len(m["keyframes"]) == 2
        assert len(m["keyframes"][0]["twc"]) == 3  # 3x4 camera-to-world
        assert len(m["points"]) == 20
        assert len(m["colors"]) == 20
        assert m["edges"] == [[0, 1]]
        assert m["fovx"] > 0

    def test_frame_endpoint(self, viewer):
        srv, _ = viewer
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv, "/frame")
        assert e.value.code == 404

        class FakeFrontend:
            last_frame_vis = (np.random.RandomState(0)
                              .rand(3, H, W).astype(np.float32),
                              np.array([[10.0, 20.0], [30.0, 8.0]]))

        srv.frontend = FakeFrontend()
        try:
            code, body, ctype = _get(srv, "/frame")
            assert code == 200 and ctype == "image/png"
            frame = decode_png(body)
            assert frame.shape == (H, W, 3)
            assert tuple(frame[20, 10]) == (0, 255, 0)
        finally:
            srv.frontend = None

    def test_map_endpoint_with_mutating_frontend(self, viewer):
        srv, _ = viewer
        from photo_slam_tpu_torch.tracking.local_map import LocalMap

        lm = LocalMap()
        lm.add_points(np.random.rand(7, 3),
                      np.zeros((7, 32), np.uint8),
                      np.random.rand(7, 3).astype(np.float32), first_kf=0)

        class FE:
            map = lm

        srv.frontend = FE()
        try:
            code, body, _ = _get(srv, "/map")
            m = json.loads(body)
            assert code == 200 and len(m["points"]) == 7
        finally:
            srv.frontend = None

    def test_params_roundtrip(self, viewer):
        srv, mapper = viewer
        code, body, _ = _get(srv, "/params")
        params = json.loads(body)
        assert "lambda_dssim" in params
        params["lambda_dssim"] = 0.33
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/params",
            data=json.dumps(params).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
        assert mapper.cfg.opt.lambda_dssim == pytest.approx(0.33)

    def test_stop(self, viewer):
        srv, mapper = viewer
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/stop",
                                     data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200
        assert mapper.stopped


@pytest.fixture(scope="module")
def both_servers():
    """A JAX mapper and a port mapper over the same map (carried across
    with gm.state_from_numpy), the same keyframes and sparse points, each
    behind its package's server."""
    jcfg = JConfig()
    jcfg.renderer.initial_capacity = 256
    jm = JMapper(jcfg, JSensorType.RGBD)
    jm.add_camera(camera(JCamera))
    jm.trainer.initialize_map(*scene_points())
    jm.initial_mapped = True
    tm = port_mapper()
    # The JAX side renders "tiled" with its caps; the port's kernel path
    # takes the same caps, so that neither binds.
    r = tm.cfg.renderer
    r.pallas_max_tiles_per_gaussian = r.max_tiles_per_gaussian
    r.pallas_max_per_tile = r.max_per_tile
    tm.trainer.state = tgm.state_from_numpy(
        {k: np.asarray(v) for k, v in jm.trainer.state.params._asdict()
         .items()}, np.asarray(jm.trainer.state.live), device="cpu")
    rng = np.random.RandomState(2)
    pts = rng.rand(20, 3).astype(np.float32)
    cols = rng.rand(20, 3).astype(np.float32)
    for m, kf_cls, kw in ((jm, JKeyframe, {}), (tm, Keyframe,
                                                 {"device": "cpu"})):
        for fid in (0, 1, 2):
            kf = kf_cls(fid=fid, camera=m.scene.cameras[0])
            kf.set_pose(np.array([0.99, 0.0, 0.05 * fid, 0.0]),
                        np.array([0.1 * fid, 0, 0.05]), **kw)
            m.scene.add_keyframe(kf)
        m._sparse_log_pts = [pts]
        m._sparse_log_cols = [cols]
    servers = (JServer(jm, port=0, width=W, height=H),
               ViewerServer(tm, port=0, width=W, height=H))
    for srv in servers:
        srv.start()
    yield servers
    for srv in servers:
        srv.stop()


@pytest.mark.parametrize("w,h", [(W, H), (100, 70)])
def test_render_matches_jax_server(both_servers, w, h):
    jsrv, tsrv = both_servers
    q = "qw=0.99&qx=0&qy=0.05&qz=0&tx=0.1&ty=0&tz=0.2"
    got = decode_png(_get(tsrv, f"/render?{q}&w={w}&h={h}")[1])
    want = decode_png(_get(jsrv, f"/render?{q}&w={w}&h={h}")[1])
    assert got.shape == want.shape == (h, w, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 3, diff.max()
    assert got.max() > 10


def test_map_status_params_match_jax_server(both_servers):
    jsrv, tsrv = both_servers
    got = json.loads(_get(tsrv, "/map")[1])
    want = json.loads(_get(jsrv, "/map")[1])
    assert set(got) == set(want)
    assert [k["id"] for k in got["keyframes"]] == [
        k["id"] for k in want["keyframes"]] == [0, 1, 2]
    for a, b in zip(got["keyframes"], want["keyframes"]):
        np.testing.assert_allclose(a["twc"], b["twc"], atol=1e-5)
    for key in ("points", "colors"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-5)
    assert got["edges"] == want["edges"]
    for key in ("fovx", "aspect"):
        assert got[key] == pytest.approx(want[key], abs=1e-5)
    assert (set(json.loads(_get(tsrv, "/status")[1]))
            == set(json.loads(_get(jsrv, "/status")[1])))
    assert (json.loads(_get(tsrv, "/params")[1])
            == json.loads(_get(jsrv, "/params")[1]))


def test_render_waits_for_the_render_lock():
    """A /render request blocks while another thread holds the mapper's
    render lock, and is served once it is released."""
    srv = ViewerServer(port_mapper(), port=0, width=W, height=H)
    srv.start()
    result = {}

    def request():
        result["code"] = _get(srv, f"/render?{POSE}&w={W}&h={H}")[0]

    try:
        with srv.mapper.render_lock:
            th = threading.Thread(target=request)
            th.start()
            th.join(timeout=1.0)
            assert th.is_alive() and "code" not in result
        th.join(timeout=60)
        assert not th.is_alive() and result["code"] == 200
    finally:
        srv.stop()
    stages = srv.profiler.summary()
    assert stages["viewer.lock_wait"]["max_ms"] >= 500.0
    assert {"viewer.render", "viewer.d2h", "viewer.png"} <= set(stages)


def test_renders_served_while_the_mapper_trains():
    """More client threads than cores GET /render at a short switch
    interval while the mapper trains: every response is a PNG of the
    requested size, the trainer counts every iteration and the profiler
    every request."""
    mapper = port_mapper()
    cam = mapper.scene.cameras[0]
    for fid in (0, 1):
        kf = Keyframe(fid=fid, camera=cam)
        kf.set_pose(np.array([1.0, 0, 0, 0]), np.array([0.1 * fid, 0, 0]),
                    device="cpu")
        kf.set_image(np.full((3, H, W), 0.5, np.float32))
        kf.remaining_times_of_use = 10**9
        mapper.scene.add_keyframe(kf)
    srv = ViewerServer(mapper, port=0, width=W, height=H)
    srv.start()
    stop = threading.Event()
    shapes, errors = [], []

    def client():
        while not stop.is_set():
            try:
                shapes.append(decode_png(
                    _get(srv, f"/render?{POSE}&w=40&h=30")[1]).shape)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

    clients = [threading.Thread(target=client)
               for _ in range(len(os.sched_getaffinity(0)) + 2)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        for t in clients:
            t.start()
        for _ in range(4):
            mapper.trainer.train_iteration()
        mapper.trainer.train_iteration_batched(
            list(mapper.scene.keyframes.values()))
    finally:
        stop.set()
        sys.setswitchinterval(old)
        for t in clients:
            t.join(timeout=120)
        srv.stop()
    assert not any(t.is_alive() for t in clients)
    assert not errors, errors[:3]
    assert shapes and set(shapes) == {(30, 40, 3)}
    assert mapper.trainer.iteration == 5
    assert srv.profiler.summary()["viewer.png"]["count"] == len(shapes)
    assert all(bool(torch.isfinite(p).all())
               for p in mapper.trainer.state.params)


@pytest.mark.parametrize("shape,dtype", [((48, 64, 3), np.uint8),
                                         ((30, 17), np.uint8),
                                         ((12, 9), np.uint16)])
@pytest.mark.parametrize("level", [0, 1, 6])
def test_png_codec_round_trips(shape, dtype, level):
    """encode_png then decode_png gives the array back at every level, and
    PIL reads the bytes to the same array."""
    from PIL import Image

    rng = np.random.RandomState(3)
    arr = rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    data = encode_png(arr, level=level)
    np.testing.assert_array_equal(decode_png(data), arr)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  arr)
    with pytest.raises(ValueError):
        decode_png(data[8:])
