"""The port's math core against the JAX package on identical inputs: math,
camera math, SH, preprocess, KNN and map creation (CPU, float32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photo_slam_tpu.models import gaussian_model as jgm
from photo_slam_tpu.ops import camera_math as jcm
from photo_slam_tpu.ops import knn as jknn
from photo_slam_tpu.ops import preprocess as jprep
from photo_slam_tpu.ops import sh as jsh
from photo_slam_tpu.utils import math as jmath
from photo_slam_tpu_torch.models import gaussian_model as tgm
from photo_slam_tpu_torch.ops import camera_math as tcm
from photo_slam_tpu_torch.ops import knn as tknn
from photo_slam_tpu_torch.ops import preprocess as tprep
from photo_slam_tpu_torch.ops import sh as tsh
from photo_slam_tpu_torch.utils import math as tmath

TOL = dict(atol=1e-5, rtol=1e-5)


def close(t, j, **kw):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(kw or TOL))


def scene(n=300, seed=0):
    rng = np.random.RandomState(seed)
    means = np.stack([rng.uniform(-2.5, 2.5, n), rng.uniform(-2, 2, n),
                      rng.uniform(-0.5, 8, n)], 1).astype(np.float32)
    scales = rng.uniform(0.02, 0.3, (n, 3)).astype(np.float32)
    quats = rng.randn(n, 4).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.005, 0.95, n).astype(np.float32)
    shs = (rng.randn(n, 16, 3) * 0.3).astype(np.float32)
    live = rng.rand(n) > 0.1
    return means, scales, quats, opac, shs, live


def both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.asarray(a)) for a in arrays])


class TestMath:
    def test_inverse_sigmoid_and_rotmat(self):
        rng = np.random.RandomState(1)
        x = rng.uniform(0.01, 0.99, 50).astype(np.float32)
        q = rng.randn(50, 4).astype(np.float32)
        (jx, jq), (tx, tq) = both(x, q)
        close(tmath.inverse_sigmoid(tx), jmath.inverse_sigmoid(jx))
        close(tmath.quat_to_rotmat(tq), jmath.quat_to_rotmat(jq))

    def test_fov_focal_and_numpy_helpers(self):
        assert tmath.fov2focal(1.1, 640) == jmath.fov2focal(1.1, 640)
        assert tmath.focal2fov(520.0, 480) == jmath.focal2fov(520.0, 480)
        xi = np.array([0.1, -0.2, 0.3, 0.4, -0.1, 0.25])
        np.testing.assert_array_equal(tmath.se3_exp_numpy(xi),
                                      jmath.se3_exp_numpy(xi))


class TestCameraMath:
    def test_camera_matrices_and_transforms(self):
        rng = np.random.RandomState(2)
        R = jmath.quat_to_rotmat_numpy(rng.randn(4))
        t = rng.randn(3)
        jc = jcm.build_camera_matrices(R, t, 0.01, 100.0, 1.1, 0.8,
                                       trans=(0.1, 0.0, -0.2), scale=1.5)
        tc = tcm.build_camera_matrices(R, t, 0.01, 100.0, 1.1, 0.8,
                                       trans=(0.1, 0.0, -0.2), scale=1.5,
                                       device="cpu")
        for a, b in zip(tc, jc):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        pts = rng.randn(64, 3).astype(np.float32) * 3
        (jp,), (tp,) = both(pts)
        close(tcm.transform_points_43(tp, tc.viewmatrix),
              jcm.transform_points_43(jp, jc.viewmatrix))
        close(tcm.transform_points_44(tp, tc.full_proj),
              jcm.transform_points_44(jp, jc.full_proj))
        v = torch.linspace(-1, 1, 9)
        close(tcm.ndc_to_pixel(v, 640), jcm.ndc_to_pixel(jnp.asarray(v), 640))


class TestSH:
    @pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
    def test_eval_sh_and_rgb(self, degree):
        rng = np.random.RandomState(degree)
        k = (degree + 1) ** 2
        shs = rng.randn(40, k, 3).astype(np.float32)
        means = rng.randn(40, 3).astype(np.float32)
        cam = rng.randn(3).astype(np.float32)
        (js, jm, jc), (ts, tm, tc) = both(shs, means, cam)
        close(tsh.sh_to_rgb(degree, ts, tm, tc),
              jsh.sh_to_rgb(degree, js, jm, jc))
        dirs = means / np.linalg.norm(means, axis=1, keepdims=True)
        close(tsh.eval_sh(degree, ts, torch.from_numpy(dirs)),
              jsh.eval_sh(degree, js, jnp.asarray(dirs)))

    def test_rgb_to_sh(self):
        rgb = np.random.RandomState(0).rand(20, 3).astype(np.float32)
        close(tsh.rgb_to_sh(torch.from_numpy(rgb)),
              jsh.rgb_to_sh(jnp.asarray(rgb)))


class TestPreprocess:
    @pytest.mark.parametrize("principal,use_sh", [
        (None, True), ((40.0, 27.5), False)])
    def test_every_field(self, principal, use_sh):
        means, scales, quats, opac, shs, live = scene()
        R = jmath.quat_to_rotmat_numpy([0.99, 0.05, -0.08, 0.02])
        jc = jcm.build_camera_matrices(R, np.array([0.1, -0.1, 0.3]), 0.01,
                                       100.0, 1.0, 0.8)
        tc = tcm.build_camera_matrices(R, np.array([0.1, -0.1, 0.3]), 0.01,
                                       100.0, 1.0, 0.8, device="cpu")
        colors = np.abs(shs[:, 0, :])
        (jm, js, jq, jo, jsh_, jl, jcol), (tm, ts, tq, to, tsh_, tl, tcol) = \
            both(means, scales, quats, opac, shs, live, colors)
        kw = dict(width=96, height=64, tan_fovx=float(np.tan(0.5)),
                  tan_fovy=float(np.tan(0.4)), sh_degree=3,
                  principal=principal)
        jp = jprep.preprocess(jm, js, jq, jc.viewmatrix, jc.full_proj,
                              jc.cam_center, live_mask=jl,
                              **(dict(shs=jsh_) if use_sh else
                                 dict(colors_precomp=jcol)), **kw)
        tp = tprep.preprocess(tm, ts, tq, tc.viewmatrix, tc.full_proj,
                              tc.cam_center, live_mask=tl,
                              **(dict(shs=tsh_) if use_sh else
                                 dict(colors_precomp=tcol)), **kw)
        assert tp.visible.any() and not tp.visible.all()
        for f in ("means2d", "depths", "conics", "rgb"):
            close(getattr(tp, f), getattr(jp, f))
        np.testing.assert_array_equal(tp.radii.numpy(), np.asarray(jp.radii))
        np.testing.assert_array_equal(tp.visible.numpy(),
                                      np.asarray(jp.visible))
        close(tprep.tight_extents(tp.conics, to, tp.radii),
              jprep.tight_extents(jp.conics, jo, jp.radii))

    def test_cov3d_cov2d(self):
        means, scales, quats, _, _, _ = scene(n=64, seed=4)
        jc = jcm.build_camera_matrices(np.eye(3), np.zeros(3), 0.01, 100.0,
                                       1.0, 1.0)
        (jm, js, jq), (tm, ts, tq) = both(means, scales, quats)
        j3 = jprep.compute_cov3d(js, jq, 1.3)
        t3 = tprep.compute_cov3d(ts, tq, 1.3)
        close(t3, j3)
        close(tprep.compute_cov2d(tm, t3, torch.tensor(
            np.asarray(jc.viewmatrix)), 60.0, 55.0, 0.5, 0.45),
              jprep.compute_cov2d(jm, j3, jc.viewmatrix, 60.0, 55.0, 0.5,
                                  0.45))


class TestKNN:
    @pytest.mark.parametrize("with_live", [False, True])
    def test_brute_force(self, with_live):
        rng = np.random.RandomState(5)
        pts = rng.rand(700, 3).astype(np.float32)
        live = rng.rand(700) > 0.2 if with_live else None
        j = jknn.knn_mean_sq_dist(jnp.asarray(pts), None if live is None
                                  else jnp.asarray(live))
        t = tknn.knn_mean_sq_dist(torch.from_numpy(pts), None if live is None
                                  else torch.from_numpy(live))
        close(t, j)

    def test_morton_on_distinct_codes(self):
        rng = np.random.RandomState(6)
        pts = rng.rand(3000, 3).astype(np.float32)
        live = rng.rand(3000) > 0.1
        codes = np.asarray(jknn._morton_codes(jnp.asarray(pts),
                                              jnp.asarray(live)))
        assert len(np.unique(codes[live])) == live.sum()
        tcodes = tknn._morton_codes(torch.from_numpy(pts),
                                    torch.from_numpy(live))
        np.testing.assert_array_equal(tcodes.numpy(), codes.astype(np.int64))
        close(tknn._knn_mean_sq_dist_morton(torch.from_numpy(pts),
                                            torch.from_numpy(live), 3),
              jknn._knn_mean_sq_dist_morton(jnp.asarray(pts),
                                            jnp.asarray(live), 3))


class TestCreateFromPcd:
    def test_matches_jax(self):
        rng = np.random.RandomState(7)
        pts = rng.rand(500, 3).astype(np.float32) * 2
        cols = rng.rand(500, 3).astype(np.float32)
        js = jgm.create_from_pcd(pts, cols, sh_degree=2, capacity=640)
        ts = tgm.create_from_pcd(pts, cols, sh_degree=2, capacity=640,
                                 device="cpu")
        for name in jgm.GaussianParams._fields:
            close(getattr(ts.params, name), getattr(js.params, name))
        np.testing.assert_array_equal(ts.live.numpy(), np.asarray(js.live))
        for a, b in zip(tgm.activated(ts.params), jgm.activated(js.params)):
            close(a, b)
        close(tgm.sh_features(ts.params), jgm.sh_features(js.params))
        assert tgm.round_capacity(5000) == jgm.round_capacity(5000)

    def test_state_from_numpy_carries_the_map(self):
        js = jgm.create_from_pcd(np.random.RandomState(8).rand(50, 3)
                                 .astype(np.float32),
                                 np.full((50, 3), 0.5, np.float32),
                                 sh_degree=1, capacity=64)
        ts = tgm.state_from_numpy(
            {k: np.asarray(v) for k, v in js.params._asdict().items()},
            np.asarray(js.live), device="cpu")
        for name in jgm.GaussianParams._fields:
            np.testing.assert_array_equal(getattr(ts.params, name).numpy(),
                                          np.asarray(getattr(js.params,
                                                             name)))
        assert ts.capacity == 64 and int(ts.live.sum()) == 50
        with pytest.raises(KeyError):
            tgm.state_from_numpy({"xyz": np.zeros((4, 3))}, np.ones(4, bool),
                                 device="cpu")
