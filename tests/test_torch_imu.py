"""The port's IMU module (photo_slam_tpu_torch/tracking/imu.py) against the
JAX package's photo_slam_tpu/tracking/imu.py.

Both are host float64 numpy, so every result is held within 1e-12
(absolute, on quantities of order 1-10): the deltas and their bias
Jacobians, integrate_span at split boundaries, predict, reintegrate, the
gyro bias and initialize_imu at three gauges and the degenerate case, on
measurement streams drawn from a seed. The non-slow scenarios of
tests/test_imu.py then run unchanged on the port's functions."""
import numpy as np
import pytest

import test_imu
from photo_slam_tpu.tracking import imu as jimu
from photo_slam_tpu_torch.tracking import imu

TOL = 1e-12


def stream(seed, n=240, hz=200.0, t0=0.0):
    """Noisy gyro + accel samples (rad/s, m/s^2) at `hz` from t0."""
    rng = np.random.default_rng(seed)
    stamps = t0 + np.arange(n) / hz
    gyros = 0.3 * np.sin(np.outer(stamps, [1.1, 0.7, 1.9])) + \
        rng.normal(0, 0.01, (n, 3))
    accs = np.array([0.0, 0.0, imu.GRAVITY]) + \
        np.sin(np.outer(stamps, [0.9, 1.3, 0.5])) + rng.normal(0, 0.05, (n, 3))
    return stamps, accs, gyros


def both(fn_name, *args, **kw):
    return getattr(imu, fn_name)(*args, **kw), getattr(jimu, fn_name)(
        *args, **kw)


def assert_close(a, b, tol=TOL):
    assert np.max(np.abs(np.asarray(a, np.float64)
                         - np.asarray(b, np.float64))) <= tol


def pre_pair(seed, bias=None, calib=None):
    stamps, accs, gyros = stream(seed)
    p, q = (mod.Preintegrated(
        None if bias is None else mod.ImuBias(bias[0].copy(),
                                              bias[1].copy()),
        None if calib is None else mod.ImuCalib(Tbc=calib.copy()))
        for mod in (imu, jimu))
    for a, w in zip(accs, gyros):
        p.integrate(a, w, 1 / 200.0)
        q.integrate(a, w, 1 / 200.0)
    return p, q


FIELDS = ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "cov")


@pytest.mark.parametrize("seed", [0, 1])
def test_so3_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    for w in [rng.normal(0, 1, 3), rng.normal(0, 1e-9, 3), np.zeros(3),
              np.array([np.pi - 1e-7, 0, 0])]:
        for name in ("so3_exp", "right_jacobian", "_skew"):
            assert_close(*both(name, w))
        assert_close(*both("so3_log", imu.so3_exp(w)))


def test_deltas_and_jacobians_match_jax():
    bias = (np.array([0.01, -0.02, 0.005]), np.array([0.1, 0.0, -0.05]))
    calib = np.eye(4)
    calib[:3, 3] = [0.05, -0.02, 0.01]
    p, q = pre_pair(3, bias, calib)
    for f in FIELDS:
        assert_close(getattr(p, f), getattr(q, f))
    assert_close(p.calib.Tcb, q.calib.Tcb)
    nb = (np.array([0.02, 0.0, -0.01]), np.array([0.0, 0.05, 0.02]))
    pb, qb = imu.ImuBias(*nb), jimu.ImuBias(*nb)
    assert_close(p.delta_rotation(pb), q.delta_rotation(qb))
    assert_close(p.delta_velocity(pb), q.delta_velocity(qb))
    assert_close(p.delta_position(pb), q.delta_position(qb))
    p.reintegrate(pb)
    q.reintegrate(qb)
    for f in FIELDS:
        assert_close(getattr(p, f), getattr(q, f))


@pytest.mark.parametrize("t0,t1", [(0.2035, 0.8061), (0.0, 1.195),
                                   (-0.3, 0.5), (0.4, 0.4025)])
def test_integrate_span_boundaries_match_jax(t0, t1):
    stamps, accs, gyros = stream(5)
    p, q = imu.Preintegrated(), jimu.Preintegrated()
    p.integrate_span(stamps, accs, gyros, t0, t1)
    q.integrate_span(stamps, accs, gyros, t0, t1)
    assert len(p._meas) == len(q._meas)
    for f in FIELDS:
        assert_close(getattr(p, f), getattr(q, f))


def test_predict_matches_jax():
    p, q = pre_pair(7)
    R = imu.so3_exp(np.array([0.1, -0.3, 0.2]))
    v, x = np.array([0.5, -0.1, 0.2]), np.array([1.0, 2.0, -0.5])
    g = np.array([0.3, -0.2, -9.7])
    for kw in ({}, {"gravity": g}):
        for a, b in zip(p.predict(R, v, x, **kw), q.predict(R, v, x, **kw)):
            assert_close(a, b)
    bias = (np.array([0.01, 0.0, 0.0]), np.array([0.0, -0.02, 0.0]))
    for a, b in zip(p.predict(R, v, x, bias=imu.ImuBias(*bias)),
                    q.predict(R, v, x, bias=jimu.ImuBias(*bias))):
        assert_close(a, b)


def kf_chain(seed, n=12, scale=1.0, bg=(0.01, 0.02, -0.01)):
    """Keyframe poses along test_imu's analytic trajectory and the
    preintegrations between them (both packages' objects, same samples)."""
    rng = np.random.default_rng(seed)
    bias = np.asarray(bg)
    Rg = imu.so3_exp(rng.normal(0, 0.2, 3))
    Rwb, pwb, pre_p, pre_j = [], [], [], []
    for i in range(n):
        t = 0.2 + 0.35 * i
        R, _, x, _, _ = test_imu._trajectory(t)
        Rwb.append(Rg @ R)
        pwb.append(scale * (Rg @ x) + rng.normal(0, 1e-4, 3))
        if i:
            ts, accs, gyros, dts = test_imu._imu_stream(
                t - 0.35, t, hz=500.0, bias=jimu.ImuBias(bg=bias))
            p, q = imu.Preintegrated(), jimu.Preintegrated()
            for a, w, d in zip(accs, gyros, dts):
                p.integrate(a, w, d)
                q.integrate(a, w, d)
            pre_p.append(p)
            pre_j.append(q)
    return Rwb, pwb, pre_p, pre_j


def test_gyro_bias_matches_jax():
    Rwb, _, pre_p, pre_j = kf_chain(11)
    assert_close(imu.estimate_gyro_bias(Rwb, pre_p),
                 jimu.estimate_gyro_bias(Rwb, pre_j))


@pytest.mark.parametrize("scale,mono", [(1.0, False), (0.4, True),
                                        (2.5, True)])
def test_initialize_imu_matches_jax(scale, mono):
    Rwb, pwb, pre_p, pre_j = kf_chain(13, scale=scale)
    a = imu.initialize_imu(Rwb, pwb, pre_p, monocular=mono)
    b = jimu.initialize_imu(Rwb, pwb, pre_j, monocular=mono)
    assert a.ok and b.ok
    # The scale is ~1/scale_true; its relative error is what 1e-12 bounds.
    assert abs(a.scale - b.scale) <= TOL * b.scale
    for f in ("Rwg", "gravity_w", "velocities", "residual"):
        assert_close(getattr(a, f), getattr(b, f), 1e-10)
    assert_close(a.bias.bg, b.bias.bg)
    assert_close(a.bias.ba, b.bias.ba)


def test_initialize_imu_degenerate_matches_jax():
    Rwb, pwb, pre_p, pre_j = kf_chain(17, n=2)
    for args in (([np.eye(3)], [np.zeros(3)], [], []),
                 (Rwb, pwb, pre_p, pre_j)):
        a = imu.initialize_imu(args[0], args[1], args[2], monocular=True)
        b = jimu.initialize_imu(args[0], args[1], args[3], monocular=True)
        assert not a.ok and not b.ok
    # Spans of no time leave the least-squares system empty: both raise.
    for mod in (imu, jimu):
        with pytest.raises(ValueError):
            mod.initialize_imu([np.eye(3)] * 4, [np.zeros(3)] * 4,
                               [mod.Preintegrated()] * 3)


PORTED = ("GRAVITY", "ImuBias", "ImuCalib", "Preintegrated",
          "estimate_gyro_bias", "initialize_imu", "right_jacobian",
          "so3_exp", "so3_log")


@pytest.mark.parametrize("case", [
    ("test_preintegration_matches_pose_delta", ()),
    ("test_bias_jacobian_first_order_update", ()),
    ("test_integrate_span_boundary_split", ()),
    ("test_gyro_bias_recovery", ()),
    ("test_init_recovers_scale_and_gravity", (1.0,)),
    ("test_init_recovers_scale_and_gravity", (2.5,)),
    ("test_init_recovers_scale_and_gravity", (0.4,)),
    ("test_init_stereo_metric", ()),
    ("test_init_rejects_degenerate", ())], ids=lambda c: str(c))
def test_jax_imu_scenarios_on_the_port(case, monkeypatch):
    """tests/test_imu.py's scenarios (all but the slow frontend one) with
    the port's functions in place of the JAX package's."""
    for name in PORTED:
        monkeypatch.setattr(test_imu, name, getattr(imu, name))
    name, args = case
    getattr(test_imu, name)(*args)
