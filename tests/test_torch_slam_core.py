"""The SLAM frontend's numpy modules in the port against the JAX package's:
the local map, the binary vocabulary and keyframe database, Sim3 and its
pose graph, the ATE evaluation, and the native optimizers (built by the
port into build/torch_native/) against their numpy twins and against the
JAX package's build of the same sources.

Tolerances: the port's numpy copies and the JAX package's agree exactly on
the same inputs; each native optimizer agrees with its numpy twin within
the JAX tests' bounds (tests/test_native.py, tests/test_slam_opt.py), and
with the JAX package's library exactly (the same source and flags)."""
import numpy as np
import pytest

from photo_slam_tpu import native as jnative
from photo_slam_tpu.tracking import local_map as jlocal_map
from photo_slam_tpu.tracking import vocab as jvocab
from photo_slam_tpu.utils import evaluate as jevaluate
from photo_slam_tpu.utils import sim3 as jsim3
from photo_slam_tpu_torch import native
from photo_slam_tpu_torch.tracking import local_map, vocab
from photo_slam_tpu_torch.utils import evaluate, sim3
from photo_slam_tpu_torch.utils.math import (se3_exp_numpy, se3_inverse,
                                             se3_log_numpy)
from test_native import synth_problem
from test_slam_opt import CX, CY, FX, FY, make_ba_problem, make_pose_graph
from test_vocab import _places, _sample_kf


# ---------------------------------------------------------------------------
# Native optimizers
# ---------------------------------------------------------------------------

def test_native_builds_into_build_dir():
    paths = native.build()
    for name, path in paths.items():
        assert path.parent == native.BUILD_DIR
        assert path.parent.parts[-2:] == ("build", "torch_native")
        assert path == native.library_path(name) and path.exists()
    native.pose_optimize(*synth_problem()[:2], FX, FY, CX, CY, np.eye(4))
    assert native.libraries()["pose_ba"] == paths["pose_ba"]


def test_native_build_failure_raises(tmp_path, monkeypatch):
    (tmp_path / "src").mkdir()
    broken = {name: tmp_path / "src" / src.name
              for name, src in native.SOURCES.items()}
    for src in broken.values():
        src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCES", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native build failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))


def pose_case(case):
    """tests/test_native.py's problems: (points, obs, T0, kwargs)."""
    if case == "identity":
        pts, obs, _, T_true = synth_problem()
        return pts, obs, np.eye(4), dict(max_iters=50), T_true
    if case == "outliers":
        pts, obs, _, T_true = synth_problem(noise_px=0.3)
        rng = np.random.RandomState(1)
        bad = rng.choice(len(obs), len(obs) * 15 // 100, replace=False)
        obs[bad] += rng.uniform(30, 80, (len(bad), 2))
        return pts, obs, np.eye(4), dict(huber_delta=2.0, max_iters=60), \
            T_true
    pts, obs, _, T_true = synth_problem(noise_px=0.2, seed=3)
    T0 = T_true.copy()
    T0[:3, 3] += [0.05, -0.03, 0.08]
    return pts, obs, T0, dict(max_iters=30), T_true


@pytest.mark.parametrize("case", ["identity", "outliers", "noisy_start"])
def test_pose_optimize(case):
    pts, obs, T0, kw, T_true = pose_case(case)
    n, T, cost = native.pose_optimize(pts, obs, FX, FY, CX, CY, T0, **kw)
    jn, jT, jcost = jnative.pose_optimize(pts, obs, FX, FY, CX, CY, T0, **kw)
    assert n == jn and cost == jcost
    np.testing.assert_array_equal(T, jT)
    if case == "identity":
        np.testing.assert_allclose(T, T_true, atol=1e-5)
        assert n == len(pts) and cost < 1e-6
    elif case == "outliers":
        np.testing.assert_allclose(T[:3, 3], T_true[:3, 3], atol=0.02)
    else:
        err0 = np.linalg.norm(T0[:3, 3] - T_true[:3, 3])
        assert np.linalg.norm(T[:3, 3] - T_true[:3, 3]) < err0 * 0.2


def test_pose_optimize_matches_numpy_twin():
    pts, obs, _, _ = synth_problem(noise_px=0.5, seed=2)
    n1, T1, _ = native.pose_optimize(pts, obs, FX, FY, CX, CY, np.eye(4),
                                     max_iters=30)
    n2, T2, _ = native.pose_optimize_numpy(pts, obs, FX, FY, CX, CY, 3.0,
                                           5.0, 30, np.eye(4))
    np.testing.assert_allclose(T1, T2, atol=1e-4)
    assert n1 == n2


def test_local_ba_matches_numpy_twin_and_jax():
    (_, _, poses0, points0, op, ol, uv) = make_ba_problem(
        n_poses=3, n_points=40, pose_noise=0.02, point_noise=0.02, seed=7)
    _, P, X = native.local_ba(poses0, 1, points0, op, ol, uv, FX, FY, CX,
                              CY, max_iters=15)
    _, P_np, X_np = native.local_ba_numpy(
        poses0.copy(), 1, points0.copy(), op, ol, uv, FX, FY, CX, CY, 3.0,
        5.0, 15)
    assert np.abs(P - P_np).max() < 1e-4
    assert np.abs(X - X_np).max() < 1e-3
    _, jP, jX = jnative.local_ba(poses0, 1, points0, op, ol, uv, FX, FY, CX,
                                 CY, max_iters=15)
    np.testing.assert_array_equal(P, jP)
    np.testing.assert_array_equal(X, jX)


def test_pose_graph_matches_numpy_twin_and_jax():
    gt, init, (ei, ej, eT, ew) = make_pose_graph(n=8, drift=0.03, seed=2)
    P = native.pose_graph_optimize(init, 1, ei, ej, eT, ew, max_iters=20)
    P_np = native.pose_graph_numpy(init.copy(), 1, ei, ej, eT, ew, 20)
    for i in range(len(init)):
        assert np.abs(se3_log_numpy(P[i] @ se3_inverse(P_np[i]))).max() \
            < 1e-3
    np.testing.assert_array_equal(
        P, jnative.pose_graph_optimize(init, 1, ei, ej, eT, ew,
                                       max_iters=20))
    err0 = max(np.abs(se3_log_numpy(init[i] @ se3_inverse(gt[i]))).max()
               for i in range(len(gt)))
    err1 = max(np.abs(se3_log_numpy(P[i] @ se3_inverse(gt[i]))).max()
               for i in range(len(gt)))
    assert err1 < err0


# ---------------------------------------------------------------------------
# Vocabulary and keyframe database (tests/test_vocab.py's cases)
# ---------------------------------------------------------------------------

def build_db(mod, seed, kfs_per_place=4, n_places=4):
    rng = np.random.RandomState(seed)
    protos = _places(rng, n_places)
    db = mod.KeyframeDatabase(train_min_kfs=4, train_min_desc=800, seed=0)
    place_of = {}
    kfid = 0
    for _ in range(kfs_per_place):
        for p in range(n_places):
            db.add(kfid, _sample_kf(rng, protos[p]))
            place_of[kfid] = p
            kfid += 1
    return db, place_of, protos, rng


def test_vocab_train_matches_jax():
    rng = np.random.RandomState(0)
    protos = rng.randint(0, 256, (8, 32), dtype=np.uint8)
    desc = _sample_kf(rng, protos, n=2000, flip=0.01)
    v = vocab.BinaryVocab.train(desc, k=8, seed=1)
    jv = jvocab.BinaryVocab.train(desc, k=8, seed=1)
    np.testing.assert_array_equal(v.words, jv.words)
    q = _sample_kf(rng, protos[:1], n=50, flip=0.01)
    a = v.assign(q)
    np.testing.assert_array_equal(a, jv.assign(q))
    assert len(np.unique(a)) <= 2 and np.bincount(a).max() >= 40
    # Assignment is the Hamming argmin.
    pop = np.array([bin(i).count("1") for i in range(256)])
    d = pop[np.bitwise_xor(q[:, None, :], v.words[None])].sum(2)
    np.testing.assert_array_equal(a, d.argmin(1))


@pytest.mark.parametrize("case", ["precision", "scores", "raw_query",
                                  "exclusion"])
def test_keyframe_database(case):
    seed = {"precision": 2, "scores": 3, "raw_query": 4, "exclusion": 6}[case]
    db, place_of, protos, rng = build_db(vocab, seed)
    jdb = build_db(jvocab, seed)[0]
    assert db.trained
    np.testing.assert_array_equal(db.vocab.words, jdb.vocab.words)
    if case == "precision":
        for q in place_of:
            hits = db.query(q, topk=2)
            assert hits == jdb.query(q, topk=2)
            assert all(place_of[k] == place_of[q] for k, _ in hits)
    elif case == "scores":
        same = [db.score(a, b) for a in place_of for b in place_of
                if a < b and place_of[a] == place_of[b]]
        diff = [db.score(a, b) for a in place_of for b in place_of
                if a < b and place_of[a] != place_of[b]]
        assert min(same) > max(diff) + 0.1
        assert db.score(0, 4) == jdb.score(0, 4)
    elif case == "raw_query":
        q = _sample_kf(rng, protos[2])
        hits = db.query(q, topk=3)
        assert hits == jdb.query(q, topk=3)
        assert all(place_of[k] == 2 for k, _ in hits)
    else:
        excl = {k for k, p in place_of.items() if p == 0}
        hits = db.query(0, exclude=excl)
        assert hits == jdb.query(0, exclude=excl)
        assert all(place_of[k] != 0 for k, _ in hits)


def test_untrained_database_returns_nothing():
    rng = np.random.RandomState(5)
    db = vocab.KeyframeDatabase(train_min_kfs=100, train_min_desc=10**9)
    db.add(0, rng.randint(0, 256, (200, 32), dtype=np.uint8))
    assert not db.trained and db.query(0) == [] and db.score(0, 0) == 0.0
    assert 0 in db


# ---------------------------------------------------------------------------
# Local map
# ---------------------------------------------------------------------------

def grow_map(mod):
    """Three keyframes over a shared point set, then a cull."""
    rng = np.random.RandomState(0)
    m = mod.LocalMap()
    ids0 = m.add_points(rng.randn(60, 3), rng.randint(0, 256, (60, 32),
                                                       dtype=np.uint8),
                        rng.rand(60, 3).astype(np.float32), 0)
    for kfid in range(3):
        mp = np.full(80, -1, np.int64)
        mp[:50] = ids0[kfid * 5:kfid * 5 + 50]
        m.add_keyframe(mod.KeyframeNode(
            kfid=kfid, tcw=np.eye(4), kps_px=rng.rand(80, 2) * 100,
            desc=rng.randint(0, 256, (80, 32), dtype=np.uint8), mp_ids=mp))
    m.add_points(rng.randn(5000, 3), np.zeros((5000, 32), np.uint8),
                 np.zeros((5000, 3), np.float32), 1)
    dropped = m.cull_points(4)
    return m, dropped


def test_local_map_matches_jax():
    m, dropped = grow_map(local_map)
    jm, jdropped = grow_map(jlocal_map)
    assert dropped == jdropped == 5000 + 10
    assert m.num_points == jm.num_points == 50
    for kfid in range(3):
        assert m.covisible_kfs(kfid) == jm.covisible_kfs(kfid)
        np.testing.assert_array_equal(m.keyframes[kfid].mp_ids,
                                      jm.keyframes[kfid].mp_ids)
    assert m.covisible_kfs(0) == [1, 2]
    np.testing.assert_array_equal(m.point_ids_of_kfs([0, 2]),
                                  jm.point_ids_of_kfs([0, 2]))
    np.testing.assert_array_equal(m.xyz, jm.xyz)


# ---------------------------------------------------------------------------
# Sim3 and evaluation
# ---------------------------------------------------------------------------

def test_sim3_algebra():
    rng = np.random.RandomState(0)
    a = sim3.Sim3(1.3, se3_exp_numpy(rng.randn(6))[:3, :3], rng.randn(3))
    b = sim3.Sim3(0.7, se3_exp_numpy(rng.randn(6))[:3, :3], rng.randn(3))
    X = rng.randn(20, 3)
    np.testing.assert_allclose(a.compose(b).apply(X), a.apply(b.apply(X)),
                               atol=1e-12)
    np.testing.assert_allclose(a.inverse().apply(a.apply(X)), X, atol=1e-12)
    v = rng.randn(7) * 0.3
    np.testing.assert_allclose(sim3.Sim3.exp7(v).log7(), v, atol=1e-9)
    ja = jsim3.Sim3(a.s, a.R, a.t)
    np.testing.assert_array_equal(a.log7(), ja.log7())
    np.testing.assert_array_equal(a.to_se3(), ja.to_se3())


def test_sim3_pose_graph_matches_jax():
    gt, init, (ei, ej, eT, ew) = make_pose_graph(n=6, drift=0.03, seed=1)
    es = np.ones(len(ei))
    es[-1] = 1.1
    got = sim3.sim3_pose_graph_optimize(init, np.ones(6), 1, ei, ej, eT, es,
                                        ew, max_iters=10)
    want = jsim3.sim3_pose_graph_optimize(init, np.ones(6), 1, ei, ej, eT,
                                          es, ew, max_iters=10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert abs(got[1][-1] - 1.0) > 1e-3  # the scale edge moved a scale


def test_evaluate_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    gt = rng.randn(30, 3)
    R = se3_exp_numpy(np.array([0, 0, 0, 0.1, -0.2, 0.3]))[:3, :3]
    est = 0.5 * gt @ R.T + np.array([1.0, 2.0, 3.0])
    s, Ra, t = evaluate.umeyama_alignment(est, gt)
    np.testing.assert_allclose(s * est @ Ra.T + t, gt, atol=1e-12)
    assert evaluate.ate_rmse(est, gt) < 1e-12
    noisy = gt + 0.01 * rng.randn(30, 3)
    assert evaluate.ate_rmse(noisy, gt) == jevaluate.ate_rmse(noisy, gt) > 0
    path = tmp_path / "traj.txt"
    path.write_text("# t x y z qx qy qz qw\n" + "".join(
        f"{i} {x} {y} {z} 0 0 0 1\n" for i, (x, y, z) in enumerate(gt)))
    np.testing.assert_array_equal(evaluate.load_tum_trajectory(path), gt)
