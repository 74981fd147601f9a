"""The host C++ libraries of the port, loaded over ctypes.

Counterpart of photo_slam_tpu/native/__init__.py. The SLAM frontend's
optimizers are the repository's own `native/pose_ba.cpp` (motion-only
bundle adjustment, the role of ORB-SLAM3's Optimizer::PoseOptimization)
and `native/slam_opt.cpp` (windowed local BA with a Schur complement and
the SE3 pose graph, the roles of Optimizer::LocalBundleAdjustment and
OptimizeEssentialGraph, reference: ORB-SLAM3/src/Optimizer.cc:1116,
:1762), compiled unchanged. The port's own host sources sit in
`photo_slam_tpu_torch/csrc_host/` (`jpeg.cpp`, the JPEG decoder of
io/jpeg.py). Each is compiled with `g++ -O3 -shared -fPIC -std=c++17`
into `<checkout>/build/torch_native/`, one library per source named by a
digest of the source and the flags, at first use; the two optimizers'
compilers start together. Nothing is written next to the sources.

A failed build raises with g++'s output: there is no silent fallback. The
numpy versions (`pose_optimize_numpy`, `local_ba_numpy`,
`pose_graph_numpy`) are the plain twins, reached only by name.

`calls` counts the calls into each native function, so a caller can show
that a run went through the built libraries (`libraries()` names them).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from photo_slam_tpu_torch.utils.math import se3_exp_numpy, se3_log_numpy

SRC_DIR = Path(__file__).resolve().parent.parent / "native"
HOST_DIR = Path(__file__).resolve().parent / "csrc_host"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
SOURCES = {"pose_ba": SRC_DIR / "pose_ba.cpp",
           "slam_opt": SRC_DIR / "slam_opt.cpp",
           "jpeg": HOST_DIR / "jpeg.cpp"}
OPTIMIZERS = ("pose_ba", "slam_opt")

calls = {"pose_optimize": 0, "local_ba": 0, "pose_graph_optimize": 0}
_build_lock = threading.Lock()
_loaded: dict[str, Path] = {}

_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_D, _I = ctypes.c_double, ctypes.c_int


def library_path(name: str) -> Path:
    """build/torch_native/lib<name>-<digest>.so for SOURCES[name]."""
    h = hashlib.sha256(SOURCES[name].read_bytes())
    h.update("\0".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile the named libraries (default: all) that are not built yet,
    one g++ per source, started together. Raises with g++'s output if a
    build fails. Returns {name: library path}."""
    with _build_lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        paths = {n: library_path(n) for n in (names or SOURCES)}
        procs = {}
        for n, p in paths.items():
            if not p.exists():
                tmp = p.with_suffix(f".{os.getpid()}.tmp")
                procs[n] = (subprocess.Popen(
                    ["g++", *GXX_FLAGS, str(SOURCES[n]), "-o",
                     str(tmp)], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT), tmp)
        failed = []
        for n, (proc, tmp) in procs.items():
            out = proc.communicate(timeout=300)[0].decode(errors="replace")
            if proc.returncode != 0:
                failed.append(f"--- g++ {SOURCES[n].name} (exit "
                              f"{proc.returncode})\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, paths[n])
        if failed:
            raise RuntimeError("native build failed:\n" + "\n".join(failed))
        return paths


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    path = build(OPTIMIZERS if name in OPTIMIZERS else (name,))[name]
    lib = ctypes.CDLL(str(path))
    _loaded[name] = path
    if name == "jpeg":
        for fn in (lib.jpeg_info, lib.jpeg_decode):
            fn.restype = _I
        lib.jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                  ctypes.POINTER(_I), ctypes.POINTER(_I),
                                  ctypes.POINTER(_I), ctypes.c_char_p, _I]
        lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, _I,
                                    ctypes.c_void_p, ctypes.c_char_p, _I]
    elif name == "pose_ba":
        lib.pose_optimize.restype = _I
        lib.pose_optimize.argtypes = [_I, _f64, _f64, _D, _D, _D, _D, _D, _D,
                                      _I, _f64, ctypes.POINTER(_D)]
    else:
        lib.local_ba.restype = _I
        lib.local_ba.argtypes = [_I, _I, _f64, _I, _f64, _I, _i32, _i32,
                                 _f64, _f64, _f64, _D, _D, _D, _D, _D, _D,
                                 _I]
        lib.pose_graph_optimize.restype = _I
        lib.pose_graph_optimize.argtypes = [_I, _I, _f64, _I, _i32, _i32,
                                            _f64, _f64, _I]
    return lib


def libraries() -> dict[str, Path]:
    """The library files loaded so far, by source name."""
    return dict(_loaded)


# ---------------------------------------------------------------------------
# Motion-only BA (pose_ba.cpp)
# ---------------------------------------------------------------------------

def _project(T, pts, fx, fy, cx, cy):
    xc = pts @ T[:3, :3].T + T[:3, 3]
    z = np.maximum(xc[:, 2], 1e-9)
    return np.stack([fx * xc[:, 0] / z + cx, fy * xc[:, 1] / z + cy], 1), xc


def pose_optimize_numpy(points, obs, fx, fy, cx, cy, huber, chi2, iters, T):
    """Plain Gauss-Newton twin of pose_ba.cpp (same math)."""
    lam = 1e-4

    def cost_of(Tc):
        uv, xc = _project(Tc, points, fx, fy, cx, cy)
        e = np.linalg.norm(uv - obs, axis=1)
        c = np.where(e <= huber, 0.5 * e**2, huber * (e - 0.5 * huber))
        return c[xc[:, 2] > 1e-6].sum()

    cost = cost_of(T)
    for _ in range(iters):
        uv, xc = _project(T, points, fx, fy, cx, cy)
        ok = xc[:, 2] > 1e-6
        r = (uv - obs)[ok]
        X = xc[ok]
        e = np.linalg.norm(r, axis=1)
        w = np.where(e <= huber, 1.0, huber / np.maximum(e, 1e-12))
        iz = 1.0 / X[:, 2]
        Ju = np.stack([fx * iz, np.zeros_like(iz), -fx * X[:, 0] * iz**2], 1)
        Jv = np.stack([np.zeros_like(iz), fy * iz, -fy * X[:, 1] * iz**2], 1)

        def full(Jp):
            rot = -np.stack([
                Jp[:, 1] * X[:, 2] - Jp[:, 2] * X[:, 1],
                Jp[:, 2] * X[:, 0] - Jp[:, 0] * X[:, 2],
                Jp[:, 0] * X[:, 1] - Jp[:, 1] * X[:, 0],
            ], 1)
            return np.concatenate([Jp, rot], 1)

        Ja, Jb = full(Ju), full(Jv)
        H = (w[:, None, None] * (Ja[:, :, None] * Ja[:, None, :]
                                 + Jb[:, :, None] * Jb[:, None, :])).sum(0)
        g = (w[:, None] * (Ja * r[:, 0:1] + Jb * r[:, 1:2])).sum(0)
        try:
            dx = -np.linalg.solve(H + lam * (np.eye(6) * (1 + np.diag(H))), g)
        except np.linalg.LinAlgError:
            lam *= 10
            continue
        th = np.linalg.norm(dx[3:])
        if th < 1e-12:
            R = np.eye(3)
        else:
            k = dx[3:] / th
            K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                          [-k[1], k[0], 0]])
            R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
        T_try = T.copy()
        T_try[:3, :3] = R @ T[:3, :3]
        T_try[:3, 3] = R @ T[:3, 3] + dx[:3]
        c2 = cost_of(T_try)
        if c2 < cost:
            T, cost, lam = T_try, c2, max(lam * 0.5, 1e-9)
        else:
            lam *= 10
            if lam > 1e6:
                break
    uv, xc = _project(T, points, fx, fy, cx, cy)
    inl = ((np.linalg.norm(uv - obs, axis=1) < chi2) & (xc[:, 2] > 1e-6)).sum()
    return int(inl), T, cost


def pose_optimize(points_world: np.ndarray, obs_px: np.ndarray, fx, fy, cx,
                  cy, pose_tcw: np.ndarray, huber_delta: float = 3.0,
                  chi2_px: float = 5.0, max_iters: int = 10):
    """Refine a world->camera pose against fixed 3D points.

    Returns (num_inliers, refined_pose_4x4, final_cost)."""
    pts = np.ascontiguousarray(points_world, np.float64)
    obs = np.ascontiguousarray(obs_px, np.float64)
    T = np.ascontiguousarray(pose_tcw, np.float64).reshape(4, 4).copy()
    lib = _lib("pose_ba")
    calls["pose_optimize"] += 1
    cost = ctypes.c_double(0.0)
    flat = np.ascontiguousarray(T.reshape(-1))
    n = lib.pose_optimize(pts.shape[0], pts, obs, fx, fy, cx, cy,
                          huber_delta, chi2_px, max_iters, flat,
                          ctypes.byref(cost))
    return int(n), flat.reshape(4, 4), float(cost.value)


# ---------------------------------------------------------------------------
# Local BA and the SE3 pose graph (slam_opt.cpp)
# ---------------------------------------------------------------------------

def local_ba_numpy(poses, n_fixed, points, obs_pose, obs_point, obs_uv,
                   fx, fy, cx, cy, huber, chi2, iters, obs_depth=None,
                   obs_dw=None):
    """Plain dense Gauss-Newton twin of slam_opt.cpp's local_ba (no Schur):
    state = free poses (6 each) + points."""
    n_poses, n_points, n_obs = len(poses), len(points), len(obs_pose)
    n_free = n_poses - n_fixed
    np_dim = 6 * n_free
    has_d = obs_dw is not None and (np.asarray(obs_dw) > 0).any()

    def project_all(P, X):
        T = P[obs_pose]
        pw = X[obs_point]
        xc = np.einsum("oij,oj->oi", T[:, :3, :3], pw) + T[:, :3, 3]
        z = np.maximum(xc[:, 2], 1e-9)
        uv = np.stack([fx * xc[:, 0] / z + cx, fy * xc[:, 1] / z + cy], 1)
        return uv, xc

    def cost_of(P, X):
        uv, xc = project_all(P, X)
        e = np.linalg.norm(uv - obs_uv, axis=1)
        c = np.where(e <= huber, 0.5 * e**2, huber * (e - 0.5 * huber))
        c = np.where(xc[:, 2] > 1e-6, c, huber * huber)
        total = c.sum()
        if has_d:
            rd = np.asarray(obs_dw) * (xc[:, 2] - np.asarray(obs_depth))
            rd = np.where(np.asarray(obs_dw) > 0, rd, 0.0)
            ed = np.abs(rd)
            total += np.where(ed <= huber, 0.5 * rd**2,
                              huber * (ed - 0.5 * huber)).sum()
        return total

    P = poses.copy()
    X = points.copy()
    lam = 1e-5
    cost = cost_of(P, X)
    dim = np_dim + 3 * n_points
    for _ in range(iters):
        uv, xc = project_all(P, X)
        ok = xc[:, 2] > 1e-6
        r = uv - obs_uv
        e = np.linalg.norm(r, axis=1)
        w = np.where(e <= huber, 1.0, huber / np.maximum(e, 1e-12))
        w = np.where(ok, w, 0.0)
        iz = 1.0 / np.maximum(xc[:, 2], 1e-9)
        Ju = np.stack([fx * iz, np.zeros_like(iz), -fx * xc[:, 0] * iz**2], 1)
        Jv = np.stack([np.zeros_like(iz), fy * iz, -fy * xc[:, 1] * iz**2], 1)

        def rot(Jp):
            return -np.stack([
                Jp[:, 1] * xc[:, 2] - Jp[:, 2] * xc[:, 1],
                Jp[:, 2] * xc[:, 0] - Jp[:, 0] * xc[:, 2],
                Jp[:, 0] * xc[:, 1] - Jp[:, 1] * xc[:, 0]], 1)

        Ja = np.concatenate([Ju, rot(Ju)], 1)  # [O,6]
        Jb = np.concatenate([Jv, rot(Jv)], 1)
        R = P[obs_pose][:, :3, :3]
        JuX = np.einsum("oi,oij->oj", Ju, R)  # [O,3]
        JvX = np.einsum("oi,oij->oj", Jv, R)

        H = np.zeros((dim, dim))
        g = np.zeros(dim)
        for o in range(n_obs):
            idx, Jrow_u, Jrow_v = [], [], []
            pi = obs_pose[o]
            if pi >= n_fixed:
                f0 = 6 * (pi - n_fixed)
                idx.extend(range(f0, f0 + 6))
                Jrow_u.extend(Ja[o])
                Jrow_v.extend(Jb[o])
            l0 = np_dim + 3 * obs_point[o]
            idx.extend(range(l0, l0 + 3))
            Jrow_u.extend(JuX[o])
            Jrow_v.extend(JvX[o])
            idx = np.array(idx)
            Jr_u = np.array(Jrow_u)
            Jr_v = np.array(Jrow_v)
            H[np.ix_(idx, idx)] += w[o] * (np.outer(Jr_u, Jr_u)
                                           + np.outer(Jr_v, Jr_v))
            g[idx] += w[o] * (Jr_u * r[o, 0] + Jr_v * r[o, 1])
            if has_d and obs_dw[o] > 0:
                wd = obs_dw[o]
                rd = wd * (xc[o, 2] - obs_depth[o])
                ed = abs(rd)
                wh = 1.0 if (huber <= 0 or ed <= huber) else huber / max(
                    ed, 1e-12)
                Jrow_d = []
                if pi >= n_fixed:
                    Jrow_d.extend([0.0, 0.0, wd, wd * xc[o, 1],
                                   -wd * xc[o, 0], 0.0])
                Jrow_d.extend(wd * P[pi][2, :3])
                Jr_d = np.array(Jrow_d)
                H[np.ix_(idx, idx)] += wh * np.outer(Jr_d, Jr_d)
                g[idx] += wh * Jr_d * rd
        try:
            dx = -np.linalg.solve(H + lam * (np.eye(dim) * (1 + np.diag(H))),
                                  g)
        except np.linalg.LinAlgError:
            lam *= 10
            continue
        P_try = P.copy()
        X_try = X + dx[np_dim:].reshape(-1, 3)
        for f in range(n_free):
            P_try[n_fixed + f] = (se3_exp_numpy(dx[6 * f:6 * f + 6])
                                  @ P_try[n_fixed + f])
        c2 = cost_of(P_try, X_try)
        if c2 < cost:
            P, X, cost, lam = P_try, X_try, c2, max(lam * 0.5, 1e-9)
        else:
            lam *= 10
            if lam > 1e8:
                break
    uv, xc = project_all(P, X)
    inl = ((np.linalg.norm(uv - obs_uv, axis=1) < chi2)
           & (xc[:, 2] > 1e-6)).sum()
    return int(inl), P, X


def _ba_solve_once(P, n_fixed, X, op, ol, uv, fx, fy, cx, cy, huber,
                   chi2_px, max_iters, od, ow):
    lib = _lib("slam_opt")
    calls["local_ba"] += 1
    flatP = np.ascontiguousarray(P.reshape(len(P), 16))
    n = lib.local_ba(len(P), n_fixed, flatP, len(X), X, len(op), op, ol,
                     uv, od, ow, fx, fy, cx, cy, huber, chi2_px, max_iters)
    return int(n), flatP.reshape(-1, 4, 4), X


def _reproj_err(P, X, op, ol, uv, fx, fy, cx, cy):
    T = P[op]
    xc = np.einsum("oij,oj->oi", T[:, :3, :3], X[ol]) + T[:, :3, 3]
    z = np.maximum(xc[:, 2], 1e-9)
    u = fx * xc[:, 0] / z + cx
    v = fy * xc[:, 1] / z + cy
    err = np.hypot(u - uv[:, 0], v - uv[:, 1])
    return np.where(xc[:, 2] > 1e-6, err, np.inf)


def local_ba(poses_tcw: np.ndarray, n_fixed: int, points: np.ndarray,
             obs_pose: np.ndarray, obs_point: np.ndarray, obs_uv: np.ndarray,
             fx, fy, cx, cy, huber: float = 3.0, chi2_px: float = 5.0,
             max_iters: int = 10, obs_depth=None, obs_depth_weight=None):
    """Sliding-window bundle adjustment (reference:
    ORB-SLAM3/src/Optimizer.cc:1116 LocalBundleAdjustment).

    poses_tcw [P,4,4] world->camera (first n_fixed held constant), points
    [M,3] world, observations (pose idx, point idx, pixel uv), optional
    per-observation depth constraints (obs_depth [O], obs_depth_weight [O],
    <= 0 disables). Two rounds with a chi2 outlier cut between them.
    Returns (num_inliers, poses, points), copies."""
    P = np.ascontiguousarray(poses_tcw, np.float64).copy()
    X = np.ascontiguousarray(points, np.float64).copy()
    op = np.ascontiguousarray(obs_pose, np.int32)
    ol = np.ascontiguousarray(obs_point, np.int32)
    uv = np.ascontiguousarray(obs_uv, np.float64)
    od = (np.zeros(len(op)) if obs_depth is None
          else np.ascontiguousarray(obs_depth, np.float64))
    ow = (np.zeros(len(op)) if obs_depth_weight is None
          else np.ascontiguousarray(obs_depth_weight, np.float64))

    it1 = max(max_iters // 2, 3)
    _, P, X = _ba_solve_once(P, n_fixed, X, op, ol, uv, fx, fy, cx, cy,
                             huber, chi2_px, it1, od, ow)
    for cut in (2.0 * chi2_px, chi2_px):
        err = _reproj_err(P, X, op, ol, uv, fx, fy, cx, cy)
        keep = err < cut
        if keep.sum() < 6 or keep.sum() == len(op):
            continue
        # Points that lost all observations stay untouched by this round.
        _, P, X = _ba_solve_once(P, n_fixed, X, op[keep], ol[keep],
                                 np.ascontiguousarray(uv[keep]), fx, fy,
                                 cx, cy, huber, chi2_px, max_iters,
                                 np.ascontiguousarray(od[keep]),
                                 np.ascontiguousarray(ow[keep]))
    err = _reproj_err(P, X, op, ol, uv, fx, fy, cx, cy)
    return int((err < chi2_px).sum()), P, X


def pose_graph_numpy(poses, n_fixed, ei, ej, eT, ew, iters):
    """Plain numeric-Jacobian Gauss-Newton twin of slam_opt.cpp's
    pose_graph_optimize."""
    P = poses.copy()
    n_free = len(P) - n_fixed
    if n_free <= 0:
        return P
    n = 6 * n_free

    def resid(P, e):
        M = np.linalg.inv(eT[e]) @ P[ei[e]] @ np.linalg.inv(P[ej[e]])
        return se3_log_numpy(M)

    def cost_of(P):
        return sum(0.5 * ew[e] * (resid(P, e) ** 2).sum()
                   for e in range(len(ei)))

    lam = 1e-6
    cost = cost_of(P)
    eps = 1e-6
    for _ in range(iters):
        H = np.zeros((n, n))
        g = np.zeros(n)
        for e in range(len(ei)):
            r0 = resid(P, e)
            rows = []
            for node in (ei[e], ej[e]):
                if node < n_fixed:
                    continue
                J = np.zeros((6, 6))
                for d in range(6):
                    xi = np.zeros(6)
                    xi[d] = eps
                    save = P[node].copy()
                    P[node] = se3_exp_numpy(xi) @ P[node]
                    J[:, d] = (resid(P, e) - r0) / eps
                    P[node] = save
                rows.append((node, J))
            for node, J in rows:
                f0 = 6 * (node - n_fixed)
                g[f0:f0 + 6] += ew[e] * J.T @ r0
                for node2, J2 in rows:
                    f1 = 6 * (node2 - n_fixed)
                    H[f0:f0 + 6, f1:f1 + 6] += ew[e] * J.T @ J2
        try:
            dx = -np.linalg.solve(H + lam * (np.eye(n) * (1 + np.diag(H))), g)
        except np.linalg.LinAlgError:
            lam *= 10
            continue
        P_try = P.copy()
        for f in range(n_free):
            P_try[n_fixed + f] = (se3_exp_numpy(dx[6 * f:6 * f + 6])
                                  @ P_try[n_fixed + f])
        c2 = cost_of(P_try)
        if c2 < cost:
            P, cost, lam = P_try, c2, max(lam * 0.5, 1e-10)
        else:
            lam *= 10
            if lam > 1e8:
                break
    return P


def pose_graph_optimize(poses_tcw: np.ndarray, n_fixed: int,
                        edges_i: np.ndarray, edges_j: np.ndarray,
                        edges_T: np.ndarray, edges_w=None,
                        max_iters: int = 20) -> np.ndarray:
    """SE3 pose-graph optimization (reference:
    ORB-SLAM3/src/Optimizer.cc:1762 OptimizeEssentialGraph).

    poses_tcw [N,4,4]; edges (i, j, T_ij = Ti @ inv(Tj) measured, weight).
    Returns the corrected poses (a copy)."""
    P = np.ascontiguousarray(poses_tcw, np.float64).copy()
    ei = np.ascontiguousarray(edges_i, np.int32)
    ej = np.ascontiguousarray(edges_j, np.int32)
    eT = np.ascontiguousarray(edges_T, np.float64)
    ew = (np.ones(len(ei)) if edges_w is None
          else np.ascontiguousarray(edges_w, np.float64))
    lib = _lib("slam_opt")
    calls["pose_graph_optimize"] += 1
    flat = np.ascontiguousarray(P.reshape(len(P), 16))
    lib.pose_graph_optimize(len(P), n_fixed, flat, len(ei), ei, ej,
                            np.ascontiguousarray(eT.reshape(len(ei), 16)),
                            ew, max_iters)
    return flat.reshape(-1, 4, 4)
