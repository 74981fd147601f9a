"""Sim(3) similarity transforms + a similarity pose-graph optimizer.

photo_slam_tpu/utils/sim3.py, copied (numpy only).

The monocular scale-drift answer to the reference's 7DoF/4DoF essential-graph
optimization (reference: ORB-SLAM3/src/Optimizer.cc:1762
OptimizeEssentialGraph and LoopClosing::ComputeSim3): SE3 pose graphs cannot
absorb monocular scale drift around a loop, so loop corrections carry a
relative scale and each keyframe state is a similarity S = (s, R, t) with
  X_cam = s * R @ X_world + t.

The optimizer is plain numpy Gauss-Newton with numeric Jacobians: essential
graphs here are a few hundred nodes x 7 DoF, far below where a native solver
or analytic Jacobians would matter (the from-scratch C++ solvers in
native/slam_opt.cpp cover the per-frame hot paths; loop closure runs once
per revisit).
"""
from __future__ import annotations

import numpy as np


def so3_exp(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-10:
        return np.eye(3) + K
    return (np.eye(3) + np.sin(th) / th * K
            + (1 - np.cos(th)) / th**2 * (K @ K))


def so3_log(R: np.ndarray) -> np.ndarray:
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(c)
    if th < 1e-10:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]]) / 2.0
    return th / (2.0 * np.sin(th)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])


class Sim3:
    """s, R, t with X' = s * R @ X + t."""

    __slots__ = ("s", "R", "t")

    def __init__(self, s: float, R: np.ndarray, t: np.ndarray):
        self.s = float(s)
        self.R = np.asarray(R, np.float64)
        self.t = np.asarray(t, np.float64).reshape(3)

    @staticmethod
    def from_se3(T: np.ndarray, s: float = 1.0) -> "Sim3":
        return Sim3(s, T[:3, :3], T[:3, 3])

    def to_se3(self) -> np.ndarray:
        """Fold the scale out: [R | t/s] — the SE3 pose that is consistent
        once the map points around this camera are rescaled to the common
        gauge (reference: LoopClosing.cc CorrectLoop's Tiw = [R | t/s])."""
        T = np.eye(4)
        T[:3, :3] = self.R
        T[:3, 3] = self.t / self.s
        return T

    def apply(self, X: np.ndarray) -> np.ndarray:
        return self.s * (X @ self.R.T) + self.t

    def compose(self, other: "Sim3") -> "Sim3":
        """self o other (apply `other` first)."""
        return Sim3(self.s * other.s, self.R @ other.R,
                    self.s * (self.R @ other.t) + self.t)

    def inverse(self) -> "Sim3":
        Rt = self.R.T
        return Sim3(1.0 / self.s, Rt, -(Rt @ self.t) / self.s)

    def log7(self) -> np.ndarray:
        """Chart [t, log_SO3(R), ln s]: zero iff identity, smooth near it —
        sufficient as a pose-graph residual (exact Sim3 log's W-matrix
        coupling only reweights residuals near convergence)."""
        return np.concatenate([self.t, so3_log(self.R), [np.log(self.s)]])

    @staticmethod
    def exp7(v: np.ndarray) -> "Sim3":
        return Sim3(np.exp(v[6]), so3_exp(v[3:6]), v[:3])


def sim3_pose_graph_optimize(
    poses_tcw: np.ndarray,
    scales: np.ndarray,
    n_fixed: int,
    edges_i: np.ndarray,
    edges_j: np.ndarray,
    edges_T: np.ndarray,
    edges_s: np.ndarray,
    edges_w: np.ndarray | None = None,
    max_iters: int = 25,
) -> tuple[np.ndarray, np.ndarray]:
    """Optimize Sim3 states S_k = (scales[k], poses[k]) against relative
    similarity measurements S_ij = S_i o S_j^-1 (same edge convention as the
    SE3 pose graph in native/slam_opt.cpp): residual per edge
    r = log7(S_meas^-1 o S_i o S_j^-1), states updated by left-multiplied
    exp7 deltas. The first n_fixed states are anchored (gauge).

    Returns (poses_tcw [N,4,4] with scale folded out via t/s, scales [N]).
    """
    n = len(poses_tcw)
    S = [Sim3.from_se3(poses_tcw[k], scales[k]) for k in range(n)]
    ne = len(edges_i)
    w = np.ones(ne) if edges_w is None else np.asarray(edges_w, np.float64)
    meas_inv = [Sim3.from_se3(edges_T[e], edges_s[e]).inverse()
                for e in range(ne)]
    sw = np.sqrt(w)

    n_free = n - n_fixed
    if n_free <= 0 or ne == 0:
        return poses_tcw.copy(), np.asarray(scales, np.float64).copy()

    def edge_residual(e, Si, Sj):
        return meas_inv[e].compose(Si).compose(Sj.inverse()).log7()

    eps = 1e-6
    lm = 1e-8
    for _ in range(max_iters):
        H = np.zeros((7 * n_free, 7 * n_free))
        b = np.zeros(7 * n_free)
        cost = 0.0
        for e in range(ne):
            i, j = int(edges_i[e]), int(edges_j[e])
            r = edge_residual(e, S[i], S[j]) * sw[e]
            cost += r @ r
            blocks = []
            for node in (i, j):
                if node < n_fixed:
                    blocks.append((node, None))
                    continue
                J = np.zeros((7, 7))
                for d in range(7):
                    dv = np.zeros(7)
                    dv[d] = eps
                    Sp = Sim3.exp7(dv).compose(S[node])
                    rp = (edge_residual(e, Sp if node == i else S[i],
                                        Sp if node == j else S[j]) * sw[e])
                    J[:, d] = (rp - r) / eps
                blocks.append((node, J))
            for node_a, Ja in blocks:
                if Ja is None:
                    continue
                a0 = (node_a - n_fixed) * 7
                b[a0:a0 + 7] -= Ja.T @ r
                for node_b, Jb in blocks:
                    if Jb is None:
                        continue
                    b0 = (node_b - n_fixed) * 7
                    H[a0:a0 + 7, b0:b0 + 7] += Ja.T @ Jb
        H[np.diag_indices_from(H)] += lm + 1e-12
        try:
            dx = np.linalg.solve(H, b)
        except np.linalg.LinAlgError:
            break
        for k in range(n_free):
            S[n_fixed + k] = Sim3.exp7(dx[7 * k:7 * k + 7]).compose(
                S[n_fixed + k])
        if np.abs(dx).max() < 1e-10:
            break

    out_T = np.stack([s.to_se3() for s in S])
    out_s = np.array([s.s for s in S])
    return out_T, out_s
