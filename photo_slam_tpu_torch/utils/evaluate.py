"""Trajectory evaluation: ATE RMSE with similarity (Umeyama) alignment.

photo_slam_tpu/utils/evaluate.py, copied (numpy only).

Fills the role of ORB-SLAM3's evaluate_ate_scale.py / the evo toolbox in the
reference's benchmark protocol (reference: README.md:180-218,
ORB-SLAM3/evaluation/evaluate_ate_scale.py): align estimated camera centers
to ground truth with the best-fit similarity transform and report the RMSE of
the residuals.
"""
from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = True):
    """Best-fit similarity transform mapping src -> dst.

    Returns (s, R, t) minimizing ||dst - (s R src + t)||^2 (Umeyama 1991).
    src/dst: [N, 3].
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs**2).sum() / src.shape[0]
    s = (D * S.diagonal()).sum() / var_s if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_centers: np.ndarray, gt_centers: np.ndarray,
             with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE after similarity alignment."""
    s, R, t = umeyama_alignment(est_centers, gt_centers, with_scale)
    aligned = est_centers @ (s * R).T + t
    err = np.linalg.norm(aligned - gt_centers, axis=1)
    return float(np.sqrt((err**2).mean()))


def load_tum_trajectory(path) -> np.ndarray:
    """Camera centers from a TUM-format trajectory file [N,3]."""
    rows = []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        vals = [float(x) for x in line.split()]
        rows.append(vals[1:4])
    return np.asarray(rows)
