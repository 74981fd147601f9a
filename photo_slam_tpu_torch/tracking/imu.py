"""Inertial (IMU) support: preintegration, visual-inertial initialization,
and the ScaleRefinement bridge into the mapper.

Reference surface: ORB-SLAM3/include/ImuTypes.h + src/ImuTypes.cc
(IMU::Preintegrated::IntegrateNewMeasurement), src/LocalMapping.cc:1187-1340
(InitializeIMU) and :1449-1510 (ScaleRefinement). The IMU initialization is
the actual producer of the mapper's ScaleRefinement operations — the
gaussian mapper only consumes them (src/gaussian_mapper.cpp combine path;
the mapper's mapper/mapper.py + mapper/mapping_ops.py already do).

Everything here is host-side numpy: pose math on the tracking thread is
host work (a device call would be a per-frame round-trip). The math is the
standard on-manifold IMU preintegration of Forster et al. (TRO 2017),
re-derived here rather than translated:

  dR_{k+1} = dR_k Exp((w_k - bg) dt)
  dV_{k+1} = dV_k + dR_k (a_k - ba) dt
  dP_{k+1} = dP_k + dV_k dt + 1/2 dR_k (a_k - ba) dt^2

with first-order bias-correction Jacobians (J_Rg, J_Vg, J_Va, J_Pg, J_Pa)
accumulated alongside, so deltas can be re-expressed at an updated bias
without re-integrating raw measurements.

Visual-inertial initialization (`initialize_imu`) follows the reference's
two-stage shape: (1) gyro bias from rotation-only alignment of the
preintegrated dR against the visual relative rotations (Gauss-Newton, 3
unknowns); (2) scale + gravity + per-keyframe velocities from the dP/dV
preintegration identities, which are LINEAR in (s, g, v_i) — solved as one
least-squares system, then re-solved with gravity constrained to |g| = G on
its 2-dof tangent. The result maps to the mapper op exactly like
LocalMapping.cc:1296-1305: a ScaleRefinement with scale s and the
gravity-aligning rotation T_wg.

photo_slam_tpu/tracking/imu.py, copied (numpy, float64 on the host): the
port's frontend and its tests share it with nothing of the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

GRAVITY = 9.81
_EPS = 1e-12


def _skew(w: np.ndarray) -> np.ndarray:
    wx, wy, wz = float(w[0]), float(w[1]), float(w[2])
    return np.array([[0.0, -wz, wy], [wz, 0.0, -wx], [-wy, wx, 0.0]])


def so3_exp(w: np.ndarray) -> np.ndarray:
    """Rodrigues. Small-angle safe."""
    th = float(np.linalg.norm(w))
    K = _skew(w)
    if th < 1e-8:
        return np.eye(3) + K + 0.5 * (K @ K)
    return (np.eye(3) + np.sin(th) / th * K
            + (1.0 - np.cos(th)) / (th * th) * (K @ K))


def so3_log(R: np.ndarray) -> np.ndarray:
    c = max(-1.0, min(1.0, (np.trace(R) - 1.0) * 0.5))
    th = float(np.arccos(c))
    if th < 1e-8:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]]) * 0.5
    return (np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                      R[1, 0] - R[0, 1]]) * th / (2.0 * np.sin(th)))


def right_jacobian(w: np.ndarray) -> np.ndarray:
    """Right Jacobian of SO(3): Exp(w + dw) ~ Exp(w) Exp(Jr(w) dw)."""
    th = float(np.linalg.norm(w))
    K = _skew(w)
    if th < 1e-6:
        return np.eye(3) - 0.5 * K + (1.0 / 6.0) * (K @ K)
    th2 = th * th
    return (np.eye(3) - (1.0 - np.cos(th)) / th2 * K
            + (th - np.sin(th)) / (th2 * th) * (K @ K))


@dataclass
class ImuCalib:
    """IMU-camera calibration + continuous-time noise densities.

    Tbc: 4x4 body(IMU)-from-camera transform (EuRoC sensor.yaml
    T_BS^-1 * T_BC composition is done by the loader; here Tbc directly).
    Noise fields follow the reference yaml keys (IMU.NoiseGyro etc.).
    """
    Tbc: np.ndarray = field(default_factory=lambda: np.eye(4))
    noise_gyro: float = 1.7e-4
    noise_acc: float = 2.0e-3
    walk_gyro: float = 1.9e-5
    walk_acc: float = 3.0e-3
    freq: float = 200.0

    @property
    def Tcb(self) -> np.ndarray:
        T = np.eye(4)
        R = self.Tbc[:3, :3]
        T[:3, :3] = R.T
        T[:3, 3] = -R.T @ self.Tbc[:3, 3]
        return T


@dataclass
class ImuBias:
    bg: np.ndarray = field(default_factory=lambda: np.zeros(3))
    ba: np.ndarray = field(default_factory=lambda: np.zeros(3))

    def copy(self) -> "ImuBias":
        return ImuBias(self.bg.copy(), self.ba.copy())


class Preintegrated:
    """On-manifold preintegration of a gyro+accel measurement stream
    between two frames/keyframes, at a fixed linearization bias, with
    first-order bias-update Jacobians (ImuTypes.cc
    IntegrateNewMeasurement equivalent, re-derived)."""

    def __init__(self, bias: ImuBias | None = None,
                 calib: ImuCalib | None = None):
        self.bias = (bias or ImuBias()).copy()
        self.calib = calib or ImuCalib()
        self.dT = 0.0
        self.dR = np.eye(3)
        self.dV = np.zeros(3)
        self.dP = np.zeros(3)
        self.JRg = np.zeros((3, 3))
        self.JVg = np.zeros((3, 3))
        self.JVa = np.zeros((3, 3))
        self.JPg = np.zeros((3, 3))
        self.JPa = np.zeros((3, 3))
        # 9x9 covariance over (dR, dV, dP) tangent; propagated with the
        # standard discrete-time linearization.
        self.cov = np.zeros((9, 9))
        self._meas: list[tuple[np.ndarray, np.ndarray, float]] = []

    def integrate(self, acc: np.ndarray, gyro: np.ndarray, dt: float):
        """Fold one measurement (body-frame specific force + angular rate,
        held constant over dt) into the deltas. Order matters: position
        uses the PRE-update dV/dR (midpoint-free Euler, matching the
        reference)."""
        if dt <= 0.0:
            return
        acc = np.asarray(acc, np.float64)
        gyro = np.asarray(gyro, np.float64)
        self._meas.append((acc.copy(), gyro.copy(), float(dt)))
        a = acc - self.bias.ba
        w = gyro - self.bias.bg
        dR, dV = self.dR, self.dV
        A = _skew(a)

        # Position/velocity Jacobians use the pre-update dR.
        self.JPa += self.JVa * dt - 0.5 * dR * dt * dt
        self.JPg += self.JVg * dt - 0.5 * (dR @ A @ self.JRg) * dt * dt
        self.JVa -= dR * dt
        self.JVg -= (dR @ A @ self.JRg) * dt

        # Covariance propagation (block state x = [phi, v, p]).
        dRk = so3_exp(w * dt)
        F = np.eye(9)
        F[0:3, 0:3] = dRk.T
        F[3:6, 0:3] = -(dR @ A) * dt
        F[6:9, 0:3] = -0.5 * (dR @ A) * dt * dt
        F[6:9, 3:6] = np.eye(3) * dt
        G = np.zeros((9, 6))
        Jr = right_jacobian(w * dt)
        G[0:3, 0:3] = Jr * dt
        G[3:6, 3:6] = dR * dt
        G[6:9, 3:6] = 0.5 * dR * dt * dt
        # Discrete noise: continuous density / dt.
        ng2 = self.calib.noise_gyro ** 2 / dt
        na2 = self.calib.noise_acc ** 2 / dt
        Q = np.diag([ng2] * 3 + [na2] * 3)
        self.cov = F @ self.cov @ F.T + G @ Q @ G.T

        self.dP = self.dP + dV * dt + 0.5 * (dR @ a) * dt * dt
        self.dV = dV + (dR @ a) * dt
        self.JRg = dRk.T @ self.JRg - Jr * dt
        self.dR = dR @ dRk
        self.dT += dt

    def integrate_span(self, stamps, accs, gyros, t0: float, t1: float):
        """Integrate the measurements covering [t0, t1], splitting the
        boundary intervals like ORB-SLAM3's Tracking::PreintegrateIMU
        (boundary samples are weighted by the covered fraction)."""
        stamps = np.asarray(stamps, np.float64)
        n = len(stamps)
        for i in range(n):
            t = stamps[i]
            t_next = stamps[i + 1] if i + 1 < n else t1
            if t_next <= t0 or t >= t1:
                continue
            lo, hi = max(t, t0), min(t_next, t1)
            if hi > lo:
                self.integrate(accs[i], gyros[i], hi - lo)

    # --- bias-corrected deltas (first order) --------------------------
    def delta_rotation(self, bias: ImuBias) -> np.ndarray:
        dbg = bias.bg - self.bias.bg
        return self.dR @ so3_exp(self.JRg @ dbg)

    def delta_velocity(self, bias: ImuBias) -> np.ndarray:
        return (self.dV + self.JVg @ (bias.bg - self.bias.bg)
                + self.JVa @ (bias.ba - self.bias.ba))

    def delta_position(self, bias: ImuBias) -> np.ndarray:
        return (self.dP + self.JPg @ (bias.bg - self.bias.bg)
                + self.JPa @ (bias.ba - self.bias.ba))

    def reintegrate(self, bias: ImuBias):
        """Exact re-integration of the stored raw measurements at a new
        linearization bias (ImuTypes.cc Reintegrate equivalent)."""
        meas = self._meas
        self.__init__(bias, self.calib)
        for acc, gyro, dt in meas:
            self.integrate(acc, gyro, dt)

    def predict(self, Rwb: np.ndarray, vw: np.ndarray, pwb: np.ndarray,
                bias: ImuBias | None = None,
                gravity: np.ndarray | None = None):
        """Dead-reckon body state across this preintegration span."""
        b = bias or self.bias
        g = gravity if gravity is not None else np.array([0, 0, -GRAVITY])
        dt = self.dT
        R2 = Rwb @ self.delta_rotation(b)
        v2 = vw + g * dt + Rwb @ self.delta_velocity(b)
        p2 = (pwb + vw * dt + 0.5 * g * dt * dt
              + Rwb @ self.delta_position(b))
        return R2, v2, p2


def estimate_gyro_bias(Rwb: list[np.ndarray],
                       preints: list[Preintegrated]) -> np.ndarray:
    """Rotation-only gyro-bias alignment: minimize over bg the residuals
    Log((dR_i Exp(JRg_i bg))^T Rwb_i^T Rwb_{i+1}) for consecutive keyframe
    pairs. Gauss-Newton on 3 unknowns (the reference folds this into
    Optimizer::InertialOptimization; rotation-only is its observable
    core)."""
    bg = np.zeros(3)
    for _ in range(8):
        H = np.zeros((3, 3))
        b = np.zeros(3)
        for i, pre in enumerate(preints):
            dR_meas = pre.dR @ so3_exp(pre.JRg @ (bg - pre.bias.bg))
            dR_vis = Rwb[i].T @ Rwb[i + 1]
            r = so3_log(dR_meas.T @ dR_vis)
            # d r / d bg ~ -Jr_inv(r) ... first-order: J = -JRg is the
            # standard approximation; refine with Jr of the residual.
            J = -np.linalg.solve(right_jacobian(r), pre.JRg)
            H += J.T @ J
            b += J.T @ r
        if np.linalg.det(H) < _EPS:
            break
        step = -np.linalg.solve(H, b)
        bg = bg + step
        if np.linalg.norm(step) < 1e-10:
            break
    return bg


@dataclass
class ImuInitResult:
    ok: bool
    scale: float = 1.0
    Rwg: np.ndarray = field(default_factory=lambda: np.eye(3))
    gravity_w: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, -GRAVITY]))
    velocities: np.ndarray = field(default_factory=lambda: np.zeros((0, 3)))
    bias: ImuBias = field(default_factory=ImuBias)
    residual: float = 0.0


def initialize_imu(Rwb: list[np.ndarray], pwb: list[np.ndarray],
                   preints: list[Preintegrated],
                   monocular: bool = True) -> ImuInitResult:
    """Visual-inertial initialization over a temporally-ordered keyframe
    window (LocalMapping::InitializeIMU's estimation core, re-derived).

    Inputs: body rotations/positions from VISUAL tracking (positions are
    up-to-scale when monocular), and the preintegration between each
    consecutive pair (len(preints) == len(Rwb) - 1).

    Stage 1: gyro bias (rotation-only GN), deltas re-expressed at it.
    Stage 2: the preintegration identities, INVERSE-parametrized with
    lam = 1/s, v' = lam v, g' = lam g:
        dp_vis_i = v'_i dt + 1/2 g' dt^2 + lam Rwb_i dP_i
        0        = v'_i - v'_{i+1} + g' dt + lam Rwb_i dV_i
    are linear in x = [lam, g', v'_0..v'_N]. This puts the NOISY visual
    relative positions on the RHS (observation noise only) instead of in
    the scale regressor column: the direct s-parametrization is an
    errors-in-variables problem whose pose noise attenuates s toward zero
    (measured by tools/exp_imu_spacing.py: 5e-4 pose noise drags s=5
    to 0.35 at 33 ms keyframe spacing). Solve LS, then re-solve with the
    gravity norm constrained via g' = G(lam ghat0 + B w) — |g'| = lam G to
    first order with B the tangent basis at ghat0 — which stays LINEAR in
    (lam, w). Accel bias is left at zero like the reference's high-priorA
    first call (LocalMapping.cc:188: priorA=1e10 pins ba ~ 0; it only
    becomes observable with longer excursions).

    Returns Rwg with columns forming a world frame whose +z opposes
    gravity: p_new = s * Rwg^T p_old maps the map into the
    gravity-aligned metric frame (the ScaleRefinement payload)."""
    n = len(Rwb)
    if n < 3 or len(preints) != n - 1:
        return ImuInitResult(ok=False)
    bg = estimate_gyro_bias(Rwb, preints)
    bias = ImuBias(bg=bg)
    dRs = [p.delta_rotation(bias) for p in preints]
    dVs = [p.delta_velocity(bias) for p in preints]
    dPs = [p.delta_position(bias) for p in preints]
    dts = [p.dT for p in preints]

    def solve(ghat0: np.ndarray | None):
        """Inverse-parametrized LS over x = [lam?, gpar, v'0..v'N].

        ghat0 None -> free-gravity stage: gpar = g' (3 dof). Otherwise the
        constrained stage: gpar = w (2 dof) with
        g' = GRAVITY * (lam * ghat0 + B w), B the tangent basis at ghat0
        (|g'| = lam*GRAVITY to first order, linear in lam and w).
        Non-monocular runs pin lam = 1 (metric visual gauge)."""
        if ghat0 is None:
            ng = 3
            B = None
        else:
            a = (np.array([1.0, 0, 0]) if abs(ghat0[0]) < 0.9
                 else np.array([0, 1.0, 0]))
            b1 = np.cross(ghat0, a)
            b1 /= np.linalg.norm(b1)
            b2 = np.cross(ghat0, b1)
            B = np.stack([b1, b2], 1)
            ng = 2
        ns = 1 if monocular else 0
        nx = ns + ng + 3 * n
        A_rows, b_rows = [], []
        for i in range(n - 1):
            dt = dts[i]
            if dt <= 0:
                continue
            # lam coefficient: the IMU delta rotated to world, plus (in the
            # constrained stage) the gravity-direction part G*ghat0*lam.
            lam_p = Rwb[i] @ dPs[i]
            lam_v = Rwb[i] @ dVs[i]
            if ghat0 is not None:
                lam_p = lam_p + 0.5 * dt * dt * GRAVITY * ghat0
                lam_v = lam_v + dt * GRAVITY * ghat0
            # position identity row block (3 eqs):
            #   lam*(R dP [+ .5dt^2 G ghat0]) + .5dt^2 * gpar_term
            #   + dt v'_i = dp_vis
            row = np.zeros((3, nx))
            if monocular:
                row[:, 0] = lam_p
            gcol = (np.eye(3) if B is None else GRAVITY * B)
            row[:, ns:ns + ng] = 0.5 * dt * dt * gcol
            row[:, ns + ng + 3 * i:ns + ng + 3 * i + 3] = dt * np.eye(3)
            rhs = pwb[i + 1] - pwb[i]
            if not monocular:
                rhs = rhs - lam_p
            A_rows.append(row)
            b_rows.append(rhs)
            # velocity identity row block (3 eqs):
            #   lam*(R dV [+ dt G ghat0]) + dt*gpar_term + v'_i - v'_{i+1} = 0
            row = np.zeros((3, nx))
            if monocular:
                row[:, 0] = lam_v
            row[:, ns:ns + ng] = dt * gcol
            row[:, ns + ng + 3 * i:ns + ng + 3 * i + 3] = np.eye(3)
            row[:, ns + ng + 3 * (i + 1):ns + ng + 3 * (i + 1) + 3] = \
                -np.eye(3)
            A_rows.append(row)
            b_rows.append(np.zeros(3) if monocular else -lam_v)
        A = np.concatenate(A_rows, 0)
        rhs = np.concatenate(b_rows, 0)
        x, *_ = np.linalg.lstsq(A, rhs, rcond=None)
        resid = float(np.linalg.norm(A @ x - rhs) / max(1, len(rhs)))
        lam = float(x[0]) if monocular else 1.0
        if ghat0 is None:
            gp = x[ns:ns + 3]                       # g' = lam * g
        else:
            gp = GRAVITY * (lam * ghat0 + B @ x[ns:ns + ng])
        vp = x[ns + ng:].reshape(n, 3)              # v' = lam * v
        return lam, gp, vp, resid

    # Free-gravity solve (gravity direction), then constrained refinement
    # with |g| = GRAVITY enforced through the lam-scaled tangent form.
    lam, gp, vp, resid = solve(None)
    for _ in range(2):
        gn = np.linalg.norm(gp)
        if gn < _EPS or not np.isfinite(gn):
            return ImuInitResult(ok=False)
        lam, gp, vp, resid = solve(gp / gn)

    if lam <= 1e-2 or not np.isfinite(lam):
        return ImuInitResult(ok=False)
    s = 1.0 / lam
    g = gp / np.linalg.norm(gp) * GRAVITY
    v = s * vp
    if monocular and s < 1e-1:        # LocalMapping.cc:1287 "scale too small"
        return ImuInitResult(ok=False)

    # Gravity-aligning rotation: Rwg rotates the canonical gravity
    # gI = (0,0,-G) onto the estimated g (LocalMapping.cc:1259-1267).
    gI = np.array([0.0, 0.0, -1.0])
    ghat = g / np.linalg.norm(g)
    vx = np.cross(gI, ghat)
    nv = np.linalg.norm(vx)
    cosg = float(np.dot(gI, ghat))
    if nv < 1e-8:
        Rwg = np.eye(3) if cosg > 0 else so3_exp(np.array([np.pi, 0, 0]))
    else:
        Rwg = so3_exp(vx / nv * np.arccos(max(-1.0, min(1.0, cosg))))
    return ImuInitResult(ok=True, scale=s, Rwg=Rwg, gravity_w=g,
                         velocities=v, bias=bias, residual=resid)
