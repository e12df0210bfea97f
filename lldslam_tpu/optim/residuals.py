"""Reprojection residuals + analytic Jacobians for points and lines, batched.

Replaces g2o's edge types (reference Thirdparty/g2o/g2o/types/):
- `EdgeSE3ProjectXYZ` / `EdgeStereoSE3ProjectXYZ` (types_six_dof_expmap.cpp):
  mono (u, v) and stereo (uL, v, uR) point reprojection with analytic
  Jacobians w.r.t. the camera's se3 tangent (left-multiplicative) and the
  world point.
- `EdgeSE3ProjectLine` (types_six_dof_expmap.h:299-385): 2-vector
  endpoint-to-projected-infinite-line residual; Jacobians by `jax.jacfwd`
  against the same closed forms the reference hand-derives
  (types_six_dof_expmap.cpp:472-581).

Conventions: residual r = observation - prediction (g2o's sign); the camera
tangent is ordered (upsilon, omega) and applied as exp(xi) * T_cw.

Chi-square thresholds (Optimizer.cc:700-712,836-848):
mono 5.991 (2 dof), stereo 7.815 (3 dof); Huber delta = sqrt(threshold).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geometry import se3, lines as glines
from ..geometry.camera import StereoCamera

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def point_residual_stereo(cam: StereoCamera, T_cw: jnp.ndarray, X: jnp.ndarray, obs: jnp.ndarray):
    """obs (..., 3) = (uL, v, uR). Returns residual (..., 3)."""
    Xc = se3.apply(T_cw, X)
    z = jnp.where(jnp.abs(Xc[..., 2]) < 1e-9, 1e-9, Xc[..., 2])
    pred = jnp.stack(
        [
            cam.fx * Xc[..., 0] / z + cam.cx,
            cam.fy * Xc[..., 1] / z + cam.cy,
            cam.fx * Xc[..., 0] / z + cam.cx - cam.bf / z,
        ],
        axis=-1,
    )
    return obs - pred


def point_jacobians_stereo(cam: StereoCamera, T_cw: jnp.ndarray, X: jnp.ndarray):
    """Analytic Jacobians of the stereo residual.

    Returns (J_pose (..., 3, 6), J_point (..., 3, 3), Xc (..., 3)).
    J_pose columns ordered (upsilon, omega); J_point w.r.t. world point.
    (Closed forms as in types_six_dof_expmap.cpp EdgeStereoSE3ProjectXYZ::
    linearizeOplus, re-derived for left-multiplicative tangent.)
    """
    R = T_cw[..., :3, :3]
    Xc = se3.apply(T_cw, X)
    x, y = Xc[..., 0], Xc[..., 1]
    z = jnp.where(jnp.abs(Xc[..., 2]) < 1e-9, 1e-9, Xc[..., 2])
    iz = 1.0 / z
    iz2 = iz * iz
    fx, fy, bf = cam.fx, cam.fy, cam.bf
    zero = jnp.zeros_like(x)
    # d proj / d Xc, shape (..., 3, 3)
    dproj = jnp.stack(
        [
            jnp.stack([fx * iz, zero, -fx * x * iz2], axis=-1),
            jnp.stack([zero, fy * iz, -fy * y * iz2], axis=-1),
            jnp.stack([fx * iz, zero, -fx * x * iz2 + bf * iz2], axis=-1),
        ],
        axis=-2,
    )
    # d Xc / d xi = [I | -hat(Xc)] (left-multiplicative increment), expanded
    # in closed form: J_pose = [-dproj | dproj @ hat(Xc)], and row i of
    # A @ hat(v) is a_i x v — elementwise ops instead of a huge batch of
    # 3x3 @ 3x6 matmuls (tiny batched dots make poor matrix-unit work).
    Jw = jnp.cross(dproj, Xc[..., None, :])
    J_pose = jnp.concatenate([-dproj, Jw], axis=-1)
    J_point = -(dproj @ R)
    return J_pose, J_point, Xc


def line_residual(cam: StereoCamera, T_cw, q, alpha, x1, x2):
    """Line endpoint residual (..., 2) for the minimal (q, alpha) line state
    (types_six_dof_expmap.h:344-375 error)."""
    X0, d = glines.x0dir_from_minimal(q, alpha)
    return glines.endpoint_residual(cam, T_cw, X0, d, x1, x2)


def line_jacobians(cam: StereoCamera, T_cw, q, alpha, x1, x2):
    """Jacobians of the 2-vector line residual w.r.t. the camera tangent
    (..., 2, 6) and the 4-DoF line tangent (..., 2, 4) (3 rotation increments
    on q + 1 alpha), via forward-mode autodiff around zero increments
    (validated against types_six_dof_expmap.cpp:472-581 closed forms)."""
    def res(eps_pose, eps_line):
        T = se3.exp(eps_pose) @ T_cw
        dq = _quat_increment(eps_line[..., :3])
        q2 = _quat_mul(dq, q)
        a2 = alpha + eps_line[..., 3]
        return line_residual(cam, T, q2, a2, x1, x2)

    z6 = jnp.zeros(T_cw.shape[:-2] + (6,), T_cw.dtype)
    z4 = jnp.zeros(q.shape[:-1] + (4,), q.dtype)
    Jp = jax.jacfwd(lambda e: res(e, z4))(z6)
    Jl = jax.jacfwd(lambda e: res(z6, e))(z4)
    return Jp, Jl


def _quat_increment(w):
    """Small-rotation quaternion [cos(|w|/2), sin(|w|/2) w/|w|] ~ [1, w/2]
    (VertexSBALine::oplusImpl uses the normalized [1, w/2] form,
    types_sba.h:97-108)."""
    one = jnp.ones_like(w[..., :1])
    q = jnp.concatenate([one, 0.5 * w], axis=-1)
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def _quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def huber_weight(chi2: jnp.ndarray, delta_sq: float) -> jnp.ndarray:
    """IRLS weight of the Huber kernel: 1 inside, delta/|e| outside
    (g2o RobustKernelHuber semantics)."""
    return jnp.where(chi2 <= delta_sq, 1.0, jnp.sqrt(delta_sq / jnp.maximum(chi2, 1e-12)))


def huber_rho(chi2: jnp.ndarray, delta_sq) -> jnp.ndarray:
    """Huber robust cost rho(chi2): quadratic inside delta, linear in |e|
    outside (g2o RobustKernelHuber::robustify). Monotone and non-saturating —
    required for LM accept/reject to see progress at large residuals (a
    clamped cost is flat there and stalls the solver)."""
    return jnp.where(
        chi2 <= delta_sq,
        chi2,
        2.0 * jnp.sqrt(delta_sq * jnp.maximum(chi2, 0.0)) - delta_sq,
    )
