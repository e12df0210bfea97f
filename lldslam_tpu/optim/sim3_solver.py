"""Sim(3) relative pose: batched Horn closed form + all-hypotheses RANSAC.

Replaces `Sim3Solver` (reference src/Sim3Solver.cc): Horn 1987 absolute
orientation (centroids, M = Pr1 Pr2^T, 4x4 N-matrix top eigenvector ->
quaternion, Sim3Solver.cc:226-308) inside RANSAC over 3-point minimal sets
(:130-207). The reference iterates sequentially with adaptive termination;
here every hypothesis is solved and scored in one batched program
(vmap over hypotheses, one (H, N) reprojection pass), then argmax —
the SURVEY.md §7 "sample all hypotheses in parallel" pattern.

Scale is fixed to 1 for stereo (`bFixScale`, LoopClosing.cc:276).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..geometry.camera import StereoCamera


def horn_sim3(P1: jnp.ndarray, P2: jnp.ndarray, fix_scale: bool = True):
    """Closed-form S12 = (R, t, s) aligning P2 -> P1 (both (N, 3), N >= 3).

    Horn's quaternion method (Sim3Solver::ComputeSim3, Sim3Solver.cc:226-308).
    """
    c1 = P1.mean(axis=-2)
    c2 = P2.mean(axis=-2)
    Pr1 = P1 - c1[..., None, :]
    Pr2 = P2 - c2[..., None, :]
    # M = sum Pr2 Pr1^T (Sim3Solver.cc:238: P2 * P1.t()): with the N-matrix
    # below this yields R s.t. X1 = R X2; the Pr1 Pr2^T transpose yields R^T
    # (caught by a real-rotation EPnP test; earlier tests used identity
    # rotations via a tangent-ordering mixup and missed it)
    M = jnp.einsum("...ni,...nj->...ij", Pr2, Pr1)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = jnp.stack([
        jnp.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        jnp.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        jnp.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        jnp.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)
    _, vecs = jnp.linalg.eigh(N)
    q = vecs[..., -1]  # top eigenvector: (w, x, y, z)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    P3 = jnp.einsum("...ij,...nj->...ni", R, Pr2)
    if fix_scale:
        s = jnp.ones(P1.shape[:-2], P1.dtype)
    else:
        # s = <Pr1, R Pr2> / ||R Pr2||^2 (Sim3Solver.cc:292-303)
        num = jnp.sum(Pr1 * P3, axis=(-2, -1))
        den = jnp.sum(P3 * P3, axis=(-2, -1))
        s = num / jnp.maximum(den, 1e-12)
    t = c1 - s[..., None] * jnp.einsum("...ij,...j->...i", R, c2)
    return R, t, s


def _project(cam: StereoCamera, X: jnp.ndarray) -> jnp.ndarray:
    z = jnp.maximum(X[..., 2], 1e-6)
    u = cam.fx * X[..., 0] / z + cam.cx
    v = cam.fy * X[..., 1] / z + cam.cy
    return jnp.stack([u, v], -1)


@partial(jax.jit, static_argnames=("cam1", "cam2", "fix_scale", "n_hyp"))
def ransac_sim3(
    cam1: StereoCamera,
    cam2: StereoCamera,
    P1: jnp.ndarray,        # (N, 3) matched points in KF1 camera coords
    P2: jnp.ndarray,        # (N, 3) matched points in KF2 camera coords
    uv1: jnp.ndarray,       # (N, 2) observed pixels in KF1
    uv2: jnp.ndarray,       # (N, 2) observed pixels in KF2
    sigma2_1: jnp.ndarray,  # (N,) per-match sigma^2 (octave scale)
    sigma2_2: jnp.ndarray,
    valid: jnp.ndarray,     # (N,) bool
    key: jax.Array,
    fix_scale: bool = True,
    n_hyp: int = 256,
):
    """All-hypotheses Sim3 RANSAC. Returns ((R, t, s) best S12, inlier mask,
    n_inliers). Inlier check mirrors Sim3Solver::CheckInliers
    (Sim3Solver.cc:310-336): bidirectional reprojection with chi2 9.210."""
    N = P1.shape[0]
    # 3 distinct indices per hypothesis among valid entries
    p = valid.astype(jnp.float32)
    p = p / jnp.maximum(p.sum(), 1.0)
    idx = jax.random.choice(key, N, shape=(n_hyp, 3), replace=True, p=p)
    R, t, s = horn_sim3(P1[idx], P2[idx], fix_scale=fix_scale)  # (H, ...)

    # score: project P2 through S12 into cam1 and P1 through S21 into cam2
    X1 = s[:, None, None] * jnp.einsum("hij,nj->hni", R, P2) + t[:, None, :]
    err1 = jnp.sum((_project(cam1, X1) - uv1[None]) ** 2, -1) / sigma2_1[None]
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    X2 = s_inv[:, None, None] * jnp.einsum(
        "hij,hnj->hni", Rt, P1[None] - t[:, None, :])
    err2 = jnp.sum((_project(cam2, X2) - uv2[None]) ** 2, -1) / sigma2_2[None]
    inl = (err1 < 9.210) & (err2 < 9.210) & valid[None]
    scores = inl.sum(-1)
    best = jnp.argmax(scores)
    return (R[best], t[best], s[best]), inl[best], scores[best]


@partial(jax.jit, static_argnames=("cam1", "cam2", "fix_scale", "iters"))
def refine_sim3(
    cam1: StereoCamera,
    cam2: StereoCamera,
    S12,                    # (R, t, s) initial relative Sim3
    P1: jnp.ndarray,        # (N, 3) points in KF1 camera frame
    P2: jnp.ndarray,        # (N, 3) points in KF2 camera frame
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    inv_sigma2_1: jnp.ndarray,
    inv_sigma2_2: jnp.ndarray,
    valid: jnp.ndarray,
    fix_scale: bool = True,
    iters: int = 10,
):
    """Bidirectional Sim3 projection refinement (Optimizer::OptimizeSim3,
    reference src/Optimizer.cc:1656-1858): Huber GN on the 7-dof (6 when
    scale fixed) relative transform with both-direction reprojection edges,
    chi2 9.210 inlier reclassification. Returns ((R, t, s), inliers, n)."""
    from ..geometry import sim3 as gs

    R0, t0, s0 = S12
    delta2 = 9.210  # chi2(2) at 99% x ... (Optimizer.cc:1707 deltaHuber^2)

    def residuals(R, t, sc):
        X1p = sc * (P2 @ R.T) + t
        e1 = (_project(cam1, X1p) - uv1) * jnp.sqrt(inv_sigma2_1)[:, None]
        Rt_ = R.T
        X2p = (1.0 / sc) * ((P1 - t) @ Rt_.T)
        e2 = (_project(cam2, X2p) - uv2) * jnp.sqrt(inv_sigma2_2)[:, None]
        return e1, e2

    def step(_, state):
        R, t, sc, w = state

        def res_vec(eps):
            dR, dt, ds = gs.exp(eps)
            Rn, tn, sn = gs.compose((dR, dt, ds), (R, t, sc))
            e1, e2 = residuals(Rn, tn, sn)
            return jnp.concatenate([e1, e2], 0).reshape(-1)

        z = jnp.zeros(7)
        r = res_vec(z)
        J = jax.jacfwd(res_vec)(z)
        if fix_scale:
            J = J.at[:, 6].set(0.0)
        chi2 = (r.reshape(-1, 2) ** 2).sum(-1)
        hub = jnp.sqrt(jnp.minimum(1.0, delta2 / jnp.maximum(chi2, 1e-12)))
        ww = (w * hub).repeat(2)
        H = (J * ww[:, None]).T @ (J * ww[:, None]) + 1e-6 * jnp.eye(7)
        g = -(J * ww[:, None]).T @ (r * ww)
        dx = jnp.linalg.solve(H, g)
        dR, dt, ds = gs.exp(dx)
        Rn, tn, sn = gs.compose((dR, dt, ds), (R, t, sc))
        return (Rn, tn, sn, w)

    w0 = jnp.concatenate([valid, valid]).astype(jnp.float32)
    R, t, sc, _ = jax.lax.fori_loop(0, iters, step, (R0, t0, s0, w0))
    e1, e2 = residuals(R, t, sc)
    c1 = (e1 ** 2).sum(-1)
    c2 = (e2 ** 2).sum(-1)
    inl = valid & (c1 < delta2) & (c2 < delta2)
    return (R, t, sc), inl, inl.sum()
