"""Bundle adjustment: batched Gauss-Newton/LM with Schur-complement point
(and line) marginalization — the batched device replacement for g2o's
BlockSolver + OptimizationAlgorithmLevenberg driving
`Optimizer::LocalBundleAdjustment` (reference src/Optimizer.cc:936-1388) and
`Optimizer::BundleAdjustment` (global, src/Optimizer.cc:321-560).

Two solve paths over the same residual/Jacobian machinery:

1. `solve_dense` — dense-block Schur: eliminate landmarks, build the reduced
   camera system S (6K x 6K) explicitly via one big matrix product over a
   (K, P, 6, 3) coupling tensor, Cholesky-solve. Right-sized for local BA
   windows (K <= ~32, P <= ~16k), mirroring the covisible-KF window + fixed
   frontier of the reference (Optimizer.cc:988-1018).

2. `solve_cg` — matrix-free Schur: preconditioned conjugate gradients on the
   reduced system, with S@v evaluated as two observation-level scatter/gather
   passes (O(observations) per matvec, no K*P tensor). This is the scalable
   global-BA path; every op is a segment-sum over the observation table, which
   shards over a device mesh with a single `psum` (SURVEY.md §5.7 plan).

Fixed-capacity convention: all arrays are padded; `*_valid` masks gate
contributions. Invalid observations contribute exactly zero to every system.

Landmark classes: 3-DoF points; 4-DoF minimal lines (quaternion increment +
alpha, types_sba.h:62-110) enter through the same Schur machinery with 4x4
landmark blocks (see lines_ba.py).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import se3
from ..geometry.camera import StereoCamera
from . import residuals as res


class BAObs(NamedTuple):
    """Padded point-observation table."""

    k: jnp.ndarray           # (O,) int32 keyframe index
    p: jnp.ndarray           # (O,) int32 point index
    uvr: jnp.ndarray         # (O, 3)
    inv_sigma2: jnp.ndarray  # (O,)
    is_stereo: jnp.ndarray   # (O,) bool
    valid: jnp.ndarray       # (O,) bool


class BAProblem(NamedTuple):
    poses: jnp.ndarray       # (K, 4, 4) T_cw
    points: jnp.ndarray      # (P, 3)
    pose_fixed: jnp.ndarray  # (K,) bool — fixed frontier + gauge
    point_valid: jnp.ndarray  # (P,) bool
    obs: BAObs


def _terms(cam: StereoCamera, problem: BAProblem, robust: bool, delta_scale=1.0):
    """Per-observation residuals, Jacobians and IRLS weights.

    Returns r (O,3), Jc (O,3,6), Jp (O,3,3), W (O,3) row weights, chi2 (O,).
    `delta_scale` scales the squared Huber delta (graduated non-convexity).
    """
    o = problem.obs
    T = problem.poses[o.k]
    X = problem.points[o.p]
    r = res.point_residual_stereo(cam, T, X, o.uvr)
    Jc, Jp, Xc = res.point_jacobians_stereo(cam, T, X)
    row_w = jnp.where(o.is_stereo[:, None], 1.0, jnp.array([1.0, 1.0, 0.0])[None, :])
    chi2_raw = o.inv_sigma2 * jnp.sum(r * r * row_w, axis=-1)
    active = (
        o.valid
        & problem.point_valid[o.p]
        # behind/near-camera guard (Optimizer.cc depth checks). Margin matters:
        # at z -> 0 the Jacobians blow up and inf * 0-weight = NaN would
        # poison the scattered normal equations.
        & (Xc[..., 2] > 0.05)
        # unrecoverable-outlier guard: >1000-sigma-px observations carry no
        # usable signal, but their 1/z^2-scaled Jacobian blocks are large
        # enough (1e13) to make the f32 Schur complement indefinite. They may
        # re-enter once the state improves (mask is recomputed per iteration).
        & (chi2_raw < 1e6)
    ).astype(r.dtype)
    r = r * active[:, None]
    Jc = Jc * active[:, None, None]
    Jp = Jp * active[:, None, None]
    chi2 = o.inv_sigma2 * jnp.sum(r * r * row_w, axis=-1)
    delta_sq = jnp.where(o.is_stereo, res.CHI2_STEREO, res.CHI2_MONO) * delta_scale
    hub = res.huber_weight(chi2, delta_sq) if robust else 1.0
    w = o.inv_sigma2 * hub * active
    W = w[:, None] * row_w
    return r, Jc, Jp, W, chi2, active


def _build_blocks(problem: BAProblem, r, Jc, Jp, W):
    """Scatter observation terms into per-pose / per-point normal blocks."""
    K = problem.poses.shape[0]
    P = problem.points.shape[0]
    o = problem.obs
    JcW = Jc * W[:, :, None]                       # (O, 3, 6)
    Hcc = jnp.zeros((K, 6, 6)).at[o.k].add(jnp.einsum("ori,orj->oij", JcW, Jc))
    bc = jnp.zeros((K, 6)).at[o.k].add(-jnp.einsum("ori,or->oi", JcW, r))  # -J^T W r
    JpW = Jp * W[:, :, None]                       # (O, 3, 3)
    Hpp = jnp.zeros((P, 3, 3)).at[o.p].add(jnp.einsum("ori,orj->oij", JpW, Jp))
    bp = jnp.zeros((P, 3)).at[o.p].add(-jnp.einsum("ori,or->oi", JpW, r))  # -J^T W r
    Wcp = jnp.einsum("ori,orj->oij", JcW, Jp)      # (O, 6, 3) per-obs coupling
    return Hcc, bc, Hpp, bp, Wcp


def _inv3x3(A):
    """Closed-form batched 3x3 inverse (adjugate / det) — pure elementwise
    ops, one fused kernel, where `jnp.linalg.inv` on a (P, 3, 3) batch runs
    a batched LU. Inputs are damped SPD blocks (identity-guarded when
    unobserved), so det > 0."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    idet = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    row0 = jnp.stack([c00, c01, c02], axis=-1)
    row1 = jnp.stack([c10, c11, c12], axis=-1)
    row2 = jnp.stack([c20, c21, c22], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2) * idet[..., None, None]


def _damp_diag(H, lam):
    """H + lam*diag(H) + eps I, batched."""
    n = H.shape[-1]
    I = jnp.eye(n, dtype=H.dtype)
    d = jnp.diagonal(H, axis1=-2, axis2=-1)
    return H + (lam * d + 1e-8)[..., None] * I


def _fix_gauge(S, b, fixed):
    """Zero out rows/cols of fixed poses in the reduced system; unit diagonal."""
    K = fixed.shape[0]
    free = (~fixed).astype(S.dtype)
    S = S * free[:, None, None, None] * free[None, None, :, None]
    b = b * free[:, None]
    # unit diagonal on fixed blocks keeps the system nonsingular
    eye6 = jnp.eye(6, dtype=S.dtype)
    eyeK = jnp.eye(K, dtype=S.dtype)
    S = S + (
        fixed.astype(S.dtype)[:, None, None, None]
        * eyeK[:, None, :, None]
        * eye6[None, :, None, :]
    )
    return S, b


def _schur_dense(problem: BAProblem, Hcc, bc, Hpp, bp, Wcp, lam):
    """Explicit reduced camera system via the (K, P, 6, 3) coupling tensor."""
    K = problem.poses.shape[0]
    P = problem.points.shape[0]
    o = problem.obs
    Hpp_d = _damp_diag(Hpp, lam)
    # guard: points with no observations get identity blocks
    seen = jnp.zeros((P,)).at[o.p].add(jnp.abs(Wcp).sum(axis=(1, 2))) > 0
    Hpp_d = jnp.where(
        seen[:, None, None], Hpp_d, jnp.eye(3, dtype=Hpp.dtype)[None]
    )
    Hpp_inv = _inv3x3(Hpp_d)
    B = jnp.zeros((K, P, 6, 3)).at[o.k, o.p].add(Wcp)  # dense coupling
    BHinv = jnp.einsum("kpij,pjl->kpil", B, Hpp_inv)
    S = jnp.einsum("kpil,qpjl->kiqj", BHinv, B)        # (K,6,K,6)
    Hcc_d = _damp_diag(Hcc, lam)
    S = jnp.einsum("kij,kq->kiqj", Hcc_d, jnp.eye(K, dtype=Hcc.dtype)) - S
    rhs = bc - jnp.einsum("kpil,pl->ki", BHinv, bp)
    S, rhs = _fix_gauge(S, rhs, problem.pose_fixed)
    # Symmetric Jacobi scaling + Cholesky: the raw reduced system mixes
    # rotation/translation scales (entries ~ (fx*depth)^2 vs fx^2, cond 1e6+)
    # which an unscaled f32 factorization resolves poorly. Scaling brings
    # the diagonal to 1.
    Sm = S.reshape(6 * K, 6 * K)
    Sm = 0.5 * (Sm + Sm.T)  # f32 scatter/matmul rounding leaves slight asymmetry
    d = jnp.diagonal(Sm)
    dsi = 1.0 / jnp.sqrt(jnp.maximum(jnp.abs(d), 1e-12))
    Ss = Sm * dsi[:, None] * dsi[None, :] + 1e-6 * jnp.eye(6 * K, dtype=Sm.dtype)
    y = jnp.linalg.solve(Ss, rhs.reshape(6 * K) * dsi)
    dc = (y * dsi).reshape(K, 6)
    # back-substitute landmarks
    dp = jnp.einsum(
        "pij,pj->pi", Hpp_inv, bp - jnp.einsum("kpij,ki->pj", B, dc)
    )
    dp = dp * problem.point_valid[:, None]
    return dc, dp


def _schur_cg(problem: BAProblem, Hcc, bc, Hpp, bp, Wcp, lam, cg_iters: int):
    """Matrix-free reduced-system CG: S@v via observation-level passes."""
    o = problem.obs
    K = problem.poses.shape[0]
    P = problem.points.shape[0]
    free = (~problem.pose_fixed).astype(bc.dtype)
    Hpp_d = _damp_diag(Hpp, lam)
    seen = jnp.zeros((P,)).at[o.p].add(jnp.abs(Wcp).sum(axis=(1, 2))) > 0
    Hpp_d = jnp.where(seen[:, None, None], Hpp_d, jnp.eye(3, dtype=Hpp.dtype)[None])
    Hpp_inv = _inv3x3(Hpp_d)
    Hcc_d = _damp_diag(Hcc, lam)

    def S_matvec(v):  # v (K, 6)
        v = v * free[:, None]
        y = jnp.einsum("kij,kj->ki", Hcc_d, v)
        # coupling: z_p = sum_o W_o^T v[k(o)]
        z = jnp.zeros((P, 3)).at[o.p].add(jnp.einsum("oij,oi->oj", Wcp, v[o.k]))
        z = jnp.einsum("pij,pj->pi", Hpp_inv, z)
        y2 = jnp.zeros((K, 6)).at[o.k].add(jnp.einsum("oij,oj->oi", Wcp, z[o.p]))
        return (y - y2) * free[:, None]

    rhs = (bc - jnp.zeros((K, 6)).at[o.k].add(
        jnp.einsum("oij,oj->oi", Wcp, jnp.einsum("pij,pj->pi", Hpp_inv, bp)[o.p])
    )) * free[:, None]

    # Block-Jacobi preconditioner, computed on Jacobi-scaled blocks so the
    # 6x6 inversions stay well-conditioned in f32 (see _schur_dense note).
    db = jnp.sqrt(jnp.maximum(jnp.diagonal(Hcc_d, axis1=-2, axis2=-1), 1e-12))
    Hcc_s = Hcc_d / (db[:, :, None] * db[:, None, :])
    Minv_s = jnp.linalg.inv(Hcc_s + jnp.eye(6, dtype=bc.dtype) * 1e-6)
    Minv = Minv_s / (db[:, :, None] * db[:, None, :])

    def precond(r):
        return jnp.einsum("kij,kj->ki", Minv, r) * free[:, None]

    def cg_body(_, state):
        x, r, z, pdir, rz = state
        Ap = S_matvec(pdir)
        denom = jnp.sum(pdir * Ap)
        alpha = rz / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
        x = x + alpha * pdir
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.where(jnp.abs(rz) < 1e-12, 1e-12, rz)
        pdir = z + beta * pdir
        return (x, r, z, pdir, rz_new)

    x0 = jnp.zeros_like(rhs)
    r0 = rhs
    z0 = precond(r0)
    state = (x0, r0, z0, z0, jnp.sum(r0 * z0))
    dc, *_ = jax.lax.fori_loop(0, cg_iters, cg_body, state)
    # back-substitute
    z = jnp.zeros((P, 3)).at[o.p].add(jnp.einsum("oij,oi->oj", Wcp, dc[o.k]))
    dp = jnp.einsum("pij,pj->pi", Hpp_inv, bp - z)
    dp = dp * problem.point_valid[:, None]
    return dc, dp


def _densify_obs(problem: BAProblem):
    """Scatter the (O,) observation table into dense (K, P) grids — once,
    before the LM loop. Each (keyframe, point) pair has at most one
    observation, so the table is exactly a sparse (K, P) incidence matrix;
    the dense grid turns every per-iteration scatter-add (~6 scatters per
    LM iteration) into plain einsum reductions (kept until local BA is
    measured per LM iteration on the GPU, ROADMAP Speed).

    Invalid rows are routed out of bounds and dropped."""
    K = problem.poses.shape[0]
    P = problem.points.shape[0]
    o = problem.obs
    v = o.valid
    k = jnp.where(v, o.k, K)  # OOB when invalid -> dropped
    p = jnp.where(v, o.p, P)
    uvr_g = jnp.zeros((K, P, 3)).at[k, p].set(o.uvr, mode="drop")
    w_g = jnp.zeros((K, P)).at[k, p].set(o.inv_sigma2, mode="drop")
    st_g = jnp.zeros((K, P), bool).at[k, p].set(o.is_stereo, mode="drop")
    val_g = jnp.zeros((K, P), bool).at[k, p].set(True, mode="drop")
    return uvr_g, w_g, st_g, val_g


def _terms_grid(cam, poses, points, point_valid, uvr_g, w_g, st_g, val_g,
                robust, dscale):
    """Grid-shaped `_terms`: residuals/Jacobians/IRLS weights over the dense
    (K, P) observation grid. Same math and guards as `_terms`."""
    T = poses[:, None]        # (K, 1, 4, 4)
    X = points[None]          # (1, P, 3)
    r = res.point_residual_stereo(cam, T, X, uvr_g)         # (K, P, 3)
    Jc, Jp, Xc = res.point_jacobians_stereo(cam, T, X)      # (K,P,3,6/3)
    row_w = jnp.where(st_g[..., None], 1.0,
                      jnp.array([1.0, 1.0, 0.0], r.dtype))
    chi2_raw = w_g * jnp.sum(r * r * row_w, axis=-1)
    active = (
        val_g
        & point_valid[None, :]
        & (Xc[..., 2] > 0.05)
        & (chi2_raw < 1e6)
    ).astype(r.dtype)
    r = r * active[..., None]
    Jc = Jc * active[..., None, None]
    Jp = Jp * active[..., None, None]
    chi2 = w_g * jnp.sum(r * r * row_w, axis=-1)
    delta_sq = jnp.where(st_g, res.CHI2_STEREO, res.CHI2_MONO) * dscale
    hub = res.huber_weight(chi2, delta_sq) if robust else 1.0
    w = w_g * hub * active
    W = w[..., None] * row_w                                # (K, P, 3)
    # current-state robust cost, folded into this pass (bit-identical to
    # _total_cost_grid on the same state: raw chi2, no 1e6 gate) — the LM
    # body otherwise pays a third full (K, P) residual pass per iteration
    # just to evaluate c_old
    act_cost = (val_g & point_valid[None, :] & (Xc[..., 2] > 0.05)) \
        .astype(r.dtype)
    rho = res.huber_rho(chi2_raw, delta_sq) if robust else chi2_raw
    cost = jnp.sum(rho * act_cost)
    return r, Jc, Jp, W, chi2, cost


def _build_blocks_grid(r, Jc, Jp, W):
    """Normal-equation blocks from grid terms — einsum reductions only."""
    JcW = Jc * W[..., None]                                  # (K, P, 3, 6)
    Hcc = jnp.einsum("kpri,kprj->kij", JcW, Jc)
    bc = -jnp.einsum("kpri,kpr->ki", JcW, r)
    JpW = Jp * W[..., None]
    Hpp = jnp.einsum("kpri,kprj->pij", JpW, Jp)
    bp = -jnp.einsum("kpri,kpr->pi", JpW, r)
    B = jnp.einsum("kpri,kprj->kpij", JcW, Jp)               # (K, P, 6, 3)
    return Hcc, bc, Hpp, bp, B


def _schur_solve_from_B(pose_fixed, point_valid, Hcc, bc, Hpp, bp, B, lam):
    """Reduced camera system from a dense coupling tensor B (K, P, 6, 3);
    the shared tail of `_schur_dense` (damping, gauge fix, Jacobi-scaled
    solve, landmark back-substitution)."""
    K = Hcc.shape[0]
    Hpp_d = _damp_diag(Hpp, lam)
    seen = jnp.abs(B).sum(axis=(0, 2, 3)) > 0
    Hpp_d = jnp.where(
        seen[:, None, None], Hpp_d, jnp.eye(3, dtype=Hpp.dtype)[None]
    )
    Hpp_inv = _inv3x3(Hpp_d)
    BHinv = jnp.einsum("kpij,pjl->kpil", B, Hpp_inv)
    S = jnp.einsum("kpil,qpjl->kiqj", BHinv, B)              # (K,6,K,6)
    Hcc_d = _damp_diag(Hcc, lam)
    S = jnp.einsum("kij,kq->kiqj", Hcc_d, jnp.eye(K, dtype=Hcc.dtype)) - S
    rhs = bc - jnp.einsum("kpil,pl->ki", BHinv, bp)
    S, rhs = _fix_gauge(S, rhs, pose_fixed)
    Sm = S.reshape(6 * K, 6 * K)
    Sm = 0.5 * (Sm + Sm.T)
    d = jnp.diagonal(Sm)
    dsi = 1.0 / jnp.sqrt(jnp.maximum(jnp.abs(d), 1e-12))
    Ss = Sm * dsi[:, None] * dsi[None, :] + 1e-6 * jnp.eye(6 * K, dtype=Sm.dtype)
    y = jnp.linalg.solve(Ss, rhs.reshape(6 * K) * dsi)
    dc = (y * dsi).reshape(K, 6)
    dp = jnp.einsum(
        "pij,pj->pi", Hpp_inv, bp - jnp.einsum("kpij,ki->pj", B, dc)
    )
    dp = dp * point_valid[:, None]
    return dc, dp


def _total_cost_grid(cam, poses, points, point_valid, uvr_g, w_g, st_g,
                     val_g, robust, dscale):
    T = poses[:, None]
    X = points[None]
    r = res.point_residual_stereo(cam, T, X, uvr_g)
    Xc = se3.apply(T, X)
    row_w = jnp.where(st_g[..., None], 1.0,
                      jnp.array([1.0, 1.0, 0.0], r.dtype))
    chi2 = w_g * jnp.sum(r * r * row_w, axis=-1)
    delta_sq = jnp.where(st_g, res.CHI2_STEREO, res.CHI2_MONO) * dscale
    active = (val_g & point_valid[None, :] & (Xc[..., 2] > 0.05)).astype(r.dtype)
    c = res.huber_rho(chi2, delta_sq) if robust else chi2
    return jnp.sum(c * active)


@partial(jax.jit, static_argnames=("cam", "iters", "robust", "gnc"))
def ba_solve_grid(
    cam: StereoCamera,
    problem: BAProblem,
    iters: int = 5,
    robust: bool = True,
    gnc: bool = True,
):
    """`ba_solve` (dense Schur path) on the dense (K, P) observation grid:
    same LM schedule, GNC, acceptance rule and final per-observation chi2 —
    but zero scatters inside the iteration loop (see `_densify_obs`)."""
    uvr_g, w_g, st_g, val_g = _densify_obs(problem)

    def body(i, state):
        poses, points, lam = state
        dscale = jnp.maximum(1.0, 64.0 * 0.5 ** i) if gnc else 1.0
        r, Jc, Jp, W, _, c_old = _terms_grid(
            cam, poses, points, problem.point_valid,
            uvr_g, w_g, st_g, val_g, robust, dscale)
        blocks = _build_blocks_grid(r, Jc, Jp, W)
        dc, dp = _schur_solve_from_B(
            problem.pose_fixed, problem.point_valid, *blocks, lam)
        free = (~problem.pose_fixed).astype(dc.dtype)
        poses_c = se3.exp(dc * free[:, None]) @ poses
        points_c = points + dp
        c_new = _total_cost_grid(cam, poses_c, points_c, problem.point_valid,
                                 uvr_g, w_g, st_g, val_g, robust, dscale)
        accept = c_new < c_old
        poses = jnp.where(accept, poses_c, poses)
        points = jnp.where(accept, points_c, points)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e4)
        return (poses, points, lam)

    poses, points, _ = jax.lax.fori_loop(
        0, iters, body,
        (problem.poses, problem.points,
         jnp.asarray(1e-4, problem.poses.dtype)))
    problem = problem._replace(poses=poses, points=points)
    # final chi2 per real observation (one sparse gather pass)
    o = problem.obs
    r = res.point_residual_stereo(cam, poses[o.k], points[o.p], o.uvr)
    row_w = jnp.where(o.is_stereo[:, None], 1.0,
                      jnp.array([1.0, 1.0, 0.0], r.dtype))
    chi2 = o.inv_sigma2 * jnp.sum(r * r * row_w, axis=-1)
    return problem, chi2


def _apply_update(problem: BAProblem, dc, dp):
    free = (~problem.pose_fixed).astype(dc.dtype)
    poses = se3.exp(dc * free[:, None]) @ problem.poses
    points = problem.points + dp
    return problem._replace(poses=poses, points=points)


def _total_cost(cam, problem: BAProblem, robust: bool, delta_scale=1.0):
    o = problem.obs
    r = res.point_residual_stereo(cam, problem.poses[o.k], problem.points[o.p], o.uvr)
    row_w = jnp.where(o.is_stereo[:, None], 1.0, jnp.array([1.0, 1.0, 0.0])[None, :])
    chi2 = o.inv_sigma2 * jnp.sum(r * r * row_w, axis=-1)
    delta_sq = jnp.where(o.is_stereo, res.CHI2_STEREO, res.CHI2_MONO) * delta_scale
    Xc = se3.apply(problem.poses[o.k], problem.points[o.p])
    active = (o.valid & problem.point_valid[o.p] & (Xc[..., 2] > 0.05)).astype(r.dtype)
    c = res.huber_rho(chi2, delta_sq) if robust else chi2
    return jnp.sum(c * active)


@partial(jax.jit, static_argnames=("cam", "iters", "dense", "cg_iters", "robust", "gnc"))
def ba_solve(
    cam: StereoCamera,
    problem: BAProblem,
    iters: int = 5,
    dense: bool = True,
    cg_iters: int = 24,
    robust: bool = True,
    gnc: bool = True,
):
    """Run `iters` LM iterations. Returns (problem', final chi2 per obs).

    `gnc`: graduated non-convexity — the Huber delta starts 8x inflated and
    halves each iteration down to nominal. Far from the basin a tight Huber
    IRLS underestimates curvature and the GN step overshoots (a cost-
    decreasing step can scramble poses); a near-quadratic start keeps the
    first steps Newton-accurate, and the final iterations run at the true
    delta so outlier classification is unchanged.
    """

    def body(i, state):
        problem, lam = state
        dscale = jnp.maximum(1.0, 64.0 * 0.5 ** i) if gnc else 1.0
        r, Jc, Jp, W, chi2, active = _terms(cam, problem, robust, dscale)
        blocks = _build_blocks(problem, r, Jc, Jp, W)
        if dense:
            dc, dp = _schur_dense(problem, *blocks, lam)
        else:
            dc, dp = _schur_cg(problem, *blocks, lam, cg_iters)
        cand = _apply_update(problem, dc, dp)
        c_old = _total_cost(cam, problem, robust, dscale)
        c_new = _total_cost(cam, cand, robust, dscale)
        accept = c_new < c_old
        problem = jax.tree.map(lambda a, b: jnp.where(accept, b, a), problem, cand)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e4)
        return (problem, lam)

    problem, _ = jax.lax.fori_loop(
        0, iters, body, (problem, jnp.asarray(1e-4, problem.poses.dtype))
    )
    # final chi2 for outlier classification
    o = problem.obs
    r = res.point_residual_stereo(cam, problem.poses[o.k], problem.points[o.p], o.uvr)
    row_w = jnp.where(o.is_stereo[:, None], 1.0, jnp.array([1.0, 1.0, 0.0])[None, :])
    chi2 = o.inv_sigma2 * jnp.sum(r * r * row_w, axis=-1)
    return problem, chi2


def classify_outliers(problem: BAProblem, chi2: jnp.ndarray, cam: StereoCamera):
    """Observation inlier mask: chi2 gate + positive depth
    (LocalBA outlier erasure, Optimizer.cc:1280-1296, 1336-1358)."""
    o = problem.obs
    th = jnp.where(o.is_stereo, res.CHI2_STEREO, res.CHI2_MONO)
    Xc = se3.apply(problem.poses[o.k], problem.points[o.p])
    return o.valid & (chi2 <= th) & (Xc[..., 2] > 0)


def local_ba(cam: StereoCamera, problem: BAProblem):
    """Reference LocalBundleAdjustment schedule: 5 iters, drop outliers,
    10 more iters, final outlier classification (Optimizer.cc:1223-1296).
    Runs on the dense (K, P) grid path (`ba_solve_grid`)."""
    problem, chi2 = ba_solve_grid(cam, problem, iters=5)
    keep = classify_outliers(problem, chi2, cam)
    problem = problem._replace(obs=problem.obs._replace(valid=keep))
    problem, chi2 = ba_solve_grid(cam, problem, iters=10)
    keep = classify_outliers(problem, chi2, cam)
    return problem, keep


@partial(jax.jit, static_argnames=("cam",))
def local_ba_packed(cam: StereoCamera, problem: BAProblem) -> jnp.ndarray:
    """local_ba with every host-bound result in ONE int32 buffer
    (poses bitcast | points bitcast | keep): one device->host transfer
    instead of three."""
    solved, keep = local_ba(cam, problem)
    bc = lambda a: jax.lax.bitcast_convert_type(a, jnp.int32)
    return jnp.concatenate([
        bc(solved.poses.reshape(-1)),
        bc(solved.points.reshape(-1)),
        keep.astype(jnp.int32),
    ])


def unpack_local_ba_np(buf: np.ndarray, K: int, P: int):
    """Inverse of local_ba_packed on host: (poses, points, keep)."""
    o = 16 * K
    poses = buf[:o].view(np.float32).reshape(K, 4, 4)
    points = buf[o:o + 3 * P].view(np.float32).reshape(P, 3)
    keep = buf[o + 3 * P:].astype(bool)
    return poses, points, keep
