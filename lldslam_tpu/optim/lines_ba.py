"""Joint point + line bundle adjustment with two-class Schur marginalization.

Replaces the line half of `Optimizer::LocalBundleAdjustment` /
`BundleAdjustment` (reference src/Optimizer.cc:1182-1218, 473-560 via
`LineOptimizer::AddLineMinimal`, src/LineOptimizer.cc:39-127): line landmarks
enter as marginalized 4-DoF vertices (quaternion-increment + alpha,
types_sba.h:62-110) with 2 endpoint-distance residual rows per camera and
2 cameras per stereo observation (baseline shift, LineOptimizer.cc:72-77),
information gamma^2 / 1.44^(2*octave) (LineOptimizer.cc:97-101).

The reduced camera system subtracts BOTH landmark classes:

    S = Hcc - Wcp Hpp^-1 Wcp^T - Wcl Hll^-1 Wcl^T     (4x4 line blocks)

and reuses the point machinery of optim/ba.py unchanged.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import lines as glines, se3
from ..geometry.camera import StereoCamera
from . import ba, residuals as res

LINE_PYR_FACTOR = 1.44  # LineMatching.cc:27


class LineBAObs(NamedTuple):
    """Padded line-observation table."""

    k: jnp.ndarray        # (O,) int32 keyframe index
    l: jnp.ndarray        # (O,) int32 line index
    x1l: jnp.ndarray      # (O, 2) observed left endpoints
    x2l: jnp.ndarray
    x1r: jnp.ndarray      # (O, 2) observed right endpoints
    x2r: jnp.ndarray
    octave: jnp.ndarray   # (O,) int32
    has_r: jnp.ndarray    # (O,) bool
    valid: jnp.ndarray    # (O,) bool


class JointProblem(NamedTuple):
    base: ba.BAProblem
    q: jnp.ndarray          # (L, 4) line orientation (wxyz)
    alpha: jnp.ndarray      # (L,)
    line_valid: jnp.ndarray  # (L,) bool
    lobs: LineBAObs


def _line_terms(cam: StereoCamera, problem: JointProblem, gamma: float,
                robust: bool, delta_scale=1.0):
    """Per line-observation: residual (O, 4), Jc (O, 4, 6), Jl (O, 4, 4),
    row weights (O, 4), chi2 (O,)."""
    o = problem.lobs
    T = problem.base.poses[o.k]
    T_r = glines.right_camera_pose(T, cam.baseline)
    q = problem.q[o.l]
    a = problem.alpha[o.l]

    def one(T, Tr, q, a, x1l, x2l, x1r, x2r):
        rl = res.line_residual(cam, T, q, a, x1l, x2l)
        rr = res.line_residual(cam, Tr, q, a, x1r, x2r)
        return jnp.concatenate([rl, rr])

    def one_jac(T, Tr, q, a, x1l, x2l, x1r, x2r):
        def f(eps_pose, eps_line):
            Tp = se3.exp(eps_pose) @ T
            Trp = glines.right_camera_pose(Tp, cam.baseline)
            dq = res._quat_increment(eps_line[:3])
            q2 = res._quat_mul(dq, q)
            a2 = a + eps_line[3]
            rl = res.line_residual(cam, Tp, q2, a2, x1l, x2l)
            rr = res.line_residual(cam, Trp, q2, a2, x1r, x2r)
            return jnp.concatenate([rl, rr])
        z6 = jnp.zeros(6, T.dtype)
        z4 = jnp.zeros(4, T.dtype)
        Jc = jax.jacfwd(lambda e: f(e, z4))(z6)
        Jl = jax.jacfwd(lambda e: f(z6, e))(z4)
        return Jc, Jl

    r = jax.vmap(one)(T, T_r, q, a, o.x1l, o.x2l, o.x1r, o.x2r)     # (O, 4)
    Jc, Jl = jax.vmap(one_jac)(T, T_r, q, a, o.x1l, o.x2l, o.x1r, o.x2r)

    info = (gamma * gamma) / (LINE_PYR_FACTOR
                              ** (2.0 * o.octave.astype(jnp.float32)))
    row_mask = jnp.concatenate([
        jnp.ones_like(o.has_r, jnp.float32)[:, None].repeat(2, 1),
        o.has_r.astype(jnp.float32)[:, None].repeat(2, 1)], axis=1)  # (O, 4)
    # cheirality/garbage guards: the closest line point must be in front and
    # residuals finite, else the observation contributes exactly zero
    X0, d = glines.x0dir_from_minimal(q, a)
    Xc0, _ = glines.transform_line(T, X0, d)
    chi2_raw = info * jnp.sum(r * r * row_mask, axis=-1)
    active = (o.valid & problem.line_valid[o.l] & (Xc0[..., 2] > 0.05)
              & jnp.isfinite(chi2_raw) & (chi2_raw < 1e6)).astype(r.dtype)
    r = r * active[:, None]
    Jc = Jc * active[:, None, None]
    Jl = Jl * active[:, None, None]
    chi2 = info * jnp.sum(r * r * row_mask, axis=-1)
    delta_sq = (res.CHI2_STEREO * gamma * gamma) * delta_scale
    hub = res.huber_weight(chi2, delta_sq) if robust else 1.0
    W = (info * hub * active)[:, None] * row_mask
    return r, Jc, Jl, W, chi2


def _line_blocks(problem: JointProblem, r, Jc, Jl, W):
    K = problem.base.poses.shape[0]
    L = problem.q.shape[0]
    o = problem.lobs
    JcW = Jc * W[:, :, None]
    Hcc = jnp.zeros((K, 6, 6)).at[o.k].add(jnp.einsum("ori,orj->oij", JcW, Jc))
    bc = jnp.zeros((K, 6)).at[o.k].add(-jnp.einsum("ori,or->oi", JcW, r))
    JlW = Jl * W[:, :, None]
    Hll = jnp.zeros((L, 4, 4)).at[o.l].add(jnp.einsum("ori,orj->oij", JlW, Jl))
    bl = jnp.zeros((L, 4)).at[o.l].add(-jnp.einsum("ori,or->oi", JlW, r))
    Wcl = jnp.einsum("ori,orj->oij", JcW, Jl)      # (O, 6, 4)
    return Hcc, bc, Hll, bl, Wcl


def _densify_lobs(problem: JointProblem):
    """Scatter the (O,) line-observation table into dense (K, L) grids once
    (a line is observed at most once per keyframe) — same rationale as
    `ba._densify_obs`: the LM loop then runs scatter-free."""
    K = problem.base.poses.shape[0]
    L = problem.q.shape[0]
    o = problem.lobs
    v = o.valid
    k = jnp.where(v, o.k, K)
    l = jnp.where(v, o.l, L)
    z2 = jnp.zeros((K, L, 2))
    x1l = z2.at[k, l].set(o.x1l, mode="drop")
    x2l = z2.at[k, l].set(o.x2l, mode="drop")
    x1r = z2.at[k, l].set(o.x1r, mode="drop")
    x2r = z2.at[k, l].set(o.x2r, mode="drop")
    oct_g = jnp.zeros((K, L), jnp.int32).at[k, l].set(o.octave, mode="drop")
    hasr_g = jnp.zeros((K, L), bool).at[k, l].set(o.has_r, mode="drop")
    val_g = jnp.zeros((K, L), bool).at[k, l].set(True, mode="drop")
    return x1l, x2l, x1r, x2r, oct_g, hasr_g, val_g


def _line_terms_grid(cam: StereoCamera, poses, q, alpha, line_valid,
                     x1l, x2l, x1r, x2r, oct_g, hasr_g, val_g,
                     gamma: float, robust: bool, delta_scale=1.0):
    """Grid-shaped `_line_terms` over the dense (K, L) observation grid.
    Returns r (K,L,4), Jc (K,L,4,6), Jl (K,L,4,4), W (K,L,4), chi2 (K,L)."""
    K, L = val_g.shape
    T = jnp.broadcast_to(poses[:, None], (K, L, 4, 4)).reshape(K * L, 4, 4)
    Tr = glines.right_camera_pose(T, cam.baseline)
    qf = jnp.broadcast_to(q[None], (K, L, 4)).reshape(K * L, 4)
    af = jnp.broadcast_to(alpha[None], (K, L)).reshape(K * L)
    flat2 = lambda a: a.reshape(K * L, 2)

    def one(T, Tr, q, a, x1l, x2l, x1r, x2r):
        rl = res.line_residual(cam, T, q, a, x1l, x2l)
        rr = res.line_residual(cam, Tr, q, a, x1r, x2r)
        return jnp.concatenate([rl, rr])

    def one_jac(T, Tr, q, a, x1l, x2l, x1r, x2r):
        def f(eps_pose, eps_line):
            Tp = se3.exp(eps_pose) @ T
            Trp = glines.right_camera_pose(Tp, cam.baseline)
            dq = res._quat_increment(eps_line[:3])
            q2 = res._quat_mul(dq, q)
            a2 = a + eps_line[3]
            rl = res.line_residual(cam, Tp, q2, a2, x1l, x2l)
            rr = res.line_residual(cam, Trp, q2, a2, x1r, x2r)
            return jnp.concatenate([rl, rr])
        z6 = jnp.zeros(6, T.dtype)
        z4 = jnp.zeros(4, T.dtype)
        Jc = jax.jacfwd(lambda e: f(e, z4))(z6)
        Jl = jax.jacfwd(lambda e: f(z6, e))(z4)
        return Jc, Jl

    args = (T, Tr, qf, af, flat2(x1l), flat2(x2l), flat2(x1r), flat2(x2r))
    r = jax.vmap(one)(*args).reshape(K, L, 4)
    Jc, Jl = jax.vmap(one_jac)(*args)
    Jc = Jc.reshape(K, L, 4, 6)
    Jl = Jl.reshape(K, L, 4, 4)

    info = (gamma * gamma) / (LINE_PYR_FACTOR
                              ** (2.0 * oct_g.astype(jnp.float32)))
    row_mask = jnp.concatenate([
        jnp.ones((K, L, 2), jnp.float32),
        jnp.broadcast_to(hasr_g.astype(jnp.float32)[..., None], (K, L, 2)),
    ], axis=-1)                                              # (K, L, 4)
    X0, d = glines.x0dir_from_minimal(q, alpha)              # (L, 3)
    Xc0, _ = glines.transform_line(poses[:, None], X0[None], d[None])
    chi2_raw = info * jnp.sum(r * r * row_mask, axis=-1)
    active = (val_g & line_valid[None, :] & (Xc0[..., 2] > 0.05)
              & jnp.isfinite(chi2_raw) & (chi2_raw < 1e6)).astype(r.dtype)
    r = r * active[..., None]
    Jc = Jc * active[..., None, None]
    Jl = Jl * active[..., None, None]
    chi2 = info * jnp.sum(r * r * row_mask, axis=-1)
    delta_sq = (res.CHI2_STEREO * gamma * gamma) * delta_scale
    hub = res.huber_weight(chi2, delta_sq) if robust else 1.0
    W = (info * hub * active)[..., None] * row_mask
    return r, Jc, Jl, W, chi2


def _line_blocks_grid(r, Jc, Jl, W):
    """Line normal-equation blocks from grid terms — einsums only."""
    JcW = Jc * W[..., None]                                   # (K, L, 4, 6)
    Hcc = jnp.einsum("klri,klrj->kij", JcW, Jc)
    bc = -jnp.einsum("klri,klr->ki", JcW, r)
    JlW = Jl * W[..., None]
    Hll = jnp.einsum("klri,klrj->lij", JlW, Jl)
    bl = -jnp.einsum("klri,klr->li", JlW, r)
    Bl = jnp.einsum("klri,klrj->klij", JcW, Jl)               # (K, L, 6, 4)
    return Hcc, bc, Hll, bl, Bl


def _inv4x4(A):
    """Batched 4x4 inverse by blockwise elimination on 2x2 sub-blocks
    (closed-form 2x2 inverses; no serialized LU). A is damped SPD."""
    a = A[..., :2, :2]
    b = A[..., :2, 2:]
    c = A[..., 2:, :2]
    d = A[..., 2:, 2:]

    def inv2(M):
        m00, m01 = M[..., 0, 0], M[..., 0, 1]
        m10, m11 = M[..., 1, 0], M[..., 1, 1]
        det = m00 * m11 - m01 * m10
        idet = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
        row0 = jnp.stack([m11, -m01], -1)
        row1 = jnp.stack([-m10, m00], -1)
        return jnp.stack([row0, row1], -2) * idet[..., None, None]

    ai = inv2(a)
    schur = d - c @ ai @ b
    si = inv2(schur)
    aib = ai @ b
    cai = c @ ai
    top_left = ai + aib @ si @ cai
    top_right = -(aib @ si)
    bot_left = -(si @ cai)
    top = jnp.concatenate([top_left, top_right], axis=-1)
    bot = jnp.concatenate([bot_left, si], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _apply_line_update(problem: JointProblem, dl):
    dq = res._quat_increment(dl[:, :3])
    q = res._quat_mul(dq, problem.q)
    alpha = problem.alpha + dl[:, 3]
    return problem._replace(q=q, alpha=alpha)


@partial(jax.jit, static_argnames=("cam", "iters", "gamma", "robust", "gnc"))
def joint_ba_solve(
    cam: StereoCamera,
    problem: JointProblem,
    iters: int = 5,
    gamma: float = 0.5,
    robust: bool = True,
    gnc: bool = True,
):
    """LM iterations on the joint problem (dense two-class Schur) over the
    dense (K, P) point grid + (K, L) line grid — scatter-free iterations.
    Returns (problem', point chi2 (Op,), line chi2 (Ol,))."""
    uvr_g, w_g, st_g, pval_g = ba._densify_obs(problem.base)
    lx1l, lx2l, lx1r, lx2r, loct, lhasr, lval_g = _densify_lobs(problem)
    point_valid = problem.base.point_valid
    pose_fixed = problem.base.pose_fixed

    def total_cost(pb, dscale):
        c = ba._total_cost_grid(cam, pb.base.poses, pb.base.points,
                                point_valid, uvr_g, w_g, st_g, pval_g,
                                robust, dscale)
        r, _, _, W, chi2 = _line_terms_grid(
            cam, pb.base.poses, pb.q, pb.alpha, pb.line_valid,
            lx1l, lx2l, lx1r, lx2r, loct, lhasr, lval_g,
            gamma, robust, dscale)
        delta_sq = (res.CHI2_STEREO * gamma * gamma) * dscale
        lc = jnp.sum(res.huber_rho(chi2, delta_sq)
                     * (chi2 > 0).astype(r.dtype)) if robust else jnp.sum(chi2)
        return c + lc

    def body(i, state):
        problem, lam = state
        dscale = jnp.maximum(1.0, 64.0 * 0.5 ** i) if gnc else 1.0
        # point system (grid)
        rp, Jcp, Jp, Wp, _, c_old_p = ba._terms_grid(
            cam, problem.base.poses, problem.base.points, point_valid,
            uvr_g, w_g, st_g, pval_g, robust, dscale)
        Hcc, bc, Hpp, bp, Bp = ba._build_blocks_grid(rp, Jcp, Jp, Wp)
        # line system (grid)
        rl, Jcl, Jl, Wl, chi2_l0 = _line_terms_grid(
            cam, problem.base.poses, problem.q, problem.alpha,
            problem.line_valid, lx1l, lx2l, lx1r, lx2r, loct, lhasr, lval_g,
            gamma, robust, dscale)
        Hcc_l, bc_l, Hll, bl, Bl = _line_blocks_grid(rl, Jcl, Jl, Wl)
        Hcc = Hcc + Hcc_l
        bc = bc + bc_l

        K = problem.base.poses.shape[0]

        Hpp_d = ba._damp_diag(Hpp, lam)
        seen_p = jnp.abs(Bp).sum(axis=(0, 2, 3)) > 0
        Hpp_d = jnp.where(seen_p[:, None, None], Hpp_d,
                          jnp.eye(3, dtype=Hpp.dtype)[None])
        Hpp_inv = ba._inv3x3(Hpp_d)
        Hll_d = ba._damp_diag(Hll, lam)
        seen_l = jnp.abs(Bl).sum(axis=(0, 2, 3)) > 0
        Hll_d = jnp.where(seen_l[:, None, None], Hll_d,
                          jnp.eye(4, dtype=Hll.dtype)[None])
        Hll_inv = _inv4x4(Hll_d)

        BHp = jnp.einsum("kpij,pjl->kpil", Bp, Hpp_inv)
        BHl = jnp.einsum("klij,ljm->klim", Bl, Hll_inv)
        S = jnp.einsum("kij,kq->kiqj", ba._damp_diag(Hcc, lam),
                       jnp.eye(K, dtype=Hcc.dtype))
        S = S - jnp.einsum("kpil,qpjl->kiqj", BHp, Bp)
        S = S - jnp.einsum("klim,qljm->kiqj", BHl, Bl)
        rhs = bc - jnp.einsum("kpil,pl->ki", BHp, bp) \
            - jnp.einsum("klim,lm->ki", BHl, bl)
        S, rhs = ba._fix_gauge(S, rhs, problem.base.pose_fixed)
        Sm = S.reshape(6 * K, 6 * K)
        Sm = 0.5 * (Sm + Sm.T)
        dg = jnp.diagonal(Sm)
        dsi = 1.0 / jnp.sqrt(jnp.maximum(jnp.abs(dg), 1e-12))
        Ss = Sm * dsi[:, None] * dsi[None, :] + 1e-6 * jnp.eye(6 * K, dtype=Sm.dtype)
        y = jnp.linalg.solve(Ss, rhs.reshape(6 * K) * dsi)
        dc = (y * dsi).reshape(K, 6)
        dp = jnp.einsum("pij,pj->pi", Hpp_inv,
                        bp - jnp.einsum("kpij,ki->pj", Bp, dc))
        dp = dp * point_valid[:, None]
        dl = jnp.einsum("lij,lj->li", Hll_inv,
                        bl - jnp.einsum("klij,ki->lj", Bl, dc))
        dl = dl * problem.line_valid[:, None]

        cand_base = ba._apply_update(problem.base, dc, dp)
        cand = _apply_line_update(problem._replace(base=cand_base), dl)
        # c_old folded out of the terms passes above (bit-identical to
        # total_cost on the current state — see ba._terms_grid)
        delta_sq_l = (res.CHI2_STEREO * gamma * gamma) * dscale
        lc_old = jnp.sum(res.huber_rho(chi2_l0, delta_sq_l)
                         * (chi2_l0 > 0).astype(rl.dtype)) if robust \
            else jnp.sum(chi2_l0)
        c_old = c_old_p + lc_old
        c_new = total_cost(cand, dscale)
        accept = c_new < c_old
        problem = jax.tree.map(lambda a, b: jnp.where(accept, b, a),
                               problem, cand)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e4)
        return (problem, lam)

    problem, _ = jax.lax.fori_loop(
        0, iters, body, (problem, jnp.asarray(1e-4, problem.q.dtype)))
    # final chi2 for outlier classification
    o = problem.base.obs
    rp = res.point_residual_stereo(
        cam, problem.base.poses[o.k], problem.base.points[o.p], o.uvr)
    row_w = jnp.where(o.is_stereo[:, None], 1.0,
                      jnp.array([1.0, 1.0, 0.0])[None, :])
    chi2_p = o.inv_sigma2 * jnp.sum(rp * rp * row_w, axis=-1)
    _, _, _, _, chi2_l = _line_terms(cam, problem, gamma, robust=False)
    return problem, chi2_p, chi2_l


def _joint_cost(cam: StereoCamera, problem: JointProblem, gamma: float,
                robust: bool, dscale):
    """Total robust cost over BOTH landmark classes (sparse obs tables)."""
    c = ba._total_cost(cam, problem.base, robust, dscale)
    _, _, _, _, chi2 = _line_terms(cam, problem, gamma, robust=False,
                                   delta_scale=dscale)
    delta_sq = (res.CHI2_STEREO * gamma * gamma) * dscale
    lc = jnp.sum((res.huber_rho(chi2, delta_sq) if robust else chi2)
                 * (chi2 > 0))
    return c + lc


def _schur_cg_joint(problem: JointProblem, Hcc, bc, Hpp, bp, Wcp,
                    Hll, bl, Wcl, lam, cg_iters: int):
    """Matrix-free reduced camera system with BOTH landmark classes
    marginalized:

        S = Hcc_d - Wcp Hpp^-1 Wcp^T - Wcl Hll^-1 Wcl^T

    S@v costs two observation-level gather/scatter passes per class — the
    same O(observations) shape as ba._schur_cg, so the joint global problem
    (reference src/Optimizer.cc:321-560 with line insertion at :473) solves
    at the cost of the point-only one plus the (much smaller) line table."""
    base = problem.base
    o = base.obs
    ol = problem.lobs
    K = base.poses.shape[0]
    P = base.points.shape[0]
    L = problem.q.shape[0]
    free = (~base.pose_fixed).astype(bc.dtype)

    Hpp_d = ba._damp_diag(Hpp, lam)
    seen_p = jnp.zeros((P,)).at[o.p].add(jnp.abs(Wcp).sum(axis=(1, 2))) > 0
    Hpp_d = jnp.where(seen_p[:, None, None], Hpp_d,
                      jnp.eye(3, dtype=Hpp.dtype)[None])
    Hpp_inv = ba._inv3x3(Hpp_d)
    Hll_d = ba._damp_diag(Hll, lam)
    seen_l = jnp.zeros((L,)).at[ol.l].add(jnp.abs(Wcl).sum(axis=(1, 2))) > 0
    Hll_d = jnp.where(seen_l[:, None, None], Hll_d,
                      jnp.eye(4, dtype=Hll.dtype)[None])
    Hll_inv = _inv4x4(Hll_d)
    Hcc_d = ba._damp_diag(Hcc, lam)

    def S_matvec(v):  # v (K, 6)
        v = v * free[:, None]
        y = jnp.einsum("kij,kj->ki", Hcc_d, v)
        zp = jnp.zeros((P, 3)).at[o.p].add(
            jnp.einsum("oij,oi->oj", Wcp, v[o.k]))
        zp = jnp.einsum("pij,pj->pi", Hpp_inv, zp)
        yp = jnp.zeros((K, 6)).at[o.k].add(
            jnp.einsum("oij,oj->oi", Wcp, zp[o.p]))
        zl = jnp.zeros((L, 4)).at[ol.l].add(
            jnp.einsum("oij,oi->oj", Wcl, v[ol.k]))
        zl = jnp.einsum("lij,lj->li", Hll_inv, zl)
        yl = jnp.zeros((K, 6)).at[ol.k].add(
            jnp.einsum("oij,oj->oi", Wcl, zl[ol.l]))
        return (y - yp - yl) * free[:, None]

    rhs = (bc
           - jnp.zeros((K, 6)).at[o.k].add(jnp.einsum(
               "oij,oj->oi", Wcp,
               jnp.einsum("pij,pj->pi", Hpp_inv, bp)[o.p]))
           - jnp.zeros((K, 6)).at[ol.k].add(jnp.einsum(
               "oij,oj->oi", Wcl,
               jnp.einsum("lij,lj->li", Hll_inv, bl)[ol.l]))
           ) * free[:, None]

    # block-Jacobi preconditioner on Jacobi-scaled blocks (ba._schur_cg note)
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

    r0 = rhs
    z0 = precond(r0)
    dc, *_ = jax.lax.fori_loop(
        0, cg_iters, cg_body, (jnp.zeros_like(rhs), r0, z0, z0,
                               jnp.sum(r0 * z0)))
    # back-substitute both landmark classes
    zp = jnp.zeros((P, 3)).at[o.p].add(jnp.einsum("oij,oi->oj", Wcp, dc[o.k]))
    dp = jnp.einsum("pij,pj->pi", Hpp_inv, bp - zp)
    dp = dp * base.point_valid[:, None]
    zl = jnp.zeros((L, 4)).at[ol.l].add(
        jnp.einsum("oij,oi->oj", Wcl, dc[ol.k]))
    dl = jnp.einsum("lij,lj->li", Hll_inv, bl - zl)
    dl = dl * (problem.line_valid & seen_l)[:, None]
    return dc, dp, dl


@partial(jax.jit, static_argnames=("cam", "iters", "cg_iters", "gamma",
                                   "robust", "gnc"))
def joint_ba_solve_cg(
    cam: StereoCamera,
    problem: JointProblem,
    iters: int = 10,
    cg_iters: int = 64,
    gamma: float = 0.5,
    robust: bool = True,
    gnc: bool = True,
):
    """Joint pose+point+line GLOBAL bundle adjustment: the matrix-free Schur
    CG path of optim/ba.py extended with 4x4 line blocks marginalized next to
    the 3x3 point blocks — the batched equivalent of the reference's
    global problem where >=4-obs lines sit inside the same g2o graph as
    points and poses (src/Optimizer.cc:321-560, line insertion :473 via
    AddLineMinimalGlobal :149). The multi-device form of the same solve is
    parallel/dist_schur.dist_joint_ba_solve. Returns
    (problem', chi2_p, chi2_l)."""

    def body(i, state):
        problem, lam = state
        base = problem.base
        dscale = jnp.maximum(1.0, 64.0 * 0.5 ** i) if gnc else 1.0
        rp, Jcp, Jp, Wp, _, _ = ba._terms(cam, base, robust, dscale)
        Hcc, bc, Hpp, bp, Wcp = ba._build_blocks(base, rp, Jcp, Jp, Wp)
        rl, Jcl, Jl, Wl, _ = _line_terms(cam, problem, gamma, robust, dscale)
        Hcc_l, bc_l, Hll, bl, Wcl = _line_blocks(problem, rl, Jcl, Jl, Wl)
        dc, dp, dl = _schur_cg_joint(
            problem, Hcc + Hcc_l, bc + bc_l, Hpp, bp, Wcp, Hll, bl, Wcl,
            lam, cg_iters)
        cand_base = ba._apply_update(base, dc, dp)
        cand = _apply_line_update(problem._replace(base=cand_base), dl)
        c_old = _joint_cost(cam, problem, gamma, robust, dscale)
        c_new = _joint_cost(cam, cand, gamma, robust, dscale)
        accept = c_new < c_old
        problem = jax.tree.map(lambda a, b: jnp.where(accept, b, a),
                               problem, cand)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e4)
        return (problem, lam)

    problem, _ = jax.lax.fori_loop(
        0, iters, body, (problem, jnp.asarray(1e-4, problem.q.dtype)))
    o = problem.base.obs
    rp = res.point_residual_stereo(
        cam, problem.base.poses[o.k], problem.base.points[o.p], o.uvr)
    row_w = jnp.where(o.is_stereo[:, None], 1.0,
                      jnp.array([1.0, 1.0, 0.0])[None, :])
    chi2_p = o.inv_sigma2 * jnp.sum(rp * rp * row_w, axis=-1)
    _, _, _, _, chi2_l = _line_terms(cam, problem, gamma, robust=False)
    return problem, chi2_p, chi2_l


@partial(jax.jit, static_argnames=("cam", "iters", "gamma"))
def refine_lines_fixed_poses(cam: StereoCamera, problem: JointProblem,
                             gamma: float = 0.5, iters: int = 4):
    """Line refinement with poses held fixed: per-line damped 4x4 GN
    assembled by segment-sum over ALL observations. A standalone utility:
    both global-BA paths now keep the reference's pose<->line coupling
    (single-device joint_ba_solve_cg; distributed
    dist_schur.dist_joint_ba_solve — Optimizer.cc:473 /
    AddLineMinimalGlobal :149). Returns (q, alpha)."""
    L = problem.q.shape[0]
    o = problem.lobs
    lam = 1e-3

    def body(i, state):
        q, a = state
        pb = problem._replace(q=q, alpha=a)
        r, Jc, Jl, W, chi2 = _line_terms(cam, pb, gamma, robust=True)
        JlW = Jl * W[:, :, None]
        Hll = jnp.zeros((L, 4, 4)).at[o.l].add(
            jnp.einsum("ori,orj->oij", JlW, Jl))
        bl = jnp.zeros((L, 4)).at[o.l].add(-jnp.einsum("ori,or->oi", JlW, r))
        Hll = Hll + lam * jnp.eye(4)[None]
        dl = jnp.einsum("lij,lj->li", _inv4x4(Hll), bl)
        has = jnp.zeros((L,), r.dtype).at[o.l].add(W.sum(-1)) > 0
        dl = jnp.where((has & problem.line_valid)[:, None], dl, 0.0)
        pb2 = _apply_line_update(pb, dl)
        q2, a2 = pb2.q, pb2.alpha
        fin = jnp.isfinite(q2).all(-1) & jnp.isfinite(a2)
        q2 = jnp.where(fin[:, None], q2, q)
        a2 = jnp.where(fin, a2, a)
        return q2, a2

    return jax.lax.fori_loop(0, iters, body, (problem.q, problem.alpha))


def classify_line_outliers(problem: JointProblem, chi2_l, gamma: float = 0.5):
    """Line observation inlier mask: chi2 against the gamma-scaled stereo
    threshold x2 (the LineOptimizer DisableOutliers gate semantics,
    LineOptimizer.cc:129-170)."""
    th = 2.0 * res.CHI2_STEREO * gamma * gamma
    return problem.lobs.valid & (chi2_l <= th)


def local_joint_ba(cam: StereoCamera, problem: JointProblem,
                   gamma: float = 0.5):
    """Reference local-BA schedule with both landmark classes: 5 iters,
    drop point+line outliers, 10 more iters, final classification
    (Optimizer.cc:1223-1296 + LineOptimizer ln_filter)."""
    problem, chi2_p, chi2_l = joint_ba_solve(cam, problem, iters=5,
                                             gamma=gamma)
    keep_p = ba.classify_outliers(problem.base, chi2_p, cam)
    keep_l = classify_line_outliers(problem, chi2_l, gamma)
    problem = problem._replace(
        base=problem.base._replace(
            obs=problem.base.obs._replace(valid=keep_p)),
        lobs=problem.lobs._replace(valid=keep_l))
    problem, chi2_p, chi2_l = joint_ba_solve(cam, problem, iters=10,
                                             gamma=gamma)
    keep_p = ba.classify_outliers(problem.base, chi2_p, cam)
    keep_l = classify_line_outliers(problem, chi2_l, gamma)
    return problem, keep_p, keep_l


@partial(jax.jit, static_argnames=("cam", "gamma"))
def local_joint_ba_packed(cam: StereoCamera, problem: JointProblem,
                          gamma: float = 0.5) -> jnp.ndarray:
    """local_joint_ba with all host-bound results in ONE int32 buffer
    (one device->host transfer): poses | points | q | alpha | keep_p |
    keep_l."""
    solved, keep_p, keep_l = local_joint_ba(cam, problem, gamma)
    bc = lambda a: jax.lax.bitcast_convert_type(a, jnp.int32)
    return jnp.concatenate([
        bc(solved.base.poses.reshape(-1)),
        bc(solved.base.points.reshape(-1)),
        bc(solved.q.reshape(-1)),
        bc(solved.alpha),
        keep_p.astype(jnp.int32),
        keep_l.astype(jnp.int32),
    ])


def unpack_local_joint_np(buf, K: int, P: int, L: int, Op: int):
    """Inverse of local_joint_ba_packed on host."""
    import numpy as np
    o = 16 * K
    poses = buf[:o].view(np.float32).reshape(K, 4, 4)
    points = buf[o:o + 3 * P].view(np.float32).reshape(P, 3); o += 3 * P
    q = buf[o:o + 4 * L].view(np.float32).reshape(L, 4); o += 4 * L
    alpha = buf[o:o + L].view(np.float32); o += L
    keep_p = buf[o:o + Op].astype(bool); o += Op
    keep_l = buf[o:].astype(bool)
    return poses, points, q, alpha, keep_p, keep_l
