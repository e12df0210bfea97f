"""Line matching kernels: stereo left/right and temporal association.

Replaces `TwoFrameLineMatcher` (reference src/TwoFrameLineMatcher.cc) and the
line-association half of `Tracking::AddLinesFrom` (src/Tracking.cc:996-1124):
the reference's greedy O(L^2) loops become masked dense cost matrices with
batched pairwise triangulation.

Stereo gates (TwoFrameLineMatcher::CheckLinePair, .cc:79-123):
- same octave (:81), both lengths >= minLineLen (:86-91),
- triangulable (plane-normal parallelism guard, vgl.cc:85) with
  ||X0|| >= 0.5 (:100), endpoint depths positive in the left camera
  (:104-109),
- descriptor distance < tau, best candidate wins, one right line per left
  (mutual-exclusion flags :30-34, 62-66).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import lines as gl, se3
from ..geometry.camera import StereoCamera
from .line_extract import KeyLines


class FrameLines(NamedTuple):
    """Per-frame line state: left detections + stereo triangulation."""

    kl: KeyLines          # left-image detections
    r_idx: jnp.ndarray    # (L,) matched right line or -1
    X0: jnp.ndarray       # (L, 3) triangulated closest point (LEFT CAM frame)
    d: jnp.ndarray        # (L, 3) direction (left cam frame)
    has_stereo: jnp.ndarray  # (L,) bool
    p1_r: jnp.ndarray     # (L, 2) matched right endpoints (0 when none)
    p2_r: jnp.ndarray


def _desc_dist(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Pairwise L2 distance (Na, Nb) via the matmul identity — the
    broadcast-difference form materializes an (Na, Nb, D) tensor
    (~63 MB at the 512x256x40 reference-workload shapes; this is one
    (Na, D)@(D, Nb) matrix product)."""
    sq = jnp.sum(a * a, -1)[:, None] + jnp.sum(b * b, -1)[None] \
        - 2.0 * (a @ b.T)
    return jnp.sqrt(jnp.maximum(sq, 0.0))


@partial(jax.jit, static_argnames=("cam", "md_thr", "min_len"))
def match_stereo_lines(
    cam: StereoCamera,
    kl: KeyLines,
    kr: KeyLines,
    md_thr: float = 0.6,
    min_len: float = 25.0,
) -> FrameLines:
    """Greedy stereo line matching + pairwise two-view triangulation."""
    L = kl.p1.shape[0]
    R = kr.p1.shape[0]

    # Endpoint-disparity triangulation. The reference triangulates stereo
    # lines by intersecting the two back-projected planes (vgl.cc:78-108),
    # but at stereo baselines those planes are 1-3 degrees apart and the
    # cross-product direction is noise-dominated (its own 0.975 parallelism
    # guard at vgl.cc:85 would reject every stereo pair). Lifting the LEFT
    # endpoints through the disparity against the RIGHT infinite line is the
    # well-conditioned equivalent (degenerate only for near-horizontal
    # lines, gated below).
    lr = gl.line_eq_from_endpoints(kr.p1, kr.p2)                 # (R, 3)
    a_r = lr[:, 0]
    vert_ok = jnp.abs(a_r) > 0.2                                 # not ~horizontal

    # CHEAP per-pair geometry proxy over all (L, R) pairs: lift only the
    # two left ENDPOINTS against each right line and require positive,
    # bounded disparity. The full 8-sample PCA triangulation below runs
    # only for the SELECTED pair per left line — the all-pairs version is
    # 65K batched 3x3 eigh at the 256-line reference workload.
    a_safe = jnp.where(jnp.abs(a_r) < 1e-6, 1e-6, a_r)
    Pe = jnp.stack([kl.p1, kl.p2], axis=1)                       # (L, 2, 2)
    ye = Pe[..., 1]                                              # (L, 2)
    xr_e = -(lr[None, None, :, 1] * ye[:, :, None] + lr[None, None, :, 2]) \
        / a_safe[None, None]
    disp_e = Pe[..., 0][:, :, None] - xr_e                       # (L, 2, R)
    ze = cam.bf / jnp.maximum(disp_e, 1e-6)
    geom_ok = jnp.all((disp_e > 0.5) & (ze > 0.3), axis=1) & vert_ok[None, :]

    # rectified-stereo consistency: same orientation (mod pi), overlapping
    # vertical extent, and non-negative disparity at the midpoint
    def seg_angle(p1, p2):
        d2 = p2 - p1
        a = jnp.arctan2(d2[..., 1], d2[..., 0])
        return jnp.where(a < 0, a + jnp.pi, a)

    da = jnp.abs(seg_angle(kl.p1, kl.p2)[:, None] - seg_angle(kr.p1, kr.p2)[None])
    da = jnp.minimum(da, jnp.pi - da)
    yl_lo = jnp.minimum(kl.p1[:, 1], kl.p2[:, 1])
    yl_hi = jnp.maximum(kl.p1[:, 1], kl.p2[:, 1])
    yr_lo = jnp.minimum(kr.p1[:, 1], kr.p2[:, 1])
    yr_hi = jnp.maximum(kr.p1[:, 1], kr.p2[:, 1])
    overlap = jnp.minimum(yl_hi[:, None], yr_hi[None]) \
        - jnp.maximum(yl_lo[:, None], yr_lo[None])
    span = jnp.maximum(jnp.minimum(yl_hi[:, None] - yl_lo[:, None],
                                   yr_hi[None] - yr_lo[None]), 1.0)
    mid_xl = 0.5 * (kl.p1[:, 0] + kl.p2[:, 0])
    mid_xr = 0.5 * (kr.p1[:, 0] + kr.p2[:, 0])
    disp_ok = (mid_xl[:, None] - mid_xr[None]) > -3.0
    stereo_ok = (da < 0.1) & (overlap > 0.5 * span) & disp_ok

    dist = _desc_dist(kl.desc, kr.desc)
    gate = (kl.octave[:, None] == kr.octave[None]) \
        & (kl.length[:, None] >= min_len) & (kr.length[None] >= min_len) \
        & kl.valid[:, None] & kr.valid[None] & geom_ok & stereo_ok \
        & (dist < md_thr)
    cost = jnp.where(gate, dist, jnp.inf)
    best = jnp.argmin(cost, axis=1)
    best_cost = jnp.take_along_axis(cost, best[:, None], axis=1)[:, 0]
    ok = jnp.isfinite(best_cost)
    # one right line per left: keep the lowest-cost claimant
    r_best = jnp.full((R,), jnp.inf).at[best].min(jnp.where(ok, best_cost, jnp.inf))
    winner = ok & (best_cost == r_best[best])
    lidx = jnp.arange(L, dtype=jnp.int32)
    r_claim = jnp.full((R,), L, jnp.int32).at[best].min(jnp.where(winner, lidx, L))
    winner = winner & (r_claim[best] == lidx)

    bsel0 = jnp.maximum(jnp.where(ok, best, 0), 0)
    # full triangulation for the selected pair only: sample along the left
    # segment, lift each sample through the disparity against the chosen
    # right infinite line, fit the 3D line by PCA (averages per-pixel
    # disparity noise that would otherwise dominate short segments)
    S = 8
    ts = jnp.linspace(0.0, 1.0, S)
    P = kl.p1[:, None, :] + ts[None, :, None] * (kl.p2 - kl.p1)[:, None, :]
    y = P[..., 1]                                               # (L, S)
    lr_s = lr[bsel0]                                            # (L, 3)
    a_s = a_safe[bsel0]
    x_r = -(lr_s[:, None, 1] * y + lr_s[:, None, 2]) / a_s[:, None]
    disp = P[..., 0] - x_r                                      # (L, S)
    z = cam.bf / jnp.maximum(disp, 1e-6)
    X = jnp.stack([(P[..., 0] - cam.cx) * z / cam.fx,
                   (P[..., 1] - cam.cy) * z / cam.fy, z], -1)   # (L, S, 3)
    ok_s = jnp.all((disp > 0.5) & (z > 0.3), axis=-1)           # (L,)
    ctr = X.mean(axis=1)
    Xc = X - ctr[:, None, :]
    cov = jnp.einsum("lsi,lsj->lij", Xc, Xc) / S
    _, vecs = jnp.linalg.eigh(cov)
    dvec = vecs[..., -1]                                        # (L, 3)
    span = 2.0 * jnp.sqrt(jnp.maximum(
        jnp.einsum("lsi,li->ls", Xc, dvec).var(axis=-1), 1e-12))
    X0, d = gl.closest_point_form(ctr, dvec)
    winner = winner & ok_s & (jnp.linalg.norm(X0, axis=-1) >= 0.5) \
        & (span > 1e-3)

    r_idx = jnp.where(winner, best, -1)
    bsel = jnp.maximum(r_idx, 0)
    X0_m = X0 * winner[:, None]
    d_m = d * winner[:, None]
    return FrameLines(
        kl=kl,
        r_idx=r_idx,
        X0=X0_m,
        d=d_m,
        has_stereo=winner,
        p1_r=kr.p1[bsel] * winner[:, None],
        p2_r=kr.p2[bsel] * winner[:, None],
    )


@partial(jax.jit, static_argnames=("cam", "md_thr", "reproj_thr"))
def associate_lines(
    cam: StereoCamera,
    T_cw: jnp.ndarray,
    ln_X0: jnp.ndarray,     # (M, 3) map lines, world
    ln_d: jnp.ndarray,      # (M, 3)
    ln_desc: jnp.ndarray,   # (M, D)
    ln_oct: jnp.ndarray,    # (M,) int32
    ln_valid: jnp.ndarray,  # (M,) bool
    fl: FrameLines,
    md_thr: float = 0.6,
    reproj_thr: float = 8.0,
):
    """Temporal line association (AddLinesFrom, Tracking.cc:996-1124 intent
    with the D1 Hough-grid gate replaced by a dense reprojection gate —
    the grid exists only to prune CPU work):

    For every (map line, detected line) pair: project the map line into the
    left and right cameras, gate on per-octave L1 endpoint reprojection
    error (GetReprojErrPixelsL1, LineMatching.cc:270, threshold scaled by
    1.44^octave :239) in BOTH views (Tracking.cc:1078-1089), then on LBD
    descriptor distance < mdThr (:1092). Greedy best per detection.

    Returns ln2det (M,) int32 and det2ln (L,) int32.
    """
    kl = fl.kl
    L = kl.p1.shape[0]
    M = ln_X0.shape[0]
    T_r = gl.right_camera_pose(T_cw, cam.baseline)

    def l1_err(T, p1, p2):
        # project every map line, distance of detection endpoints to it
        lproj = gl.project_line(cam, T, ln_X0, ln_d)          # (M, 3)
        d1 = jnp.abs(gl.point_line_distance(lproj[:, None], p1[None]))
        d2 = jnp.abs(gl.point_line_distance(lproj[:, None], p2[None]))
        return d1 + d2                                         # (M, L)

    err_l = l1_err(T_cw, kl.p1, kl.p2)
    err_r = l1_err(T_r, fl.p1_r, fl.p2_r)
    th = reproj_thr * (1.44 ** kl.octave.astype(jnp.float32))[None, :]
    reproj_ok = (err_l < th) & (jnp.where(fl.has_stereo[None], err_r, 0.0) < th)
    # cheirality of the projected line in front of the camera
    Xc0, dc = gl.transform_line(T_cw, ln_X0, ln_d)
    front = Xc0[..., 2] > 0  # closest point in front (coarse gate)

    dist = _desc_dist(ln_desc, kl.desc)
    gate = reproj_ok & (dist < md_thr) & ln_valid[:, None] & kl.valid[None] \
        & front[:, None]
    cost = jnp.where(gate, dist, jnp.inf)
    best = jnp.argmin(cost, axis=1)                    # per map line
    best_cost = jnp.take_along_axis(cost, best[:, None], axis=1)[:, 0]
    ok = jnp.isfinite(best_cost)
    det_best = jnp.full((L,), jnp.inf).at[best].min(jnp.where(ok, best_cost, jnp.inf))
    winner = ok & (best_cost == det_best[best])
    midx = jnp.arange(M, dtype=jnp.int32)
    det_claim = jnp.full((L,), M, jnp.int32).at[best].min(jnp.where(winner, midx, M))
    winner = winner & (det_claim[best] == midx)
    ln2det = jnp.where(winner, best, -1)
    det2ln = jnp.full((L,), -1, jnp.int32).at[best].max(jnp.where(winner, midx, -1))
    return ln2det, det2ln
