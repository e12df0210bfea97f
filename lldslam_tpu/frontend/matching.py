"""Projection-based data association kernels.

Replaces the candidate-search loops of `ORBmatcher::SearchByProjection`
(reference src/ORBmatcher.cc:45-157 local-map variant; :1328-1470 last-frame
variant) with dense masked Hamming matrices — the grid buckets
(Frame::GetFeaturesInArea) exist only to prune the CPU search; on an
accelerator a masked (points x keypoints) distance matrix is one matrix
product plus fused elementwise gates.

Gates implemented (ORBmatcher.cc:45-157):
- frustum: positive depth, image bounds, distance in [minDist, maxDist],
  viewing-angle cos > 0.5 (Frame::isInFrustum, src/Frame.cc:333-388),
- predicted octave from distance (MapPoint::PredictScale, MapPoint.cc:385),
- search window r in {2.5, 4.0} px by viewing cos, scaled by predicted octave
  (ORBmatcher.cc:131-137), octave window [pred-1, pred] (ORBmatcher.cc:105),
- stereo right-u consistency |uR_pred - uR_kp| < r*scale (ORBmatcher.cc:112),
- Hamming best under TH_HIGH, best/second ratio when both hit the same
  octave (ORBmatcher.cc:117-127).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..geometry import se3
from ..geometry.camera import StereoCamera
from ..ops import hamming


class MapPointView(NamedTuple):
    """Device view of candidate map points for one frame's association."""

    pos: jnp.ndarray        # (P, 3) world
    desc: jnp.ndarray       # (P, 8) uint32 distinctive descriptor
    normal: jnp.ndarray     # (P, 3) mean viewing direction
    min_dist: jnp.ndarray   # (P,) scale-invariance range
    max_dist: jnp.ndarray   # (P,)
    valid: jnp.ndarray      # (P,) bool


class FrameFeatures(NamedTuple):
    """Device view of one frame's keypoints (left camera, level-0 coords)."""

    xy: jnp.ndarray       # (N, 2)
    ur: jnp.ndarray       # (N,) right-u or -1
    octave: jnp.ndarray   # (N,) int32
    angle: jnp.ndarray    # (N,)
    desc: jnp.ndarray     # (N, 8) uint32
    valid: jnp.ndarray    # (N,) bool


def predict_octave(dist, max_dist, n_levels: int, log_scale: float):
    """nScale = ceil(log(maxDist/d)/log(1.2)) clamped (MapPoint.cc:385-417)."""
    ratio = max_dist / jnp.maximum(dist, 1e-6)
    lvl = jnp.ceil(jnp.log(jnp.maximum(ratio, 1e-6)) / log_scale).astype(jnp.int32)
    return jnp.clip(lvl, 0, n_levels - 1)


@partial(jax.jit, static_argnames=("cam", "n_levels", "scale", "check_rot"))
def search_by_projection(
    cam: StereoCamera,
    T_cw: jnp.ndarray,
    pts: MapPointView,
    frame: FrameFeatures,
    n_levels: int = 8,
    scale: float = 1.2,
    th: float = 1.0,   # traced (not static): every window size shares ONE
                       # compiled program — reloc/loop variants pass 0.75-2.5
    nn_ratio: float = 0.8,
    check_rot: bool = False,
    ref_angle: jnp.ndarray | None = None,
):
    """Associate map points to frame keypoints.

    Returns (pt2kp (P,) int32 best keypoint per point or -1,
             kp2pt (N,) int32 point per keypoint or -1,
             uvr_pred (P, 3) predicted projections,
             in_frustum (P,) bool — the visibility mask that feeds
             MapPoint::IncreaseVisible stats (Tracking.cc:1613-1675)).

    One keypoint is assigned to at most one point (best distance wins),
    mirroring the matcher's mutual-exclusion bookkeeping.
    """
    scales = scale ** jnp.arange(n_levels, dtype=jnp.float32)
    log_scale = jnp.log(scale)

    Xc = se3.apply(T_cw, pts.pos)
    z = Xc[..., 2]
    uv_z = jnp.maximum(z, 1e-6)
    u = cam.fx * Xc[..., 0] / uv_z + cam.cx
    v = cam.fy * Xc[..., 1] / uv_z + cam.cy
    ur = u - cam.bf / uv_z
    # frustum gates (Frame.cc:333-388)
    T_wc = se3.inv(T_cw)
    cam_center = T_wc[..., :3, 3]
    PO = pts.pos - cam_center
    dist = jnp.linalg.norm(PO, axis=-1)
    viewcos = jnp.sum(PO * pts.normal, axis=-1) / jnp.maximum(dist, 1e-6)
    in_frustum = (
        pts.valid
        & (z > 0.0)
        & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
        & (dist >= pts.min_dist) & (dist <= pts.max_dist)
        & (viewcos > 0.5)
    )
    # max_dist carries the +20% gate slack (MapPoint::GetMaxDistanceInvariance,
    # MapPoint.cc:376-383); PredictScale uses the un-slacked mfMaxDistance.
    pred_oct = predict_octave(dist, pts.max_dist / 1.2, n_levels, log_scale)
    # radius: 2.5 px if viewcos > 0.998 else 4.0, x th x scale(pred_oct)
    r = jnp.where(viewcos > 0.998, 2.5, 4.0) * th * scales[pred_oct]

    # pairwise gates (P, N)
    du = jnp.abs(u[:, None] - frame.xy[None, :, 0])
    dv = jnp.abs(v[:, None] - frame.xy[None, :, 1])
    win = (du <= r[:, None]) & (dv <= r[:, None])
    oct_ok = (frame.octave[None, :] >= pred_oct[:, None] - 1) & (
        frame.octave[None, :] <= pred_oct[:, None]
    )
    # stereo right-u gate where the keypoint has a stereo match
    dur = jnp.abs(ur[:, None] - frame.ur[None, :])
    ur_ok = (frame.ur[None, :] < 0) | (dur <= r[:, None])
    cand = win & oct_ok & ur_ok & in_frustum[:, None] & frame.valid[None, :]

    best_kp, best, second, second_kp = hamming.masked_argmin(
        hamming.distance_matrix(pts.desc, frame.desc), cand)
    same_lvl = frame.octave[best_kp] == frame.octave[second_kp]
    ratio_ok = (~same_lvl) | (
        best.astype(jnp.float32) <= nn_ratio * second.astype(jnp.float32)
    )
    ok = (best <= hamming.TH_HIGH) & ratio_ok & in_frustum

    if check_rot and ref_angle is not None:
        rot_ok = hamming.rotation_consistency_mask(
            ref_angle, frame.angle, best_kp, ok
        )
        ok = ok & rot_ok

    # resolve keypoint conflicts: lowest distance per keypoint wins
    P, N = pts.desc.shape[0], frame.desc.shape[0]
    best_masked = jnp.where(ok, best, hamming.INF_DIST)
    kp_best_dist = (
        jnp.full((N,), hamming.INF_DIST, jnp.int32).at[best_kp].min(best_masked)
    )
    winner = ok & (best_masked == kp_best_dist[best_kp])
    # tie-break double winners by point index: keep lowest point index
    pidx = jnp.arange(P, dtype=jnp.int32)
    kp_winner_pt = (
        jnp.full((N,), P, jnp.int32).at[best_kp].min(jnp.where(winner, pidx, P))
    )
    winner = winner & (kp_winner_pt[best_kp] == pidx)

    pt2kp = jnp.where(winner, best_kp, -1)
    kp2pt = jnp.full((N,), -1, jnp.int32).at[best_kp].max(
        jnp.where(winner, pidx, -1)
    )
    uvr_pred = jnp.stack([u, v, ur], axis=-1)
    return pt2kp, kp2pt, uvr_pred, in_frustum


@partial(jax.jit, static_argnames=("radius", "nn_ratio"))
def search_for_initialization(
    f0: FrameFeatures,
    f1: FrameFeatures,
    radius: float = 100.0,
    nn_ratio: float = 0.9,
):
    """Windowed descriptor matching for monocular bootstrap
    (ORBmatcher::SearchForInitialization, reference src/ORBmatcher.cc:
    405-520): level-0 keypoints, +-radius window around the same image
    location, Hamming < TH_LOW with ratio test, mutual best.
    Returns (idx0to1 (N,) int32 or -1)."""
    from ..ops import hamming as ham

    win = (jnp.abs(f0.xy[:, None, 0] - f1.xy[None, :, 0]) <= radius) \
        & (jnp.abs(f0.xy[:, None, 1] - f1.xy[None, :, 1]) <= radius)
    # same octave (divergence: the reference restricts to level 0 only,
    # ORBmatcher.cc:416 — a CPU-pruning choice that starves the 100-match
    # bootstrap gate at moderate feature budgets; same-octave keeps the
    # scale consistency the H/F models need)
    lvl = f0.octave[:, None] == f1.octave[None, :]
    cand = win & lvl & f0.valid[:, None] & f1.valid[None, :]
    d = jnp.where(cand, ham.distance_matrix(f0.desc, f1.desc), ham.INF_DIST)
    best = jnp.argmin(d, axis=1)
    bd = jnp.take_along_axis(d, best[:, None], 1)[:, 0]
    d2 = d.at[jnp.arange(d.shape[0]), best].set(ham.INF_DIST)
    second = jnp.min(d2, axis=1)
    ok = (bd <= ham.TH_LOW) \
        & (bd.astype(jnp.float32) <= nn_ratio * second.astype(jnp.float32))
    # mutual
    best_t = jnp.argmin(d, axis=0)
    ok = ok & (best_t[best] == jnp.arange(d.shape[0]))
    ok = ok & ham.rotation_consistency_mask(f0.angle, f1.angle, best, ok)
    return jnp.where(ok, best, -1)


@partial(jax.jit, static_argnames=("cam", "n_levels", "scale", "radius"))
def match_last_frame(
    cam: StereoCamera,
    T_cw: jnp.ndarray,
    last: FrameFeatures,
    last_pt_pos: jnp.ndarray,
    last_has_pt: jnp.ndarray,
    cur: FrameFeatures,
    n_levels: int = 8,
    scale: float = 1.2,
    radius: float = 7.0,
):
    """Last-frame projection matching (ORBmatcher::SearchByProjection
    :1328-1470): project last frame's map points into the current frame with
    the predicted pose, search a radius*scale(octave) window with octave
    window [oct-1, oct+1], Hamming best under TH_HIGH, rotation-consistency
    histogram (top-3 bins).

    Returns (kp2last (N_cur,) int32 index into last frame or -1).
    """
    scales = scale ** jnp.arange(n_levels, dtype=jnp.float32)
    Xc = se3.apply(T_cw, last_pt_pos)
    z = jnp.maximum(Xc[..., 2], 1e-6)
    u = cam.fx * Xc[..., 0] / z + cam.cx
    v = cam.fy * Xc[..., 1] / z + cam.cy
    ur = u - cam.bf / z
    visible = (
        last_has_pt
        & last.valid
        & (Xc[..., 2] > 0)
        & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    )
    r = radius * scales[last.octave]
    du = jnp.abs(u[:, None] - cur.xy[None, :, 0])
    dv = jnp.abs(v[:, None] - cur.xy[None, :, 1])
    win = (du <= r[:, None]) & (dv <= r[:, None])
    oct_ok = jnp.abs(cur.octave[None, :] - last.octave[:, None]) <= 1
    dur = jnp.abs(ur[:, None] - cur.ur[None, :])
    ur_ok = (cur.ur[None, :] < 0) | (dur <= r[:, None])
    cand = win & oct_ok & ur_ok & visible[:, None] & cur.valid[None, :]

    dmat = hamming.distance_matrix(last.desc, cur.desc)
    d = jnp.where(cand, dmat, hamming.INF_DIST)
    best_kp = jnp.argmin(d, axis=1)
    best = jnp.take_along_axis(d, best_kp[:, None], axis=1)[:, 0]
    ok = best <= hamming.TH_HIGH
    ok = ok & hamming.rotation_consistency_mask(last.angle, cur.angle, best_kp, ok)

    # conflict resolution: best distance per current keypoint
    L = d.shape[0]
    N = d.shape[1]
    best_masked = jnp.where(ok, best, hamming.INF_DIST)
    kp_best = jnp.full((N,), hamming.INF_DIST, jnp.int32).at[best_kp].min(best_masked)
    winner = ok & (best_masked == kp_best[best_kp])
    lidx = jnp.arange(L, dtype=jnp.int32)
    kp_winner = jnp.full((N,), L, jnp.int32).at[best_kp].min(jnp.where(winner, lidx, L))
    winner = winner & (kp_winner[best_kp] == lidx)
    kp2last = jnp.full((N,), -1, jnp.int32).at[best_kp].max(jnp.where(winner, lidx, -1))
    return kp2last
