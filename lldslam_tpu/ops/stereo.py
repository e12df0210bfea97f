"""Stereo keypoint matching: row-banded Hamming argmin + subpixel SAD parabola.

Replaces `Frame::ComputeStereoMatches` (reference src/Frame.cc:530-704):
- candidates: right keypoints whose row is within +-2 * scale(octave) of the
  left keypoint's row (Frame.cc:552-565) and whose disparity lies in
  [minD, maxD] = [0, bf/b_min] (Frame.cc:572-574: minZ = baseline),
- best Hamming match under TH_HIGH (Frame.cc:600-613, th = ORBmatcher::TH_HIGH),
- subpixel refinement: 11x11 SAD over a +-5 disparity sweep on the octave-level
  images around the matched pair, parabola fit over the best 3 (Frame.cc:615-687),
- outlier sweep by 2x median SAD cost kept as a mask (Frame.cc:689-704).

Output: per-left-keypoint `u_right` (level-0 coords, subpixel) and `depth`,
with -1 sentinels, exactly the convention of `Frame::mvuRight`/`mvDepth`.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..geometry.camera import StereoCamera
from . import hamming
from .orb import Keypoints, OrbConfig


def gather_windows(ul, vl, ur, octave, pyr_l, pyr_r, W: int, L: int):
    """SAD window extraction at each keypoint's octave: returns
    (patch (n, 2W+1, 2W+1) from the left level image around (ul, vl),
    strip (n, 2W+1, 2W+1+2L) from the right level image around (ur, vl)).

    ul/vl/ur are integer level coordinates; taps are clipped into the
    keypoint's own level, so border keypoints repeat edge pixels. One gather
    from a level-stacked (levels, H0, W0) pyramid serves every octave."""
    H0, W0 = pyr_l[0].shape
    stk_l = jnp.stack([jnp.pad(p, ((0, H0 - p.shape[0]), (0, W0 - p.shape[1])))
                       for p in pyr_l])  # (levels, H0, W0)
    stk_r = jnp.stack([jnp.pad(p, ((0, H0 - p.shape[0]), (0, W0 - p.shape[1])))
                       for p in pyr_r])
    lh = jnp.asarray([p.shape[0] for p in pyr_l], jnp.int32)
    lw = jnp.asarray([p.shape[1] for p in pyr_l], jnp.int32)
    lvl = jnp.clip(octave, 0, len(pyr_l) - 1)
    hk = lh[lvl]  # (n,) per-keypoint level dims
    wk = lw[lvl]

    oy = jnp.arange(-W, W + 1)
    ox_p = jnp.arange(-W, W + 1)
    ox_s = jnp.arange(-W - L, W + L + 1)
    yy = jnp.clip(vl[:, None] + oy[None, :], 0, hk[:, None] - 1)    # (n, 2W+1)
    xxp = jnp.clip(ul[:, None] + ox_p[None, :], 0, wk[:, None] - 1)
    xxs = jnp.clip(ur[:, None] + ox_s[None, :], 0, wk[:, None] - 1)
    l3 = lvl[:, None, None]
    patch = stk_l[l3, yy[:, :, None], xxp[:, None, :]]
    strip = stk_r[l3, yy[:, :, None], xxs[:, None, :]]
    return patch, strip


@partial(jax.jit, static_argnames=("cfg", "cam"))
def match_stereo(
    kp_l: Keypoints,
    kp_r: Keypoints,
    pyr_l,
    pyr_r,
    cam: StereoCamera,
    cfg: OrbConfig = OrbConfig(),
):
    """Returns (u_right (N,), depth (N,)) float32 with -1 for unmatched.

    pyr_l / pyr_r: image pyramids (lists) of the two views, used for the
    subpixel SAD refinement at each keypoint's octave.
    """
    scales = jnp.asarray(cfg.scale_factors(), jnp.float32)
    sl = scales[kp_l.octave]
    # --- candidate gating (row band, octave band, disparity range) ---
    row_tol = 2.0 * sl  # 2 * scale of the left kp's octave (Frame.cc:552)
    dv = jnp.abs(kp_l.xy[:, 1:2] - kp_r.xy[None, :, 1])
    row_ok = dv <= row_tol[:, None]
    oct_ok = (
        jnp.abs(kp_l.octave[:, None] - kp_r.octave[None, :]) <= 1
    )  # Frame.cc:560: octave within [octL-1, octL+1]
    min_d = 0.0
    max_d = cam.bf / cam.baseline  # minZ = baseline (Frame.cc:572-574)
    disp = kp_l.xy[:, 0:1] - kp_r.xy[None, :, 0]
    disp_ok = (disp >= min_d) & (disp <= max_d)
    cand = row_ok & oct_ok & disp_ok

    idx, ok, dist = hamming.match_descriptors(
        kp_l.desc, kp_l.valid, kp_r.desc, kp_r.valid,
        max_dist=hamming.TH_HIGH, cand_mask=cand, mutual=False,
    )

    # --- subpixel SAD refinement on the octave-level images ---
    # Work at the left keypoint's octave: scaled coords.
    W = 5  # half window (11x11, Frame.cc:622)
    L = 5  # disparity sweep +-5 (Frame.cc:627)
    u_r0 = kp_r.xy[idx, 0]
    inv_s = 1.0 / sl
    ul = jnp.round(kp_l.xy[:, 0] * inv_s).astype(jnp.int32)
    vl = jnp.round(kp_l.xy[:, 1] * inv_s).astype(jnp.int32)
    ur = jnp.round(u_r0 * inv_s).astype(jnp.int32)

    patch, strip = gather_windows(ul, vl, ur, kp_l.octave, pyr_l, pyr_r,
                                  W, L)
    # center-subtract both (Frame.cc:624,644: IL - IL(center))
    patch_c = patch - patch[:, W, W][:, None, None]
    costs = []
    for d in range(2 * L + 1):
        win = jax.lax.dynamic_slice_in_dim(strip, d, 2 * W + 1, axis=2)
        win_c = win - win[:, W, W][:, None, None]
        costs.append(jnp.sum(jnp.abs(patch_c - win_c), axis=(1, 2)))
    sad = jnp.stack(costs, axis=-1)  # (n, 2L+1)

    best_d = jnp.argmin(sad, axis=-1)
    best_c = jnp.take_along_axis(sad, best_d[:, None], axis=-1)[:, 0]
    interior = (best_d > 0) & (best_d < 2 * L)
    cm1 = jnp.take_along_axis(sad, jnp.maximum(best_d - 1, 0)[:, None], axis=-1)[:, 0]
    cp1 = jnp.take_along_axis(sad, jnp.minimum(best_d + 1, 2 * L)[:, None], axis=-1)[:, 0]
    denom = jnp.maximum(2.0 * (cm1 + cp1 - 2.0 * best_c), 1e-6)
    delta = (cm1 - cp1) / denom  # parabola vertex offset (Frame.cc:659-663)
    delta = jnp.clip(jnp.where(interior, delta, 0.0), -1.0, 1.0)
    # refined right-u at octave scale -> level-0 coords (Frame.cc:665-668)
    u_r_ref = (ur.astype(jnp.float32) + (best_d - L).astype(jnp.float32) + delta) * sl

    disparity = kp_l.xy[:, 0] - u_r_ref
    ok = ok & (disparity > 1e-3) & (disparity <= max_d)
    # median-SAD outlier sweep (Frame.cc:689-704): cost <= 2 * median(cost)
    valid_costs = jnp.where(ok, best_c, jnp.nan)
    med = jnp.nanmedian(valid_costs)
    ok = ok & (best_c <= 2.0 * jnp.where(jnp.isnan(med), jnp.inf, med))

    depth = jnp.where(ok, cam.bf / jnp.maximum(disparity, 1e-6), -1.0)
    u_right = jnp.where(ok, u_r_ref, -1.0)
    return u_right, depth
