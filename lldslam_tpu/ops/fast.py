"""FAST-9/16 corner scoring as a dense vectorized map.

Replaces the per-cell `cv::FAST` calls of `ORBextractor::ComputeKeyPointsOctTree`
(reference src/ORBextractor.cc:769-829). Instead of branchy per-pixel early-out
code, we compute the FAST score for EVERY pixel as a fused elementwise program
(16 shifted images + log-depth circular window reductions), which XLA fuses
into a few memory-bound kernels. The threshold fallback (20 -> 7, ORBextractor.cc:789-799)
lives in selection (ops/orb._select_level_keypoints): scores are computed once
at the *minimum* threshold, and the per-cell gate keeps only >ini_th corners
in cells that have any, falling back to min_th detections where a cell has
none — the same two-tier outcome without a second detector pass.

Score definition: V(p) = max over all contiguous 9-arcs of
min_i(|I(c_i) - I(p)|) on the qualifying side — i.e. the maximum threshold at
which p is still a corner (the standard FAST score, same ranking as OpenCV's
cornerScore).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# Bresenham circle radius 3, 16 points in circular order, (dy, dx).
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _shift2d(img: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """img[y+dy, x+dx] with wrap (borders are masked out by callers)."""
    return jnp.roll(img, shift=(-dy, -dx), axis=(0, 1))


@partial(jax.jit, static_argnames=("threshold",))
def fast_score_map(img: jnp.ndarray, threshold: float = 7.0) -> jnp.ndarray:
    """(H, W) float32 -> (H, W) float32 FAST-9 score, 0 where not a corner.

    Borders (3 px) are zeroed.
    """
    p = img
    diffs = jnp.stack([_shift2d(img, dy, dx) - p for dy, dx in CIRCLE])  # (16,H,W)

    def arc9_min(d):
        # min over circular windows of length 9, via log-depth shifts
        w2 = jnp.minimum(d, jnp.roll(d, -1, axis=0))
        w4 = jnp.minimum(w2, jnp.roll(w2, -2, axis=0))
        w8 = jnp.minimum(w4, jnp.roll(w4, -4, axis=0))
        w9 = jnp.minimum(w8, jnp.roll(d, -8, axis=0))
        return jnp.max(w9, axis=0)  # best starting position

    bright = arc9_min(diffs)        # > t  => bright corner with score `bright`
    dark = arc9_min(-diffs)         # > t  => dark corner
    score = jnp.maximum(bright, dark)
    score = jnp.where(score > threshold, score, 0.0)
    # zero the 3-px border (circle reads wrapped values there)
    h, w = img.shape
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inside = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    return jnp.where(inside, score, 0.0)


@jax.jit
def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """3x3 non-maximum suppression with deterministic plateau tie-breaking.

    A pixel survives iff it is strictly greater than every *scan-order-earlier*
    neighbor and >= every later neighbor — on an equal-score plateau exactly
    the first pixel in scan order wins (matching cv2's effective behavior of
    one detection per plateau; plain `score == maxpool` keeps whole plateau
    chains, which destabilizes top-N selection).
    """
    earlier = [(-1, -1), (-1, 0), (-1, 1), (0, -1)]
    later = [(0, 1), (1, -1), (1, 0), (1, 1)]
    max_e = jnp.full_like(score, -jnp.inf)
    for dy, dx in earlier:
        max_e = jnp.maximum(max_e, _shift2d(score, dy, dx))
    max_l = jnp.full_like(score, -jnp.inf)
    for dy, dx in later:
        max_l = jnp.maximum(max_l, _shift2d(score, dy, dx))
    keep = (score > max_e) & (score >= max_l)
    return jnp.where(keep, score, 0.0)
