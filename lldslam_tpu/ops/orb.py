"""Batched ORB keypoint extraction: pyramid FAST + orientation + rotated BRIEF.

Batched device replacement for `ORBextractor` (reference src/ORBextractor.cc):
- dense FAST score map per level (fast.py) instead of per-cell cv::FAST calls
  (ORBextractor.cc:769-829),
- spatial distribution via per-cell top-k + global per-level top-n, a batched
  approximation of the quadtree `DistributeOctTree` (ORBextractor.cc:539) with
  the same goal (cap per region, keep strongest),
- IC_Angle intensity-centroid orientation over the radius-15 circular patch
  (ORBextractor.cc:77-104) as a masked patch-gather reduction,
- 7x7 sigma=2 Gaussian blur + the standard 256-pair rotated BRIEF pattern
  (ORBextractor.cc:108-147; pattern table as data in orb_pattern.npy) packed
  into 8 uint32 words per keypoint,
- per-level feature budget split geometrically (ORBextractor.cc:435-446) and
  coordinates rescaled to level 0 (ORBextractor.cc:1095-1101).

Everything lives in one jitted function with static shapes; invalid slots are
masked, never branched on.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import fast, image

EDGE_MARGIN = 16  # detection border, EDGE_THRESHOLD-3 (ORBextractor.cc:74,779)

_PATTERN = np.load(Path(__file__).parent / "orb_pattern.npy")  # (256, 2, 2) int32


def _umax_mask() -> np.ndarray:
    """31x31 boolean mask of the IC_Angle circular patch, built exactly like
    the reference's umax table (ORBextractor.cc:452-468)."""
    HALF = 15
    umax = np.zeros(HALF + 2, dtype=np.int32)
    vmax = int(math.floor(HALF * math.sqrt(2.0) / 2 + 1))
    vmin = int(math.ceil(HALF * math.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(math.sqrt(HALF * HALF - v * v)))
    v0 = 0
    for v in range(HALF, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    ys, xs = np.mgrid[-HALF : HALF + 1, -HALF : HALF + 1]
    return np.abs(xs) <= umax[np.abs(ys)]


_IC_MASK = _umax_mask()  # (31, 31) bool


@dataclass(frozen=True)
class OrbConfig:
    """ORBextractor.{nFeatures,scaleFactor,nLevels,iniThFAST,minThFAST}
    (config inventory SURVEY.md §5.6; Tracking.cc:126-130)."""

    n_features: int = 2000
    n_levels: int = 8
    scale: float = 1.2
    ini_th: float = 20.0
    min_th: float = 7.0
    cell: int = 30          # detection cell size in px (ORBextractor.cc:790 W=30)
    cell_k: int = 4         # candidates kept per cell before global top-n

    def per_level_budget(self):
        """Geometric split of n_features over levels (ORBextractor.cc:435-446)."""
        factor = 1.0 / self.scale
        n0 = self.n_features * (1 - factor) / (1 - factor**self.n_levels)
        out = []
        acc = 0
        for l in range(self.n_levels - 1):
            n = int(round(n0 * factor**l))
            out.append(n)
            acc += n
        out.append(max(self.n_features - acc, 0))
        return out

    def scale_factors(self):
        return [self.scale**l for l in range(self.n_levels)]

    @property
    def max_kp(self) -> int:
        total = sum(self.per_level_budget())
        return ((total + 127) // 128) * 128


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set (one frame, one camera). Invalid slots are
    masked by `valid`; coords are level-0 pixels."""

    xy: jnp.ndarray        # (N, 2) float32 (x, y)
    response: jnp.ndarray  # (N,) float32
    octave: jnp.ndarray    # (N,) int32
    angle: jnp.ndarray     # (N,) float32 radians
    desc: jnp.ndarray      # (N, 8) uint32 packed 256-bit BRIEF
    valid: jnp.ndarray     # (N,) bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]


def _select_level_keypoints(score: jnp.ndarray, n_out: int, cfg: OrbConfig):
    """Spatially-uniform selection: per-cell top-k (k ~= budget/cells) then
    global top-n. Returns (xy int32 (n,2), score (n,)) with zero-score invalid
    slots.

    Keeping k near budget/cells makes selection a *local* contest (strongest
    corner per 30-px window), which is stable across views — the point of the
    reference's quadtree DistributeOctTree (ORBextractor.cc:539). A global
    top-n over many candidates is rank-unstable under subpixel shifts and
    destroys stereo/temporal repeatability (measured: median counterpart
    distance 11 px global vs ~1 px per-cell on a shifted synthetic pair).

    Two-tier FAST threshold (ORBextractor.cc:769-829): the score map is
    computed once at `min_th` (the FAST score IS the max threshold at which
    the pixel is still a corner), and per cell we keep only corners stronger
    than `ini_th` unless the cell has none — then the whole cell falls back
    to its `min_th` detections. Identical outcome to the reference's
    detect-at-20-retry-at-7 per-cell loop, without a second detector pass.
    """
    h, w = score.shape
    c = cfg.cell
    ch, cw = -(-h // c), -(-w // c)
    pad = jnp.pad(score, ((0, ch * c - h), (0, cw * c - w)))
    cells = pad.reshape(ch, c, cw, c).transpose(0, 2, 1, 3).reshape(ch, cw, c * c)
    if cfg.ini_th > cfg.min_th:
        strong_cell = jnp.max(cells, axis=-1, keepdims=True) > cfg.ini_th
        cells = jnp.where(strong_cell & (cells <= cfg.ini_th), 0.0, cells)
    k = min(max(1, -(-n_out // (ch * cw))) + 1, cfg.cell_k, c * c)
    # per-cell best-k by k rounds of (max, argmax, mask) — k is tiny (<= 4),
    # so this beats lax.top_k's full bitonic sort over the 900-wide cell axis
    lanes = jax.lax.broadcasted_iota(jnp.int32, cells.shape, 2)
    vs, ids = [], []
    rest = cells
    for _ in range(k):
        a = jnp.argmax(rest, axis=-1)                       # (ch, cw)
        v = jnp.max(rest, axis=-1)
        vs.append(v)
        ids.append(a.astype(jnp.int32))
        rest = jnp.where(lanes == a[..., None], -jnp.inf, rest)
    cell_scores = jnp.stack(vs, axis=-1)                    # (ch, cw, k)
    cell_idx = jnp.stack(ids, axis=-1)
    cy = jax.lax.broadcasted_iota(jnp.int32, (ch, cw, k), 0)
    cx = jax.lax.broadcasted_iota(jnp.int32, (ch, cw, k), 1)
    ys = cy * c + cell_idx // c
    xs = cx * c + cell_idx % c
    flat_s = cell_scores.reshape(-1)
    flat_y = ys.reshape(-1)
    flat_x = xs.reshape(-1)
    n = min(n_out, flat_s.shape[0])
    top_s, top_i = jax.lax.top_k(flat_s, n)
    xy = jnp.stack([flat_x[top_i], flat_y[top_i]], axis=-1)
    if n < n_out:
        xy = jnp.pad(xy, ((0, n_out - n), (0, 0)))
        top_s = jnp.pad(top_s, (0, n_out - n))
    return xy, top_s


def _ic_angle(img: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid orientation (IC_Angle, ORBextractor.cc:77-104).
    xy (n, 2) int32 level coords -> (n,) radians.

    Moment maps m10/m01 over the radius-15 circular patch are computed from
    per-row prefix sums: for each dy the row-window sum over
    dx in [-u, u] (u = umax(|dy|)) is a difference of two statically shifted
    prefix slices. ~31x6 elementwise ops/pixel, all fusable — instead of a
    31x31x2 `conv_general_dilated` over a 1-channel image, a shape
    convolution libraries handle poorly.

    All prefix arithmetic is EXACT int32: the level image is rounded to
    integers (the reference computes IC_Angle on uint8 level images,
    ORBextractor.cc:1107-1132) and shifted by -128, so |row prefix| stays
    well inside int32 at KITTI widths. The earlier f32-cumsum version lost
    bits to windowed-difference cancellation at large x (f32 ulp is 1-8 at
    prefix magnitudes of 1e7-1e8), adding orientation noise on low-texture
    patches."""
    h, w = img.shape
    HALF = 15
    # per-|dy| row half-widths of the circular mask (umax, ORBextractor.cc:452)
    umax = _IC_MASK[HALF:].sum(axis=1) // 2  # (16,) ints, index |dy|
    I = jnp.round(img).astype(jnp.int32) - 128
    xc = jnp.arange(w, dtype=jnp.int32)
    # prefix sums along x with a leading zero column: P[y, x] = sum I[y, :x]
    z = jnp.zeros((h, 1), jnp.int32)
    P0 = jnp.concatenate([z, jnp.cumsum(I, axis=1)], axis=1)          # (h, w+1)
    P1 = jnp.concatenate([z, jnp.cumsum(I * xc[None, :], axis=1)], axis=1)
    # pad so row y+dy and cols x+-u are always in range (keypoints never
    # touch the border: EDGE_MARGIN=16 > HALF)
    P0p = jnp.pad(P0, ((HALF, HALF), (HALF, HALF)))
    P1p = jnp.pad(P1, ((HALF, HALF), (HALF, HALF)))
    m10 = jnp.zeros((h, w), jnp.int32)
    m01 = jnp.zeros((h, w), jnp.int32)
    for dy in range(-HALF, HALF + 1):
        u = int(umax[abs(dy)])
        r0 = HALF + dy
        # row-window sum S0(y,x) = P0[y+dy, x+u+1] - P0[y+dy, x-u]
        hi0 = jax.lax.dynamic_slice(P0p, (r0, HALF + u + 1), (h, w))
        lo0 = jax.lax.dynamic_slice(P0p, (r0, HALF - u), (h, w))
        S0 = hi0 - lo0
        hi1 = jax.lax.dynamic_slice(P1p, (r0, HALF + u + 1), (h, w))
        lo1 = jax.lax.dynamic_slice(P1p, (r0, HALF - u), (h, w))
        S1 = hi1 - lo1
        # x-moment about each pixel's own column (exact int32: the windowed
        # sums are bounded by 128 * 31 px * 15 offset per band)
        m10 = m10 + (S1 - xc[None, :] * S0)
        m01 = m01 + dy * S0
    g10 = m10[xy[:, 1], xy[:, 0]]
    g01 = m01[xy[:, 1], xy[:, 0]]
    return jnp.arctan2(g01.astype(jnp.float32), g10.astype(jnp.float32))


def _rotated_taps(xy: jnp.ndarray, angle: jnp.ndarray, h: int, w: int):
    """Rotated-BRIEF tap coordinates (GET_VALUE, ORBextractor.cc:108-147):
    (gy, gx) each (n, 256, 2) int32, clipped into the image."""
    pat = jnp.asarray(_PATTERN, jnp.float32)  # (256, 2, 2) [(a,b), (x,y)]
    ca, sa = jnp.cos(angle), jnp.sin(angle)  # (n,)
    px = pat[None, :, :, 0]  # (1, 256, 2)
    py = pat[None, :, :, 1]
    # rotation as in GET_VALUE: x' = x cos - y sin, y' = x sin + y cos
    rx = jnp.round(px * ca[:, None, None] - py * sa[:, None, None]).astype(jnp.int32)
    ry = jnp.round(px * sa[:, None, None] + py * ca[:, None, None]).astype(jnp.int32)
    gx = jnp.clip(xy[:, None, None, 0] + rx, 0, w - 1)  # (n, 256, 2)
    gy = jnp.clip(xy[:, None, None, 1] + ry, 0, h - 1)
    return gy, gx


def _pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """(n, 256) {0,1} -> (n, 8) packed uint32."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    words = jnp.sum(bits.astype(jnp.uint32).reshape(-1, 8, 32)
                    << shifts[None, None, :], axis=-1)
    return words.astype(jnp.uint32)


def _brief_desc(blur: jnp.ndarray, xy: jnp.ndarray, angle: jnp.ndarray) -> jnp.ndarray:
    """Rotated BRIEF-256 on the blurred level image (computeOrbDescriptor,
    ORBextractor.cc:108-147). Returns (n, 8) uint32: one (n, 256, 2) gather
    of the clipped tap coordinates, then a pairwise compare."""
    h, w = blur.shape
    gy, gx = _rotated_taps(xy, angle, h, w)
    vals = blur[gy, gx]  # (n, 256, 2)
    return _pack_bits(vals[..., 0] < vals[..., 1])


@partial(jax.jit, static_argnames=("cfg",))
def extract(img: jnp.ndarray, cfg: OrbConfig = OrbConfig()) -> Keypoints:
    """Full ORB extraction for one grayscale float32 image (H, W)."""
    pyr = image.build_pyramid(img, cfg.n_levels, cfg.scale)
    return extract_pyr(tuple(pyr), cfg)


@partial(jax.jit, static_argnames=("cfg",))
def extract_pyr(pyr, cfg: OrbConfig = OrbConfig()) -> Keypoints:
    """ORB extraction from a prebuilt pyramid (tuple of (H_l, W_l) arrays).
    Lets the frame builder share one pyramid between extraction and stereo
    refinement, and vmap left+right into a single batched program."""
    budgets = cfg.per_level_budget()
    scales = cfg.scale_factors()
    parts = []
    for l, (im_l, n_l, s_l) in enumerate(zip(pyr, budgets, scales)):
        score = fast.nms3x3(fast.fast_score_map(im_l, cfg.min_th))
        h, w = im_l.shape
        ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        inside = (
            (ys >= EDGE_MARGIN)
            & (ys < h - EDGE_MARGIN)
            & (xs >= EDGE_MARGIN)
            & (xs < w - EDGE_MARGIN)
        )
        score = jnp.where(inside, score, 0.0)
        xy_l, resp = _select_level_keypoints(score, n_l, cfg)
        ang = _ic_angle(im_l, xy_l)
        # Round the blur to integers: the oracle blurs uint8->uint8, and BRIEF
        # compares values — rounding gives bit-exact descriptor parity with
        # cv2.ORB (measured mean Hamming 0.0 at identical keypoints).
        blur = jnp.round(image.gaussian_blur(im_l))
        desc = _brief_desc(blur, xy_l, ang)
        valid = resp > 0
        xy0 = xy_l.astype(jnp.float32) * s_l
        parts.append(
            (
                xy0,
                resp,
                jnp.full((n_l,), l, jnp.int32),
                ang,
                desc,
                valid,
            )
        )
    xy = jnp.concatenate([p[0] for p in parts])
    resp = jnp.concatenate([p[1] for p in parts])
    octv = jnp.concatenate([p[2] for p in parts])
    ang = jnp.concatenate([p[3] for p in parts])
    desc = jnp.concatenate([p[4] for p in parts])
    valid = jnp.concatenate([p[5] for p in parts])
    n, cap = xy.shape[0], cfg.max_kp
    if n < cap:
        pad = cap - n
        xy = jnp.pad(xy, ((0, pad), (0, 0)))
        resp = jnp.pad(resp, (0, pad))
        octv = jnp.pad(octv, (0, pad))
        ang = jnp.pad(ang, (0, pad))
        desc = jnp.pad(desc, ((0, pad), (0, 0)))
        valid = jnp.pad(valid, (0, pad))
    return Keypoints(xy, resp, octv, ang, desc, valid)


extract_pair = jax.jit(
    jax.vmap(extract, in_axes=(0, None)), static_argnames=("cfg",)
)


@partial(jax.jit, static_argnames=("cfg",))
def extract_stack_pyr(pyr, cfg: OrbConfig = OrbConfig()) -> Keypoints:
    """ORB extraction for a STACK of same-shape views per level
    (pyr: tuple of (V, H_l, W_l) arrays — V=2 for a stereo pair).

    Identical math to `vmap(extract_pyr)`; the blurred level is stored at
    the pyramid dtype before the BRIEF gather. Returns Keypoints with
    leading dim V.
    """
    V = pyr[0].shape[0]
    budgets = cfg.per_level_budget()
    scales = cfg.scale_factors()
    parts = []
    for l, (im_l, n_l, s_l) in enumerate(zip(pyr, budgets, scales)):
        _, h, w = im_l.shape
        score = jax.vmap(lambda a: fast.nms3x3(fast.fast_score_map(a, cfg.min_th)))(im_l)
        ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        inside = (
            (ys >= EDGE_MARGIN)
            & (ys < h - EDGE_MARGIN)
            & (xs >= EDGE_MARGIN)
            & (xs < w - EDGE_MARGIN)
        )
        score = jnp.where(inside[None], score, 0.0)
        xy_l, resp = jax.vmap(lambda s: _select_level_keypoints(s, n_l, cfg))(score)
        ang = jax.vmap(_ic_angle)(im_l, xy_l)
        # blur accumulates in f32 (weights promote), rounds to integers
        # <= 255, then stores back at the pyramid dtype (ints exact in bf16)
        blur = jnp.round(jax.vmap(image.gaussian_blur)(im_l)) \
            .astype(im_l.dtype)
        desc = jax.vmap(_brief_desc)(blur, xy_l, ang)
        valid = resp > 0
        xy0 = xy_l.astype(jnp.float32) * s_l
        parts.append((xy0, resp, jnp.full((V, n_l), l, jnp.int32), ang,
                      desc, valid))
    xy = jnp.concatenate([p[0] for p in parts], axis=1)
    resp = jnp.concatenate([p[1] for p in parts], axis=1)
    octv = jnp.concatenate([p[2] for p in parts], axis=1)
    ang = jnp.concatenate([p[3] for p in parts], axis=1)
    desc = jnp.concatenate([p[4] for p in parts], axis=1)
    valid = jnp.concatenate([p[5] for p in parts], axis=1)
    n, cap = xy.shape[1], cfg.max_kp
    if n < cap:
        pad = cap - n
        xy = jnp.pad(xy, ((0, 0), (0, pad), (0, 0)))
        resp = jnp.pad(resp, ((0, 0), (0, pad)))
        octv = jnp.pad(octv, ((0, 0), (0, pad)))
        ang = jnp.pad(ang, ((0, 0), (0, pad)))
        desc = jnp.pad(desc, ((0, 0), (0, pad), (0, 0)))
        valid = jnp.pad(valid, ((0, 0), (0, pad)))
    return Keypoints(xy, resp, octv, ang, desc, valid)
