"""Frame construction: one jitted program per stereo pair.

Replaces the stereo `Frame::Frame` constructor (reference src/Frame.cc:76-161):
dual ORB extraction (the reference forks 2 threads, Frame.cc:101-104 — here
one batched kernel), stereo matching, and the feature bookkeeping the
pipeline needs. The 64x48 keypoint grid (Frame.cc:294) is not materialized:
projection matching uses dense masked distance matrices instead (matching.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry.camera import StereoCamera
from ..ops import image, orb, stereo
from .matching import FrameFeatures


class FrameData(NamedTuple):
    """Everything tracking needs from one stereo frame (device arrays)."""

    feats: FrameFeatures     # left keypoints + stereo ur
    depth: jnp.ndarray       # (N,) stereo depth or -1
    right: orb.Keypoints     # right keypoints (for line/stereo debugging)


@partial(jax.jit, static_argnames=("cfg",))
def build_frame_mono(img: jnp.ndarray,
                     cfg: orb.OrbConfig = orb.OrbConfig()) -> FrameData:
    """Monocular frame build (mono Frame constructor, Frame.cc:220-292):
    keypoints only; no stereo coordinate, no depth."""
    img = img.astype(jnp.float32)
    kp = orb.extract(img, cfg)
    n = kp.xy.shape[0]
    feats = FrameFeatures(
        xy=kp.xy, ur=jnp.full((n,), -1.0), octave=kp.octave,
        angle=kp.angle, desc=kp.desc, valid=kp.valid,
    )
    return FrameData(feats=feats, depth=jnp.full((n,), -1.0), right=kp)


@partial(jax.jit, static_argnames=("cam", "cfg"))
def build_frame_rgbd(
    img: jnp.ndarray,
    depthmap: jnp.ndarray,
    cam: StereoCamera,
    cfg: orb.OrbConfig = orb.OrbConfig(),
    depth_factor: float = 1.0,
) -> FrameData:
    """RGB-D frame build (the reference's RGB-D Frame constructor,
    Frame.cc:163-218 + ComputeStereoFromRGBD, Frame.cc:706-723): keypoints
    from the gray image, depth sampled from the registered depth map, and a
    virtual right coordinate ur = u - bf/z so the whole stereo pipeline
    applies unchanged."""
    img = img.astype(jnp.float32)
    kp = orb.extract(img, cfg)
    dm = depthmap.astype(jnp.float32) * depth_factor
    h, w = dm.shape
    xi = jnp.clip(jnp.round(kp.xy[:, 0]).astype(jnp.int32), 0, w - 1)
    yi = jnp.clip(jnp.round(kp.xy[:, 1]).astype(jnp.int32), 0, h - 1)
    z = dm[yi, xi]
    has_d = (z > 0.0) & kp.valid
    ur = jnp.where(has_d, kp.xy[:, 0] - cam.bf / jnp.maximum(z, 1e-6), -1.0)
    depth = jnp.where(has_d, z, -1.0)
    feats = FrameFeatures(
        xy=kp.xy, ur=ur, octave=kp.octave, angle=kp.angle,
        desc=kp.desc, valid=kp.valid,
    )
    return FrameData(feats=feats, depth=depth, right=kp)


@jax.jit
def pack_frame(fd: FrameData) -> jnp.ndarray:
    """Flatten the host-bound keyframe snapshot (left features + depth) into
    ONE int32 buffer: one device->host transfer at keyframe rate instead of
    six."""
    f = fd.feats
    bc = lambda a: jax.lax.bitcast_convert_type(a, jnp.int32)
    return jnp.concatenate([
        bc(f.xy.reshape(-1)), bc(f.ur), bc(f.angle), bc(fd.depth),
        f.octave, bc(f.desc.reshape(-1)), f.valid.astype(jnp.int32),
    ])


def unpack_frame_np(buf: np.ndarray, n: int):
    """Inverse of pack_frame on host. Returns (feats dict, depth)."""
    o = 0
    xy = buf[o:o + 2 * n].view(np.float32).reshape(n, 2); o += 2 * n
    ur = buf[o:o + n].view(np.float32); o += n
    angle = buf[o:o + n].view(np.float32); o += n
    depth = buf[o:o + n].view(np.float32); o += n
    octave = buf[o:o + n]; o += n
    desc = buf[o:o + 8 * n].view(np.uint32).reshape(n, 8); o += 8 * n
    valid = buf[o:o + n].astype(bool)
    feats = dict(xy=xy, ur=ur, octave=octave, angle=angle, desc=desc,
                 valid=valid)
    return feats, depth


def build_frame(
    img_l: jnp.ndarray,
    img_r: jnp.ndarray,
    cam: StereoCamera,
    cfg: orb.OrbConfig = orb.OrbConfig(),
) -> FrameData:
    """Compatibility wrapper over `build_frame_pair` for separate L/R
    arrays; prefer staging ONE stacked (2, H, W) upload per frame."""
    return build_frame_pair(jnp.stack([jnp.asarray(img_l),
                                       jnp.asarray(img_r)]), cam, cfg)


@partial(jax.jit, static_argnames=("cam", "cfg"))
def build_frame_pair(
    pair: jnp.ndarray,                  # (2, H, W) uint8/float stacked L,R
    cam: StereoCamera,
    cfg: orb.OrbConfig = orb.OrbConfig(),
) -> FrameData:
    # accept uint8 frames: callers upload 1 byte/px host->device and the
    # cast runs on device. The pyramid is integer-quantized per level (the
    # reference's pyramid IS uint8, ORBextractor.cc:1063-1084) and carried
    # in bfloat16 — integers <= 255 are exact in bf16, and image-sized
    # frontend ops are memory-bound, so half the bytes (kept until the GPU
    # trace says whether it pays, ROADMAP Design). Reductions that need
    # precision cast up internally: blur accumulates f32, IC-angle is
    # exact int32, SAD costs accumulate f32.
    stack = pair.astype(jnp.float32)                          # (2, H, W)
    # ONE pyramid program for both views, shared with the stereo SAD
    # refinement; extraction vmapped over the pair (the reference forks two
    # threads here, Frame.cc:101-104 — batching is the device equivalent)
    pyr = image.build_pyramid(stack, cfg.n_levels, cfg.scale, quantize=True)
    kp_both = orb.extract_stack_pyr(tuple(pyr), cfg)
    kp_l = jax.tree.map(lambda a: a[0], kp_both)
    kp_r = jax.tree.map(lambda a: a[1], kp_both)
    pyr_l = [p[0] for p in pyr]
    pyr_r = [p[1] for p in pyr]
    u_right, depth = stereo.match_stereo(kp_l, kp_r, pyr_l, pyr_r, cam, cfg)
    feats = FrameFeatures(
        xy=kp_l.xy,
        ur=u_right,
        octave=kp_l.octave,
        angle=kp_l.angle,
        desc=kp_l.desc,
        valid=kp_l.valid,
    )
    return FrameData(feats=feats, depth=depth, right=kp_r)
