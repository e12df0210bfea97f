"""Image-level ops: pyramid construction and Gaussian blur, batched-friendly.

Replaces `ORBextractor::ComputePyramid` (reference src/ORBextractor.cc:1107-1132:
8 levels, scale 1.2, bilinear resize) and the 7x7 sigma=2 GaussianBlur before
descriptor extraction (ORBextractor.cc:1082-1090).

All functions are shape-static per level: the pyramid is a Python list of
arrays whose shapes are computed at trace time from the base shape, which is
exactly how XLA wants it (one fused program per level).
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float):
    """Static per-level (H, W) list, matching mvScaleFactor rounding
    (ORBextractor.cc:1112-1114: round(H/scale^l))."""
    return [
        (int(round(h / scale**l)), int(round(w / scale**l))) for l in range(n_levels)
    ]


def build_pyramid(img: jnp.ndarray, n_levels: int, scale: float,
                  quantize: bool = False):
    """img (..., H, W) float32 -> list of n_levels arrays, bilinear
    downsample. Leading batch dims pass through (the stereo frontend stacks
    left+right into one (2, H, W) program, one launch for both views).

    `quantize`: round every level to integer intensities, mirroring the
    reference's uint8 pyramid (cv2.resize into mvImagePyramid,
    ORBextractor.cc:1063-1084 — each level IS uint8 there). Integer levels
    are exact in bfloat16, which lets the frame build carry the pyramid at
    half the device-memory bytes (image-sized frontend ops are memory-bound)
    without introducing cross-view quantization noise beyond what the
    reference itself has."""
    h, w = img.shape[-2:]
    batch = img.shape[:-2]
    shapes = pyramid_shapes(h, w, n_levels, scale)
    out = [jnp.round(img).astype(jnp.bfloat16) if quantize else img]
    for l in range(1, n_levels):
        # Resize from the previous level (as the reference does), not from L0.
        nxt = jax.image.resize(out[-1].astype(img.dtype), batch + shapes[l],
                               method="linear", antialias=False)
        out.append(jnp.round(nxt).astype(jnp.bfloat16) if quantize else nxt)
    return out


def _gauss_kernel(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    x = np.arange(ksize) - (ksize - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


@partial(jax.jit, static_argnames=("ksize", "sigma"))
def gaussian_blur(img: jnp.ndarray, ksize: int = 7, sigma: float = 2.0) -> jnp.ndarray:
    """Separable Gaussian blur with BORDER_REFLECT_101 (OpenCV default),
    matching the descriptor pre-blur at ORBextractor.cc:1086."""
    k = jnp.asarray(_gauss_kernel(ksize, sigma))
    r = ksize // 2
    p = jnp.pad(img, ((r, r), (0, 0)), mode="reflect")
    # Vertical pass via shifted adds (XLA fuses this into one loop).
    v = jnp.zeros_like(img)
    for i in range(ksize):
        v = v + k[i] * jax.lax.dynamic_slice_in_dim(p, i, img.shape[0], axis=0)
    p = jnp.pad(v, ((0, 0), (r, r)), mode="reflect")
    o = jnp.zeros_like(img)
    for i in range(ksize):
        o = o + k[i] * jax.lax.dynamic_slice_in_dim(p, i, img.shape[1], axis=1)
    return o


def to_gray_f32(img: np.ndarray) -> np.ndarray:
    """Host-side: uint8 gray or BGR -> float32 gray in [0, 255]
    (cvtColor step, Tracking.cc:194-219). Host does IO only."""
    if img.ndim == 3:
        # OpenCV BGR weights
        img = (
            0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2]
        )
    return np.asarray(img, dtype=np.float32)
