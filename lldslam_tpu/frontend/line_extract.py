"""Line segment detection + band descriptors as batched device programs.

Replaces the external LBDMOD library (reference consumes it through
`LineExtractor::ExtractLines(im, keylines, descs)` — SURVEY.md §0.1;
the library itself is LSD/EDLines detection + LBD float descriptors).

Detector: gradient-aligned Hough transform — every edge pixel votes only
into the (rho, phi) bin of its own gradient orientation, the accumulator is
NMS'd and the top-K peaks become segments whose extent is the robust span of
supporting edge pixels along the line. One batched device program: Sobel ->
vote scatter -> peak top-k -> (K x pixels) masked span reduction. This is an
accelerator-shaped reformulation, not a port: LSD's sequential region growing has no
efficient XLA form, while Hough voting and masked reductions map onto it
directly.

Descriptor: LBD-style Line Band Descriptor (Zhang & Koch 2013, the LBDFloat
type of the reference config) — gradients sampled on a (samples x offsets)
grid in the line frame, band-pooled means/stds of the 4 half-wave gradient
channels, L2-normalized float vector compared by L2 distance
(MapLine.cc:175, `mdThr` gate Tracking.cc:1092).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class LineDetConfig:
    max_lines: int = 64
    rho_res: float = 2.0          # Hough distance resolution (px)
    n_phi: int = 120              # angle bins over [0, pi)
    mag_factor: float = 4.0       # edge threshold = factor * mean |grad|
    min_len: float = 25.0         # `minLineLen` (KITTI04-12_LBD.yaml:72)
    min_support: float = 12.0     # minimum accumulated vote mass
    band_samples: int = 24        # descriptor samples along the line
    band_offsets: int = 15        # perpendicular offsets (-7..7 px)
    n_bands: int = 5
    desc_dim: int = 40            # n_bands * 8
    desc_thr: float = 0.6         # native-descriptor match gate (the
                                  # reference's mdThr=2.0 is on LBDMOD's
                                  # unnormalized LBD scale)


class KeyLines(NamedTuple):
    """Fixed-capacity detected 2D segments (one image)."""

    p1: jnp.ndarray       # (L, 2) endpoint (x, y), level-0 px
    p2: jnp.ndarray       # (L, 2)
    octave: jnp.ndarray   # (L,) int32
    length: jnp.ndarray   # (L,)
    desc: jnp.ndarray     # (L, D) float32, L2-normalized
    valid: jnp.ndarray    # (L,) bool


def _sobel(img: jnp.ndarray):
    kx = jnp.asarray(np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32))
    p = jnp.pad(img, 1, mode="edge")
    win = jax.lax.conv_general_dilated(
        p[None, None], jnp.stack([kx, kx.T])[:, None],
        (1, 1), "VALID")[0]
    return win[0], win[1]  # gx, gy


@partial(jax.jit, static_argnames=("cfg",))
def detect_lines(img: jnp.ndarray, cfg: LineDetConfig = LineDetConfig()) -> KeyLines:
    img = img.astype(jnp.float32)
    H, W = img.shape
    diag = float(np.hypot(H, W))
    n_rho = int(np.ceil(diag / cfg.rho_res))
    gx, gy = _sobel(img)
    mag = jnp.hypot(gx, gy)
    edge = mag > cfg.mag_factor * jnp.mean(mag)

    ys, xs = jnp.meshgrid(jnp.arange(H, dtype=jnp.float32),
                          jnp.arange(W, dtype=jnp.float32), indexing="ij")
    # line normal direction = gradient direction, folded to [0, pi)
    phi = jnp.arctan2(gy, gx)
    phi = jnp.where(phi < 0, phi + jnp.pi, phi)
    phi = jnp.where(phi >= jnp.pi, phi - jnp.pi, phi)
    # rho with the normal's sign folded in so rho >= -diag..diag -> [0, 2diag)
    rho = xs * jnp.cos(phi) + ys * jnp.sin(phi)      # in [-diag, diag]
    pi_bin = jnp.clip((phi / jnp.pi * cfg.n_phi).astype(jnp.int32), 0, cfg.n_phi - 1)
    r_bin = jnp.clip(((rho + diag) / cfg.rho_res / 2.0).astype(jnp.int32), 0, n_rho - 1)

    acc = jnp.zeros((n_rho, cfg.n_phi), jnp.float32)
    w = jnp.where(edge, mag, 0.0).reshape(-1)
    acc = acc.at[r_bin.reshape(-1), pi_bin.reshape(-1)].add(w)
    # smooth + 3x3 NMS (wrap-around on the angle axis)
    accp = jnp.pad(acc, ((1, 1), (0, 0)))
    accp = jnp.concatenate([accp[:, -1:], accp, accp[:, :1]], axis=1)
    win = jax.lax.reduce_window(accp, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "VALID")
    peaks = jnp.where((acc >= win) & (acc >= cfg.min_support), acc, 0.0)

    vals, flat_idx = jax.lax.top_k(peaks.reshape(-1), cfg.max_lines)
    pr = flat_idx // cfg.n_phi
    pp = flat_idx % cfg.n_phi
    rho_k = (pr.astype(jnp.float32) + 0.5) * cfg.rho_res * 2.0 - diag
    phi_k = (pp.astype(jnp.float32) + 0.5) * jnp.pi / cfg.n_phi
    ok = vals > 0.0

    # support span: pixels near each peak line with compatible orientation
    cosk, sink = jnp.cos(phi_k), jnp.sin(phi_k)
    xs_f = xs.reshape(-1)
    ys_f = ys.reshape(-1)
    d_line = (xs_f[None] * cosk[:, None] + ys_f[None] * sink[:, None]
              - rho_k[:, None])                                   # (K, HW)
    dphi = jnp.abs(phi.reshape(-1)[None] - phi_k[:, None])
    dphi = jnp.minimum(dphi, jnp.pi - dphi)
    support = (jnp.abs(d_line) < 1.5 * cfg.rho_res) \
        & (dphi < 2.5 * jnp.pi / cfg.n_phi) & edge.reshape(-1)[None]

    # refine (rho, phi) by magnitude-weighted PCA of the support pixels:
    # undoes the accumulator's bin quantization (2 px / 1.5 deg otherwise)
    wgt = jnp.where(support, mag.reshape(-1)[None], 0.0)          # (K, HW)
    wsum = jnp.maximum(wgt.sum(-1), 1e-6)
    mx = (wgt * xs_f[None]).sum(-1) / wsum
    my = (wgt * ys_f[None]).sum(-1) / wsum
    dxs = xs_f[None] - mx[:, None]
    dys = ys_f[None] - my[:, None]
    cxx = (wgt * dxs * dxs).sum(-1) / wsum
    cxy = (wgt * dxs * dys).sum(-1) / wsum
    cyy = (wgt * dys * dys).sum(-1) / wsum
    # principal direction of the 2x2 covariance (largest eigenvector)
    ang2 = 0.5 * jnp.arctan2(2.0 * cxy, cxx - cyy)
    t = jnp.stack([jnp.cos(ang2), jnp.sin(ang2)], -1)             # along-line
    nvec = jnp.stack([-t[:, 1], t[:, 0]], -1)
    rho_r = mx * nvec[:, 0] + my * nvec[:, 1]

    s = xs_f[None] * t[:, None, 0] + ys_f[None] * t[:, None, 1]   # (K, HW)
    s_min = jnp.min(jnp.where(support, s, jnp.inf), axis=-1)
    s_max = jnp.max(jnp.where(support, s, -jnp.inf), axis=-1)
    n_sup = support.sum(axis=-1)
    length = jnp.maximum(s_max - s_min, 0.0)
    p1 = rho_r[:, None] * nvec + s_min[:, None] * t
    p2 = rho_r[:, None] * nvec + s_max[:, None] * t
    # density gate: support must fill a reasonable fraction of the span
    dense = n_sup.astype(jnp.float32) >= 0.5 * length
    valid = ok & (length >= cfg.min_len) & dense & jnp.isfinite(length)

    # duplicate suppression: refined lines landing on the same (rho, phi)
    # keep only the strongest (Hough peaks fragment along long segments)
    phi_r = jnp.arctan2(nvec[:, 1], nvec[:, 0])
    phi_r = jnp.where(phi_r < 0, phi_r + jnp.pi, phi_r)
    rho_c = jnp.where(rho_r < 0, -rho_r, rho_r)  # canonical
    drho = jnp.abs(rho_c[:, None] - rho_c[None])
    dph = jnp.abs(phi_r[:, None] - phi_r[None])
    dph = jnp.minimum(dph, jnp.pi - dph)
    same = (drho < 3.0) & (dph < 0.05) & valid[:, None] & valid[None]
    score = n_sup.astype(jnp.float32) * length
    better = same & ((score[None] > score[:, None])
                     | ((score[None] == score[:, None])
                        & (jnp.arange(cfg.max_lines)[None]
                           < jnp.arange(cfg.max_lines)[:, None])))
    valid = valid & ~jnp.any(better, axis=1)
    p1 = jnp.where(valid[:, None], p1, 0.0)
    p2 = jnp.where(valid[:, None], p2, 0.0)

    desc = _lbd_descriptor(img, gx, gy, p1, p2, cfg)
    return KeyLines(
        p1=p1, p2=p2,
        octave=jnp.zeros(cfg.max_lines, jnp.int32),
        length=length * valid,
        desc=desc * valid[:, None],
        valid=valid,
    )


def _bilinear(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray):
    H, W = img.shape
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    dx = x - x0
    dy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return ((1 - dy) * (1 - dx) * v00 + (1 - dy) * dx * v01
            + dy * (1 - dx) * v10 + dy * dx * v11)


def _lbd_descriptor(img, gx, gy, p1, p2, cfg: LineDetConfig) -> jnp.ndarray:
    """Band descriptor: (L, n_bands*8) from gradients in the line frame."""
    L = p1.shape[0]
    d = p2 - p1
    ln = jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-6)
    t = d / ln                                  # along line
    n = jnp.stack([-t[..., 1], t[..., 0]], -1)  # normal
    S, O = cfg.band_samples, cfg.band_offsets
    ss = jnp.linspace(0.05, 0.95, S)
    oo = jnp.arange(O, dtype=jnp.float32) - (O - 1) / 2.0
    # sample grid (L, S, O, 2)
    base = p1[:, None, :] + ss[None, :, None] * d[:, None, :]
    pts = base[:, :, None, :] + oo[None, None, :, None] * n[:, None, None, :]
    gxs = _bilinear(gx, pts[..., 0], pts[..., 1])
    gys = _bilinear(gy, pts[..., 0], pts[..., 1])
    g_par = gxs * t[:, None, None, 0] + gys * t[:, None, None, 1]
    g_per = gxs * n[:, None, None, 0] + gys * n[:, None, None, 1]
    ch = jnp.stack([jnp.maximum(g_per, 0), jnp.maximum(-g_per, 0),
                    jnp.maximum(g_par, 0), jnp.maximum(-g_par, 0)], -1)
    # band pooling over offsets
    per_band = O // cfg.n_bands
    ch = ch[:, :, : per_band * cfg.n_bands].reshape(
        L, S, cfg.n_bands, per_band, 4).sum(axis=3)   # (L, S, B, 4)
    mean = ch.mean(axis=1)
    std = ch.std(axis=1)
    desc = jnp.concatenate([mean, std], -1).reshape(L, cfg.n_bands * 8)
    nn = jnp.maximum(jnp.linalg.norm(desc, axis=-1, keepdims=True), 1e-6)
    return desc / nn
