"""Device kernels for the keyframe-rate mapping operations.

Replaces the per-feature CPU loops of:
- `LocalMapping::CreateNewMapPoints` (reference src/LocalMapping.cc:208-453)
  + `ORBmatcher::SearchForTriangulation` (src/ORBmatcher.cc:657-823):
  epipolar-gated descriptor matching between keyframe pairs and two-view
  triangulation of far points the stereo depth cannot reach,
- `ORBmatcher::Fuse` (src/ORBmatcher.cc:825-975): projecting map points into
  a neighbor keyframe to find duplicate/missing associations.

Each is one batched jitted program over the padded feature arrays.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..geometry import se3
from ..geometry.camera import StereoCamera
from ..ops import hamming


@partial(jax.jit, static_argnames=("cam",))
def triangulate_pair(
    cam: StereoCamera,
    T1: jnp.ndarray,          # (4, 4) T_cw of KF1 (the new keyframe)
    T2: jnp.ndarray,          # (4, 4) T_cw of KF2 (neighbor)
    xy1, desc1, oct1, free1,  # KF1 features: (N,2), (N,8), (N,), (N,) bool
    xy2, desc2, oct2, free2,  # KF2 features
    inv_sigma2_lut: jnp.ndarray,
):
    """Epipolar-gated matching + linear triangulation.

    Returns packed int32 buffer: [n, idx1 (N,), idx2 via match (N,),
    X bitcast (N*3,)] where idx entries are -1 for no match; X is the
    triangulated world point per KF1 feature.
    """
    N = xy1.shape[0]
    # relative geometry KF1 -> KF2: x2^T F12 x1 = 0 with F = K2^-T E K1^-1
    T21 = T2 @ jnp.linalg.inv(T1)
    R, t = T21[:3, :3], T21[:3, 3]
    tx = jnp.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]],
                   T1.dtype)
    E = tx @ R
    Kinv = jnp.array([[1.0 / cam.fx, 0, -cam.cx / cam.fx],
                      [0, 1.0 / cam.fy, -cam.cy / cam.fy],
                      [0, 0, 1.0]], T1.dtype)
    F = Kinv.T @ E @ Kinv

    h1 = jnp.concatenate([xy1, jnp.ones((N, 1), xy1.dtype)], -1)  # (N, 3)
    h2 = jnp.concatenate([xy2, jnp.ones((N, 1), xy2.dtype)], -1)
    # epipolar line of each KF1 feature in KF2: l2 = F h1
    l2 = h1 @ F.T                                                  # (N, 3)
    nrm = jnp.sqrt(l2[:, 0] ** 2 + l2[:, 1] ** 2)
    d_epi = jnp.abs(h2 @ l2.T) / jnp.maximum(nrm[None, :], 1e-9)   # (N2, N1)
    d_epi = d_epi.T                                                # (N1, N2)
    sigma2 = (1.0 / inv_sigma2_lut)[oct2]
    epi_ok = d_epi < 3.84 * jnp.sqrt(sigma2)[None, :]  # chi2 3.84 sigma^2

    dist = hamming.distance_matrix(desc1, desc2)
    oct_ok = jnp.abs(oct1[:, None] - oct2[None, :]) <= 1
    cand = epi_ok & oct_ok & free1[:, None] & free2[None, :] \
        & (dist <= hamming.TH_LOW)
    d = jnp.where(cand, dist, hamming.INF_DIST)
    best = jnp.argmin(d, axis=1)
    bd = jnp.take_along_axis(d, best[:, None], 1)[:, 0]
    ok = bd <= hamming.TH_LOW
    # mutual exclusion per KF2 feature
    f2_best = jnp.full((N,), hamming.INF_DIST, jnp.int32).at[best].min(
        jnp.where(ok, bd, hamming.INF_DIST))
    win = ok & (bd == f2_best[best])
    i1 = jnp.arange(N, dtype=jnp.int32)
    f2_claim = jnp.full((N,), N, jnp.int32).at[best].min(jnp.where(win, i1, N))
    win = win & (f2_claim[best] == i1)

    # linear (midpoint) triangulation in world frame
    def ray(T, xy):
        d_c = jnp.stack([(xy[:, 0] - cam.cx) / cam.fx,
                         (xy[:, 1] - cam.cy) / cam.fy,
                         jnp.ones(N, xy.dtype)], -1)
        R_wc = jnp.swapaxes(T[:3, :3], 0, 1)
        dirs = d_c @ T[:3, :3]          # R^T d
        c = -R_wc @ T[:3, 3]
        dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
        return dirs, c

    r1, c1 = ray(T1, xy1)
    r2all, c2 = ray(T2, xy2)
    r2 = r2all[jnp.maximum(best, 0)]
    # midpoint of closest approach between the two rays
    b_vec = c2 - c1
    d11 = jnp.sum(r1 * r1, -1)
    d12 = jnp.sum(r1 * r2, -1)
    d22 = jnp.sum(r2 * r2, -1)
    det = d11 * d22 - d12 * d12
    det = jnp.where(jnp.abs(det) < 1e-9, 1e-9, det)
    s1 = (jnp.sum(b_vec[None] * r1, -1) * d22
          - jnp.sum(b_vec[None] * r2, -1) * d12) / det
    s2 = (jnp.sum(b_vec[None] * r1, -1) * d12
          - jnp.sum(b_vec[None] * r2, -1) * d11) / det
    X = 0.5 * (c1 + s1[:, None] * r1 + c2 + s2[:, None] * r2)

    # acceptance checks (LocalMapping.cc:286-438): parallax, cheirality,
    # reprojection chi2 in both views
    cospar = jnp.sum(r1 * r2, -1)
    z1 = se3.apply(T1, X)[:, 2]
    z2 = se3.apply(T2, X)[:, 2]

    def reproj_ok(T, xy, oct_):
        Xc = se3.apply(T, X)
        z = jnp.maximum(Xc[:, 2], 1e-6)
        u = cam.fx * Xc[:, 0] / z + cam.cx
        v = cam.fy * Xc[:, 1] / z + cam.cy
        e2 = (u - xy[:, 0]) ** 2 + (v - xy[:, 1]) ** 2
        return e2 * inv_sigma2_lut[oct_] < 5.991

    good = (win & (cospar < 0.9998) & (z1 > 0) & (z2 > 0)
            & reproj_ok(T1, xy1, oct1)
            & reproj_ok(T2, xy2[jnp.maximum(best, 0)],
                        oct2[jnp.maximum(best, 0)]))
    match = jnp.where(good, best, -1)
    packed = jnp.concatenate([
        jnp.array([jnp.sum(good)], jnp.int32),
        match,
        jax.lax.bitcast_convert_type(X.reshape(-1), jnp.int32),
    ])
    return packed


@partial(jax.jit, static_argnames=("cam",))
def triangulate_pairs(cam: StereoCamera, T1, xy1, desc1, oct1, free1,
                      T2s, xy2s, desc2s, oct2s, free2s, inv_sigma2_lut):
    """`triangulate_pair` batched over B neighbor keyframes (axis 0 of the
    `*2s` arrays) — ONE device program and readback instead of B.
    Returns (B, L)."""
    return jax.vmap(
        lambda T2, xy2, desc2, oct2, free2: triangulate_pair(
            cam, T1, T2, xy1, desc1, oct1, free1,
            xy2, desc2, oct2, free2, inv_sigma2_lut)
    )(T2s, xy2s, desc2s, oct2s, free2s)


def unpack_triangulate_np(buf, n):
    import numpy as np
    n_good = int(buf[0])
    match = buf[1:1 + n]
    X = buf[1 + n:1 + n + 3 * n].view(np.float32).reshape(n, 3)
    return n_good, match, X


@partial(jax.jit, static_argnames=("cam", "n_levels", "scale"))
def fuse_candidates(
    cam: StereoCamera,
    T_kf: jnp.ndarray,
    view,                      # matching.MapPointView of source points
    kf_feats,                  # matching.FrameFeatures of the target KF
    n_levels: int = 8,
    scale: float = 1.2,
):
    """Fuse pass (ORBmatcher::Fuse semantics): associate source map points
    with the target keyframe's features. Returns packed int32
    [pt2kp (P,), kp2pt (N,)] using the radius-3 projection search."""
    from ..frontend import matching
    pt2kp, kp2pt, _, _ = matching.search_by_projection(
        cam, T_kf, view, kf_feats, n_levels=n_levels, scale=scale, th=0.75)
    return jnp.concatenate([pt2kp, kp2pt])


@partial(jax.jit, static_argnames=("cam", "n_levels", "scale"))
def fuse_candidates_multi(cam: StereoCamera, T_kfs, view, kf_feats_s,
                          n_levels: int = 8, scale: float = 1.2):
    """`fuse_candidates` batched over B target keyframes (one round trip)."""
    return jax.vmap(
        lambda T, f: fuse_candidates(cam, T, view, f,
                                     n_levels=n_levels, scale=scale)
    )(T_kfs, kf_feats_s)
