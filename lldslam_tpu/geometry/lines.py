"""Batched 3D/2D line geometry.

Replaces the reference's `vgl` vision-geometry library (src/vgl.cc), the
minimal line parameterization of `VertexSBALine`/`LineParams`
(Thirdparty/g2o/g2o/types/types_sba.h:62-110), the projection residual of
`EdgeSE3ProjectLine` (types_six_dof_expmap.h:299-385), and the Hough-grid
helpers of src/LineMatching.cc — all as pure batched JAX functions.

3D line representation ("x0dir" form, MapLine.h:120-121): a pair
`(X0, d)` where `d` is the unit direction and `X0` is the point on the line
closest to the origin (so `X0 . d == 0`). Stored as a (..., 6) array
`[X0, d]`.

Minimal 4-DoF state for optimization (types_sba.h:97-108): a unit quaternion
`q` with rotation columns `R = [d, X0/|X0|, d x X0/|X0|]` plus the scalar
`alpha = |X0|`; the retraction is a quaternion increment on q and additive on
alpha.

2D line equation: homogeneous `l = (a, b, c)`, normalized so a^2+b^2 = 1
(`NormalizedLineEq`, LineMatching.cc:249). Signed point-line distance is then
`l . (u, v, 1)`.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import se3
from .camera import StereoCamera

# Hough grid dimensions (Frame.h:45-46 FRAME_DIST_CELLS / FRAME_ANG_CELLS).
DIST_CELLS = 50
ANG_CELLS = 50

_EPS = 1e-9


# ---------------------------------------------------------------------------
# 2D line equations
# ---------------------------------------------------------------------------

def line_eq_from_endpoints(p1: jnp.ndarray, p2: jnp.ndarray) -> jnp.ndarray:
    """Endpoints (..., 2) x2 -> normalized line eq (..., 3) with a^2+b^2=1."""
    h1 = jnp.concatenate([p1, jnp.ones_like(p1[..., :1])], axis=-1)
    h2 = jnp.concatenate([p2, jnp.ones_like(p2[..., :1])], axis=-1)
    l = jnp.cross(h1, h2)
    n = jnp.linalg.norm(l[..., :2], axis=-1, keepdims=True)
    return l / jnp.maximum(n, _EPS)


def point_line_distance(l: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Signed distance of pixel p (..., 2) to normalized line l (..., 3)."""
    return l[..., 0] * p[..., 0] + l[..., 1] * p[..., 1] + l[..., 2]


def hough_coords(p1: jnp.ndarray, p2: jnp.ndarray, diag: float):
    """2D segment -> (dist_cell, ang_cell) int32 pair for the 50x50 grid.

    Implements the *intent* of `GetHoughCoordinates` (LineMatching.cc:63-152)
    + the never-executed population step (reference defect D1, SURVEY.md §2.4):
    the line equation's (distance-from-origin, angle) binned uniformly over
    [0, diag) x [0, pi).
    """
    l = line_eq_from_endpoints(p1, p2)
    # Canonicalize so c <= 0, making distance = -c >= 0 and angle well defined.
    sign = jnp.where(l[..., 2:3] > 0, -1.0, 1.0)
    l = l * sign
    dist = -l[..., 2]
    ang = jnp.arctan2(l[..., 1], l[..., 0])  # (-pi, pi]
    ang = jnp.where(ang < 0, ang + jnp.pi, ang)  # [0, pi)
    ang = jnp.where(ang >= jnp.pi, ang - jnp.pi, ang)
    di = jnp.clip((dist / diag * DIST_CELLS).astype(jnp.int32), 0, DIST_CELLS - 1)
    ai = jnp.clip((ang / jnp.pi * ANG_CELLS).astype(jnp.int32), 0, ANG_CELLS - 1)
    return di, ai


# ---------------------------------------------------------------------------
# 3D line codecs
# ---------------------------------------------------------------------------

def closest_point_form(P: jnp.ndarray, d: jnp.ndarray):
    """Any point P on the line + direction d -> (X0 perp d, unit d)."""
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), _EPS)
    X0 = P - jnp.sum(P * d, axis=-1, keepdims=True) * d
    return X0, d


def minimal_from_x0dir(X0: jnp.ndarray, d: jnp.ndarray):
    """(X0, d) -> (q wxyz, alpha): R = [d, X0/|X0|, d x X0/|X0|] cols
    (types_sba.h:62-110 LineParams)."""
    alpha = jnp.linalg.norm(X0, axis=-1)
    n = X0 / jnp.maximum(alpha[..., None], _EPS)
    b = jnp.cross(d, n)
    R = jnp.stack([d, n, b], axis=-1)  # columns
    q = se3.quat_from_mat(R)
    return q, alpha


def x0dir_from_minimal(q: jnp.ndarray, alpha: jnp.ndarray):
    """(q, alpha) -> (X0, d)."""
    R = se3.mat_from_quat(q)
    d = R[..., :, 0]
    X0 = alpha[..., None] * R[..., :, 1]
    return X0, d


def plucker_from_x0dir(X0: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """(X0, d) -> Pluecker (..., 6) [m, d] with moment m = X0 x d
    (vgl Line3DFromPluecker family, vgl.cc:136-224)."""
    return jnp.concatenate([jnp.cross(X0, d), d], axis=-1)


def x0dir_from_plucker(L: jnp.ndarray):
    """Pluecker [m, d] -> (X0, d): X0 = d x m / |d|^2."""
    m, d = L[..., :3], L[..., 3:]
    nd = jnp.maximum(jnp.sum(d * d, axis=-1, keepdims=True), _EPS)
    X0 = jnp.cross(d, m) / nd
    d = d / jnp.sqrt(nd)
    return X0, d


def transform_line(T: jnp.ndarray, X0: jnp.ndarray, d: jnp.ndarray):
    """Rigidly transform an x0dir line by T (..., 4, 4) and re-canonicalize."""
    P = se3.apply(T, X0)
    dn = (T[..., :3, :3] @ d[..., None])[..., 0]
    return closest_point_form(P, dn)


# ---------------------------------------------------------------------------
# Projection + residuals
# ---------------------------------------------------------------------------

def project_line(cam: StereoCamera, T_cw: jnp.ndarray, X0: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """World x0dir line -> normalized image line eq (..., 3).

    Projects two points on the line and joins them (equivalent to the
    K^{-T} Pluecker projection; matches vgl::ProjectLine semantics
    vgl.cc:348 via cam_project of two points as in
    EdgeSE3ProjectLine::computeError types_six_dof_expmap.h:344-375).
    """
    Xc0 = se3.apply(T_cw, X0)
    Xc1 = se3.apply(T_cw, X0 + d)
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    def px(X):
        z = jnp.where(jnp.abs(X[..., 2]) < _EPS, _EPS, X[..., 2])
        return jnp.stack([fx * X[..., 0] / z + cx, fy * X[..., 1] / z + cy], axis=-1)
    return line_eq_from_endpoints(px(Xc0), px(Xc1))


def endpoint_residual(
    cam: StereoCamera,
    T_cw: jnp.ndarray,
    X0: jnp.ndarray,
    d: jnp.ndarray,
    x1: jnp.ndarray,
    x2: jnp.ndarray,
) -> jnp.ndarray:
    """2-vector residual: signed distances of observed 2D endpoints x1, x2 to
    the projected infinite line (EdgeSE3ProjectLine error,
    types_six_dof_expmap.h:344-375). Broadcasts over leading dims."""
    l = project_line(cam, T_cw, X0, d)
    return jnp.stack(
        [point_line_distance(l, x1), point_line_distance(l, x2)], axis=-1
    )


def right_camera_pose(T_cw: jnp.ndarray, baseline: float) -> jnp.ndarray:
    """Left-camera pose -> right-camera pose: T_rw = T_rl @ T_cw with
    T_rl = (I, (-b, 0, 0)) (GetTForRight, LineMatching.cc:228; stereo edge
    baseline shift Optimizer.cc:100-105)."""
    shift = jnp.zeros(T_cw.shape[:-2] + (3,), T_cw.dtype).at[..., 0].set(-baseline)
    T_rl = se3.from_Rt(jnp.broadcast_to(jnp.eye(3, dtype=T_cw.dtype), T_cw.shape[:-2] + (3, 3)), shift)
    return T_rl @ T_cw


def line_depths(T_cw: jnp.ndarray, X0: jnp.ndarray, d: jnp.ndarray,
                cam: StereoCamera, x1: jnp.ndarray, x2: jnp.ndarray):
    """Depths of the 3D points on the line that project to observed endpoint
    pixel rays (EdgeSE3ProjectLine depth check, types_six_dof_expmap.h:312-342;
    vgl::ReprojectLinePointTo3D vgl.cc:336)."""
    Xc0, dc = transform_line(T_cw, X0, d)
    def depth_at(px):
        # Ray through pixel: r = K^-1 [u,v,1]; find t minimizing |Xc0 + s*dc - t*r|
        r = jnp.stack(
            [
                (px[..., 0] - cam.cx) / cam.fx,
                (px[..., 1] - cam.cy) / cam.fy,
                jnp.ones_like(px[..., 0]),
            ],
            axis=-1,
        )
        # Solve 2x2 normal equations for (s, t): columns [dc, -r]
        a11 = jnp.sum(dc * dc, axis=-1)
        a12 = -jnp.sum(dc * r, axis=-1)
        a22 = jnp.sum(r * r, axis=-1)
        b1 = -jnp.sum(dc * Xc0, axis=-1)
        b2 = jnp.sum(r * Xc0, axis=-1)
        det = a11 * a22 - a12 * a12
        det = jnp.where(jnp.abs(det) < _EPS, _EPS, det)
        t = (a11 * b2 - a12 * b1) / det
        return t  # depth along ray (z of t*r is t since r_z = 1)
    return depth_at(x1), depth_at(x2)


# ---------------------------------------------------------------------------
# Triangulation
# ---------------------------------------------------------------------------

def triangulate_two_view(
    n1: jnp.ndarray,
    c1: jnp.ndarray,
    n2: jnp.ndarray,
    c2: jnp.ndarray,
    parallel_thresh: float = 0.975,
):
    """Two back-projected planes -> world x0dir line.

    Each observation defines a plane through the camera center `c_i` with
    world-frame normal `n_i` (= R_wc K^T l for image line l). The line
    direction is n1 x n2; X0 solves the two plane equations plus the
    closest-point constraint d . X = 0 (vgl::TriangulateLine, vgl.cc:78-108,
    with the 0.975 parallel-normal degeneracy guard at vgl.cc:85).

    Returns (X0, d, ok_mask).
    """
    n1u = n1 / jnp.maximum(jnp.linalg.norm(n1, axis=-1, keepdims=True), _EPS)
    n2u = n2 / jnp.maximum(jnp.linalg.norm(n2, axis=-1, keepdims=True), _EPS)
    cosang = jnp.abs(jnp.sum(n1u * n2u, axis=-1))
    ok = cosang < parallel_thresh
    d = jnp.cross(n1u, n2u)
    dn = jnp.linalg.norm(d, axis=-1, keepdims=True)
    d = d / jnp.maximum(dn, _EPS)
    # Solve A X = b with rows [n1; n2; d]
    A = jnp.stack([n1u, n2u, d], axis=-2)
    b = jnp.stack(
        [jnp.sum(n1u * c1, axis=-1), jnp.sum(n2u * c2, axis=-1), jnp.zeros_like(cosang)],
        axis=-1,
    )
    # Regularize the (near-)singular case so solve stays finite; masked by ok.
    reg = jnp.where(ok, 0.0, 1e-3)[..., None, None] * jnp.eye(3, dtype=A.dtype)
    X0 = jnp.linalg.solve(A + reg, b[..., None])[..., 0]
    X0, d = closest_point_form(X0, d)
    return X0, d, ok


def plane_normal_from_obs(
    cam: StereoCamera, T_cw: jnp.ndarray, p1: jnp.ndarray, p2: jnp.ndarray
):
    """Image segment (endpoints in pixels) + pose -> (world plane normal,
    camera center). The plane contains the camera center and the two pixel
    rays."""
    l = line_eq_from_endpoints(p1, p2)
    # Camera-frame normal: K^T l
    n_c = jnp.stack(
        [
            cam.fx * l[..., 0],
            cam.fy * l[..., 1],
            cam.cx * l[..., 0] + cam.cy * l[..., 1] + l[..., 2],
        ],
        axis=-1,
    )
    T_wc = se3.inv(T_cw)
    R_wc = T_wc[..., :3, :3]
    n_w = (R_wc @ n_c[..., None])[..., 0]
    c_w = T_wc[..., :3, 3]
    return n_w, c_w


def triangulate_multi_view(
    normals: jnp.ndarray, centers: jnp.ndarray, mask: jnp.ndarray
):
    """>=3-observation line triangulation via SVD (vgl::MultiTriangulateLine,
    vgl.cc:28-75).

    normals (..., N, 3), centers (..., N, 3), mask (..., N) bool.
    Planes: n_i . X = n_i . c_i. Stack [n_i | -n_i.c_i] and take the
    2-dim right null space of the masked system -> two homogeneous points
    spanning the line. Returns (X0, d, ok).
    """
    rhs = jnp.sum(normals * centers, axis=-1, keepdims=True)
    A = jnp.concatenate([normals, -rhs], axis=-1)  # (..., N, 4)
    A = A * mask[..., None]
    # Null space of A = eigenvectors of the two SMALLEST eigenvalues of the
    # 4x4 Gram matrix A^T A — equivalent to the SVD's last two right
    # singular vectors but a batched symmetric 4x4 eigendecomposition
    # instead of a general (N, 4) SVD, which XLA lowers to a long iterative
    # device program that would sit in the execution queue at KF rate.
    M = jnp.einsum("...ni,...nj->...ij", A, A)
    _, v = jnp.linalg.eigh(M)  # ascending eigenvalues
    h1 = v[..., :, 0]
    h2 = v[..., :, 1]
    # Dehomogenize a point and direction from span{h1, h2}.
    # Point: combination with nonzero w; direction: combination with w=0.
    w1, w2 = h1[..., 3], h2[..., 3]
    use1 = jnp.abs(w1) >= jnp.abs(w2)
    hp = jnp.where(use1[..., None], h1, h2)
    hq = jnp.where(use1[..., None], h2, h1)
    wp = hp[..., 3]
    wp_safe = jnp.where(jnp.abs(wp) < _EPS, _EPS, wp)
    P = hp[..., :3] / wp_safe[..., None]
    # Direction: hq - (wq/wp) hp has zero homogeneous part.
    dvec = hq[..., :3] - (hq[..., 3] / wp_safe)[..., None] * hp[..., :3]
    nobs = jnp.sum(mask, axis=-1)
    ok = (nobs >= 2) & (jnp.linalg.norm(dvec, axis=-1) > _EPS) & (jnp.abs(wp) > _EPS)
    X0, d = closest_point_form(P, dvec)
    return X0, d, ok


@jax.jit
def triangulate_multi_view_packed(normals, centers, mask) -> jnp.ndarray:
    """triangulate_multi_view with the three host-bound results flattened
    into ONE int32 buffer [X0 | d | ok]: one device->host transfer at
    keyframe rate instead of three."""
    X0, d, ok = triangulate_multi_view(normals, centers, mask)
    bc = lambda a: jax.lax.bitcast_convert_type(
        a.astype(jnp.float32).reshape(-1), jnp.int32)
    return jnp.concatenate([bc(X0), bc(d), ok.astype(jnp.int32)])


@partial(jax.jit, static_argnames=("cap", "max_obs"))
def triangulate_multi_view_from_packed(buf: jnp.ndarray, cap: int,
                                       max_obs: int) -> jnp.ndarray:
    """triangulate_multi_view_packed from a SINGLE uploaded int32 buffer
    [normals | centers | mask]: one host->device transfer at keyframe rate
    instead of three."""
    n = cap * max_obs * 3
    normals = jax.lax.bitcast_convert_type(
        buf[:n], jnp.float32).reshape(cap, max_obs, 3)
    centers = jax.lax.bitcast_convert_type(
        buf[n:2 * n], jnp.float32).reshape(cap, max_obs, 3)
    mask = buf[2 * n:].reshape(cap, max_obs) > 0
    return triangulate_multi_view_packed(normals, centers, mask)


def endpoints_3d(
    X0: jnp.ndarray, d: jnp.ndarray, T_cw: jnp.ndarray, cam: StereoCamera,
    x1: jnp.ndarray, x2: jnp.ndarray,
):
    """Recover 3D endpoints of a world line by intersecting with the rays of
    observed 2D endpoints in a reference view (MapLine::GetMainPoints3D via
    reprojecting the ref-KF KeyLine, MapLine.cc:453-468)."""
    t1, t2 = line_depths(T_cw, X0, d, cam, x1, x2)
    Xc0, dc = transform_line(T_cw, X0, d)
    # Closest points on the line to the two rays, expressed via s from depth solve:
    # easier: project ray points back to line. Ray point = t * K^-1 pix.
    def lift(px, t):
        r = jnp.stack(
            [
                (px[..., 0] - cam.cx) / cam.fx,
                (px[..., 1] - cam.cy) / cam.fy,
                jnp.ones_like(px[..., 0]),
            ],
            axis=-1,
        )
        Xr = t[..., None] * r
        # snap onto the line
        s = jnp.sum((Xr - Xc0) * dc, axis=-1, keepdims=True)
        Xc = Xc0 + s * dc
        T_wc = se3.inv(T_cw)
        return se3.apply(T_wc, Xc)
    return lift(x1, t1), lift(x2, t2)
