"""Packed single-upload device kernels for the keyframe-rate mapping path.

A straightforward mapper uploads ~20 separate arrays per keyframe (features,
poses, masks, views, BA problem pieces), each a host->device transfer with
its own latency. This module reduces the per-keyframe traffic to TWO
uploads (the packed layouts are kept until the keyframe path is measured
on the GPU without them, ROADMAP Design):

1. the *KF-stage* buffer — poses/masks/fuse-view for epipolar triangulation
   (CreateNewMapPoints, reference src/LocalMapping.cc:208-453) and duplicate
   fusion (SearchInNeighbors, src/LocalMapping.cc:455-554), with per-KF
   feature arrays gathered on device from the `KfCache` ring;
2. the *BA* buffer — the padded windowed problem (LocalBundleAdjustment,
   src/Optimizer.cc:936-1388) WITHOUT per-observation uvr/sigma (gathered
   from the cache by (slot, feature) index), plus the tracker's next
   local-map point view, which the BA program assembles ON DEVICE from the
   solved points (UpdateLocalPoints, src/Tracking.cc:1677-1724 — the
   reference's tracker reads the live map; here the post-BA view ships with
   the BA program, so the tracker never re-uploads it).

All buffers are single int32 arrays with static layouts; floats travel
bitcast.  Layout objects compute offsets once per shape bucket.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..frontend import matching
from ..geometry.camera import StereoCamera
from . import mapping_ops
from .kf_cache import CacheArrays


def _bc_f(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).reshape(-1).view(np.int32)


def _bc_u(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.uint32).reshape(-1).view(np.int32)


def _slice_f(buf, off, shape):
    n = int(np.prod(shape))
    return jax.lax.bitcast_convert_type(
        jax.lax.dynamic_slice(buf, (off,), (n,)), jnp.float32).reshape(shape)


def _slice_u(buf, off, shape):
    n = int(np.prod(shape))
    return jax.lax.bitcast_convert_type(
        jax.lax.dynamic_slice(buf, (off,), (n,)), jnp.uint32).reshape(shape)


def _slice_i(buf, off, shape):
    n = int(np.prod(shape))
    return jax.lax.dynamic_slice(buf, (off,), (n,)).reshape(shape)


# ---------------------------------------------------------------------------
# view packing (shared): MapPointView as one contiguous block
# ---------------------------------------------------------------------------

VIEW_INTS_PER_PT = 3 + 8 + 3 + 1 + 1 + 1  # pos desc normal mind maxd valid


def pack_view(store, pids: np.ndarray, cap: int) -> np.ndarray:
    """Pack a MapPointView over global point ids into one int32 block."""
    P = len(pids)
    pos = np.zeros((cap, 3), np.float32)
    desc = np.zeros((cap, 8), np.uint32)
    normal = np.zeros((cap, 3), np.float32)
    mind = np.zeros(cap, np.float32)
    maxd = np.zeros(cap, np.float32)
    valid = np.zeros(cap, np.int32)
    pos[:P] = store.pt_pos[pids]
    desc[:P] = store.pt_desc[pids]
    normal[:P] = store.pt_normal[pids]
    mind[:P] = store.pt_min_dist[pids]
    maxd[:P] = store.pt_max_dist[pids]
    valid[:P] = 1
    return np.concatenate([
        _bc_f(pos), _bc_u(desc), _bc_f(normal), _bc_f(mind), _bc_f(maxd),
        valid])


def unpack_view(buf, off: int, cap: int) -> matching.MapPointView:
    o = off
    pos = _slice_f(buf, o, (cap, 3)); o += cap * 3
    desc = _slice_u(buf, o, (cap, 8)); o += cap * 8
    normal = _slice_f(buf, o, (cap, 3)); o += cap * 3
    mind = _slice_f(buf, o, (cap,)); o += cap
    maxd = _slice_f(buf, o, (cap,)); o += cap
    valid = _slice_i(buf, o, (cap,)) > 0
    return matching.MapPointView(pos=pos, desc=desc, normal=normal,
                                 min_dist=mind, max_dist=maxd, valid=valid)


def _cache_feats(cache: CacheArrays, slot) -> matching.FrameFeatures:
    return matching.FrameFeatures(
        xy=cache.xy[slot], ur=cache.ur[slot], octave=cache.octave[slot],
        angle=cache.angle[slot], desc=cache.desc[slot],
        valid=cache.valid[slot])


# ---------------------------------------------------------------------------
# KF-stage: triangulation + fusion, one upload
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KfStageLayout:
    """Static layout for the KF-stage buffer. B1 = 1 self + 3 tri neighbors,
    B2 = fuse neighbors, N = keypoint capacity, V = fuse-view capacity."""

    n_kp: int
    b1: int = 4
    b2: int = 2
    view_cap: int = 2048

    @property
    def offsets(self):
        N, B1, B2, V = self.n_kp, self.b1, self.b2, self.view_cap
        o = {}
        c = 0
        nw = -(-N // 32)
        for name, size in (
            ("slots_tri", B1), ("slots_fuse", B2),
            ("poses_tri", B1 * 16), ("poses_fuse", B2 * 16),
            ("free_tri", B1 * nw), ("valid_fuse", B2 * nw),  # bit-packed
            ("view", V * VIEW_INTS_PER_PT),
        ):
            o[name] = c
            c += size
        o["_total"] = c
        return o


def pack_kf_stage(layout: KfStageLayout, store, kf_id: int,
                  slots_tri: np.ndarray, nbs_tri: list[int],
                  slots_fuse: np.ndarray, nbs_fuse: list[int],
                  n_tri_real: int, n_fuse_real: int,
                  view_pids: np.ndarray) -> np.ndarray:
    N, B1, B2, V = layout.n_kp, layout.b1, layout.b2, layout.view_cap
    poses_tri = store.kf_pose[[kf_id] + nbs_tri].astype(np.float32)
    poses_fuse = store.kf_pose[nbs_fuse].astype(np.float32)
    free_tri = np.zeros((B1, N), bool)
    free_tri[0] = store.kf_kp_valid[kf_id] & (store.kf_pt_ids[kf_id] < 0)
    for i, nb in enumerate(nbs_tri[:n_tri_real]):
        free_tri[1 + i] = store.kf_kp_valid[nb] & (store.kf_pt_ids[nb] < 0)
    valid_fuse = np.zeros((B2, N), bool)
    for i, nb in enumerate(nbs_fuse[:n_fuse_real]):
        valid_fuse[i] = store.kf_kp_valid[nb]
    return np.concatenate([
        slots_tri.astype(np.int32), slots_fuse.astype(np.int32),
        _bc_f(poses_tri), _bc_f(poses_fuse),
        np_pack_bits_rows(free_tri).reshape(-1),
        np_pack_bits_rows(valid_fuse).reshape(-1),
        pack_view(store, view_pids, V),
    ])


@partial(jax.jit, static_argnames=("cam", "layout", "n_levels", "scale"))
def kf_stage_cached(cam: StereoCamera, layout: KfStageLayout,
                    cache: CacheArrays, buf: jnp.ndarray,
                    inv_sigma2_lut: jnp.ndarray,
                    n_levels: int, scale: float):
    """One program for both KF-rate association stages. Returns
    (tri_bufs (B1-1, L), fuse_bufs (B2, V+N))."""
    N, B1, B2, V = layout.n_kp, layout.b1, layout.b2, layout.view_cap
    o = layout.offsets
    slots_tri = _slice_i(buf, o["slots_tri"], (B1,))
    slots_fuse = _slice_i(buf, o["slots_fuse"], (B2,))
    poses_tri = _slice_f(buf, o["poses_tri"], (B1, 4, 4))
    poses_fuse = _slice_f(buf, o["poses_fuse"], (B2, 4, 4))
    nw = -(-N // 32)
    free_tri = unpack_bits_rows_dev(
        _slice_i(buf, o["free_tri"], (B1, nw)), N)
    valid_fuse = unpack_bits_rows_dev(
        _slice_i(buf, o["valid_fuse"], (B2, nw)), N)
    view = unpack_view(buf, o["view"], V)

    s0 = jnp.maximum(slots_tri[0], 0)
    xy1, desc1, oct1 = cache.xy[s0], cache.desc[s0], cache.octave[s0]

    def tri_one(slot, T2, free2):
        s = jnp.maximum(slot, 0)
        return mapping_ops.triangulate_pair(
            cam, poses_tri[0], T2, xy1, desc1, oct1, free_tri[0],
            cache.xy[s], cache.desc[s], cache.octave[s], free2,
            inv_sigma2_lut)

    tri_bufs = jax.vmap(tri_one)(slots_tri[1:], poses_tri[1:], free_tri[1:])

    def fuse_one(slot, T, valid):
        s = jnp.maximum(slot, 0)
        feats = matching.FrameFeatures(
            xy=cache.xy[s], ur=cache.ur[s], octave=cache.octave[s],
            angle=cache.angle[s], desc=cache.desc[s], valid=valid)
        return mapping_ops.fuse_candidates(
            cam, T, view, feats, n_levels=n_levels, scale=scale)

    fuse_bufs = jax.vmap(fuse_one)(slots_fuse, poses_fuse, valid_fuse)
    return tri_bufs, fuse_bufs


@partial(jax.jit, static_argnames=("cam", "layout", "n_levels", "scale",
                                   "voc_L"))
def kf_stage_words_flat(cam: StereoCamera, layout: KfStageLayout,
                        cache: CacheArrays, buf: jnp.ndarray,
                        inv_sigma2_lut: jnp.ndarray,
                        voc_ch, voc_nd, voc_nw,
                        n_levels: int, scale: float, voc_L: int):
    """kf_stage_cached + the new keyframe's BoW vocabulary descent in ONE
    program, flattened for a single readback. The descent consumes the KF's
    cached device descriptors (zero upload) instead of a separate dispatch
    and readback.
    Returns the concat [tri | fuse | words] plus the component shapes."""
    from ..loop.bow import _descend

    tri_bufs, fuse_bufs = kf_stage_cached(
        cam, layout, cache, buf, inv_sigma2_lut, n_levels, scale)
    s0 = jnp.maximum(_slice_i(buf, layout.offsets["slots_tri"], (1,))[0], 0)
    words = _descend(voc_ch, voc_nd, voc_nw, cache.desc[s0], voc_L)
    words = jnp.where(cache.valid[s0], words, -1)
    flat = jnp.concatenate([tri_bufs.reshape(-1), fuse_bufs.reshape(-1),
                            words.astype(jnp.int32)])
    # tri/fuse ride back only inside `flat`; the component arrays are
    # returned for their STATIC shapes (callers never fetch them)
    return flat, tri_bufs, fuse_bufs


# ---------------------------------------------------------------------------
# BA stage: windowed BA + on-device tracking-view assembly, one upload
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BaLayout:
    """Static layout for the BA buffer. k_cap window KFs, p_bkt points,
    o_bkt observations, tv_cap tracking-view slots."""

    k_cap: int
    p_bkt: int
    o_bkt: int
    tv_cap: int
    n_kp: int

    @property
    def offsets(self):
        K, P, O, V = self.k_cap, self.p_bkt, self.o_bkt, self.tv_cap
        o = {}
        c = 0
        for name, size in (
            ("slots", K), ("poses", K * 16), ("fixed", K),
            ("points", P * 3), ("pvalid", P),
            # one word per observation: (k * 8192 + feature) * p_bkt + p
            # (fits int32 for k_cap <= 24, n_kp <= 8192, p_bkt <= 8192;
            # two separate words cost 48-96 KB extra upload per keyframe)
            ("obs_w", O), ("obs_n", 1),
            ("tv_pidx", V),   # view slot -> problem point index or -1
            ("tv_view", V * VIEW_INTS_PER_PT),
        ):
            o[name] = c
            c += size
        o["_total"] = c
        return o


def pack_ba(layout: BaLayout, store, window: np.ndarray, slots: np.ndarray,
            n_free: int, pts: np.ndarray, okf: np.ndarray, ofe: np.ndarray,
            p_idx: np.ndarray, view_pids: np.ndarray,
            view_p_idx: np.ndarray) -> np.ndarray:
    K, P, O, V = layout.k_cap, layout.p_bkt, layout.o_bkt, layout.tv_cap
    slots_pad = np.zeros(K, np.int32)
    slots_pad[: len(slots)] = slots
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[: len(window)] = store.kf_pose[window]
    fixed = np.ones(K, np.int32)
    fixed[:n_free] = 0
    points = np.zeros((P, 3), np.float32)
    points[: len(pts)] = store.pt_pos[pts]
    pvalid = np.zeros(P, np.int32)
    pvalid[: len(pts)] = store.pt_valid[pts]
    n_obs = len(okf)
    obs_w = np.zeros(O, np.int32)
    obs_w[:n_obs] = ((okf.astype(np.int64) * 8192 + ofe.astype(np.int64))
                     * P + p_idx).astype(np.int32)
    tv_pidx = np.full(V, -1, np.int32)
    tv_pidx[: len(view_p_idx)] = view_p_idx
    return np.concatenate([
        slots_pad, _bc_f(poses), fixed, _bc_f(points), pvalid,
        obs_w, np.array([n_obs], np.int32),
        tv_pidx, pack_view(store, view_pids, V),
    ])


@partial(jax.jit, static_argnames=("cam", "layout"))
def ba_view_cached(cam: StereoCamera, layout: BaLayout, cache: CacheArrays,
                   buf: jnp.ndarray, inv_sigma2_lut: jnp.ndarray):
    """Windowed local BA with observations gathered from the KF cache, plus
    on-device assembly of the tracker's post-BA local-map view.

    Returns (result_buf, MapPointView). result_buf = [poses bitcast |
    points bitcast | keep] as in ba.local_ba_packed."""
    from ..optim import ba

    K, P, O, V = layout.k_cap, layout.p_bkt, layout.o_bkt, layout.tv_cap
    o = layout.offsets
    slots = _slice_i(buf, o["slots"], (K,))
    poses = _slice_f(buf, o["poses"], (K, 4, 4))
    fixed = _slice_i(buf, o["fixed"], (K,)) > 0
    points = _slice_f(buf, o["points"], (P, 3))
    pvalid = _slice_i(buf, o["pvalid"], (P,)) > 0
    obs_w = _slice_i(buf, o["obs_w"], (O,))
    n_obs = _slice_i(buf, o["obs_n"], (1,))[0]
    tv_pidx = _slice_i(buf, o["tv_pidx"], (V,))
    tv = unpack_view(buf, o["tv_view"], V)

    obs_kfe = obs_w // P
    obs_p = obs_w % P
    obs_k = obs_kfe // 8192
    obs_fe = obs_kfe % 8192
    slot = slots[obs_k]
    uv = cache.xy[slot, obs_fe]
    ur = cache.ur[slot, obs_fe]
    oct_ = cache.octave[slot, obs_fe]
    ovalid = jnp.arange(O) < n_obs
    obs = ba.BAObs(
        k=obs_k, p=obs_p,
        uvr=jnp.concatenate([uv, ur[:, None]], -1),
        inv_sigma2=inv_sigma2_lut[oct_],
        is_stereo=ur >= 0,
        valid=ovalid,
    )
    problem = ba.BAProblem(poses=poses, points=points, pose_fixed=fixed,
                           point_valid=pvalid, obs=obs)
    solved, keep = ba.local_ba(cam, problem)
    bcast = lambda a: jax.lax.bitcast_convert_type(a, jnp.int32)
    result = jnp.concatenate([
        bcast(solved.poses.reshape(-1)),
        bcast(solved.points.reshape(-1)),
        pack_bits_dev(keep),
    ])
    # post-BA tracking view: solved position where the point is in the
    # problem, uploaded (host) position otherwise
    in_ba = tv_pidx >= 0
    pos = jnp.where(in_ba[:, None],
                    solved.points[jnp.maximum(tv_pidx, 0)], tv.pos)
    view = matching.MapPointView(pos=pos, desc=tv.desc, normal=tv.normal,
                                 min_dist=tv.min_dist, max_dist=tv.max_dist,
                                 valid=tv.valid)
    return result, view


# ---------------------------------------------------------------------------
# joint point+line BA (LLD's differentiator): base BA buffer + line block
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class JointBaLayout:
    """BaLayout extended with the map-line block (AddLineMinimal local BA,
    reference src/Optimizer.cc:936-1388 line edges + src/LineOptimizer)."""

    base: BaLayout
    l_cap: int
    lo_cap: int
    desc_dim: int = 40  # unused in BA; kept for layout symmetry

    @property
    def offsets(self):
        o = dict(self.base.offsets)
        c = o.pop("_total")
        LC, LO = self.l_cap, self.lo_cap
        for name, size in (
            ("ln_x0", LC * 3), ("ln_dir", LC * 3), ("ln_valid", LC),
            ("lo_kl", LO),      # k * 4096 + line index
            ("lo_x", LO * 8),   # x1l x2l x1r x2r (4 endpoints x 2)
            ("lo_oct", LO), ("lo_hasr", LO), ("lo_n", 1),
        ):
            o[name] = c
            c += size
        o["_total"] = c
        return o


def pack_joint_ba(layout: JointBaLayout, store, window, slots, n_free, pts,
                  okf, ofe, p_idx, view_pids, view_p_idx,
                  lids: np.ndarray, lo_wk: np.ndarray, lo_wd: np.ndarray,
                  lo_lidx: np.ndarray) -> np.ndarray:
    base = pack_ba(layout.base, store, window, slots, n_free, pts, okf, ofe,
                   p_idx, view_pids, view_p_idx)
    LC, LO = layout.l_cap, layout.lo_cap
    s = store
    x0 = np.zeros((LC, 3), np.float32)
    dr = np.tile(np.array([1, 0, 0], np.float32), (LC, 1))
    lv = np.zeros(LC, np.int32)
    L = len(lids)
    x0[:L] = s.ln_x0[lids]
    dr[:L] = s.ln_dir[lids]
    lv[:L] = 1
    O = len(lo_wk)
    kl = np.zeros(LO, np.int32)
    kl[:O] = lo_wk.astype(np.int32) * 4096 + lo_lidx.astype(np.int32)
    kf_abs = window[lo_wk] if O else np.zeros(0, np.int64)
    xs = np.zeros((LO, 8), np.float32)
    oct_ = np.zeros(LO, np.int32)
    hasr = np.zeros(LO, np.int32)
    if O:
        xs[:O, 0:2] = s.kf_ln_p1[kf_abs, lo_wd]
        xs[:O, 2:4] = s.kf_ln_p2[kf_abs, lo_wd]
        xs[:O, 4:6] = s.kf_ln_p1r[kf_abs, lo_wd]
        xs[:O, 6:8] = s.kf_ln_p2r[kf_abs, lo_wd]
        oct_[:O] = s.kf_ln_oct[kf_abs, lo_wd]
        hasr[:O] = s.kf_ln_has_r[kf_abs, lo_wd]
    return np.concatenate([
        base, _bc_f(x0), _bc_f(dr), lv, kl, _bc_f(xs), oct_, hasr,
        np.array([O], np.int32)])


@partial(jax.jit, static_argnames=("cam", "layout", "gamma"))
def joint_ba_view_cached(cam: StereoCamera, layout: JointBaLayout,
                         cache: CacheArrays, buf: jnp.ndarray,
                         inv_sigma2_lut: jnp.ndarray, gamma: float):
    """Joint point+line windowed BA with cache-gathered point observations
    and on-device view assembly. Returns (result_buf as
    lines_ba.local_joint_ba_packed, MapPointView)."""
    from ..geometry import lines as glines
    from ..optim import ba, lines_ba

    bl = layout.base
    K, P, O, V = bl.k_cap, bl.p_bkt, bl.o_bkt, bl.tv_cap
    o = layout.offsets
    slots = _slice_i(buf, o["slots"], (K,))
    poses = _slice_f(buf, o["poses"], (K, 4, 4))
    fixed = _slice_i(buf, o["fixed"], (K,)) > 0
    points = _slice_f(buf, o["points"], (P, 3))
    pvalid = _slice_i(buf, o["pvalid"], (P,)) > 0
    obs_w = _slice_i(buf, o["obs_w"], (O,))
    n_obs = _slice_i(buf, o["obs_n"], (1,))[0]
    tv_pidx = _slice_i(buf, o["tv_pidx"], (V,))
    tv = unpack_view(buf, o["tv_view"], V)
    LC, LO = layout.l_cap, layout.lo_cap
    ln_x0 = _slice_f(buf, o["ln_x0"], (LC, 3))
    ln_dir = _slice_f(buf, o["ln_dir"], (LC, 3))
    ln_valid = _slice_i(buf, o["ln_valid"], (LC,)) > 0
    lo_kl = _slice_i(buf, o["lo_kl"], (LO,))
    lo_x = _slice_f(buf, o["lo_x"], (LO, 8))
    lo_oct = _slice_i(buf, o["lo_oct"], (LO,))
    lo_hasr = _slice_i(buf, o["lo_hasr"], (LO,)) > 0
    lo_n = _slice_i(buf, o["lo_n"], (1,))[0]

    obs_kfe = obs_w // P
    obs_p = obs_w % P
    obs_k = obs_kfe // 8192
    obs_fe = obs_kfe % 8192
    slot = slots[obs_k]
    uv = cache.xy[slot, obs_fe]
    ur = cache.ur[slot, obs_fe]
    oct_ = cache.octave[slot, obs_fe]
    obs = ba.BAObs(
        k=obs_k, p=obs_p,
        uvr=jnp.concatenate([uv, ur[:, None]], -1),
        inv_sigma2=inv_sigma2_lut[oct_],
        is_stereo=ur >= 0,
        valid=jnp.arange(O) < n_obs,
    )
    problem = ba.BAProblem(poses=poses, points=points, pose_fixed=fixed,
                           point_valid=pvalid, obs=obs)
    q, alpha = glines.minimal_from_x0dir(ln_x0, ln_dir)
    lobs = lines_ba.LineBAObs(
        k=lo_kl // 4096, l=lo_kl % 4096,
        x1l=lo_x[:, 0:2], x2l=lo_x[:, 2:4],
        x1r=lo_x[:, 4:6], x2r=lo_x[:, 6:8],
        octave=lo_oct, has_r=lo_hasr,
        valid=jnp.arange(LO) < lo_n,
    )
    joint = lines_ba.JointProblem(base=problem, q=q, alpha=alpha,
                                  line_valid=ln_valid, lobs=lobs)
    solved, keep_p, keep_l = lines_ba.local_joint_ba(cam, joint, gamma)
    X0n, dn = glines.x0dir_from_minimal(solved.q, solved.alpha)
    bcast = lambda a: jax.lax.bitcast_convert_type(a, jnp.int32)
    result = jnp.concatenate([
        bcast(solved.base.poses.reshape(-1)),
        bcast(solved.base.points.reshape(-1)),
        bcast(X0n.reshape(-1)),
        bcast(dn.reshape(-1)),
        pack_bits_dev(keep_p),
        pack_bits_dev(keep_l),
    ])
    in_ba = tv_pidx >= 0
    pos = jnp.where(in_ba[:, None],
                    solved.base.points[jnp.maximum(tv_pidx, 0)], tv.pos)
    view = matching.MapPointView(pos=pos, desc=tv.desc, normal=tv.normal,
                                 min_dist=tv.min_dist, max_dist=tv.max_dist,
                                 valid=tv.valid)
    return result, view


# ---------------------------------------------------------------------------
# cache backfill: upload an un-cached keyframe's features in one transfer
# ---------------------------------------------------------------------------

def pack_kf_feats(store, kf_id: int) -> np.ndarray:
    return np.concatenate([
        _bc_f(store.kf_xy[kf_id]), _bc_f(store.kf_ur[kf_id]),
        store.kf_oct[kf_id].astype(np.int32).reshape(-1),
        _bc_f(store.kf_angle[kf_id]), _bc_u(store.kf_desc[kf_id]),
        store.kf_kp_valid[kf_id].astype(np.int32),
    ])


@partial(jax.jit, static_argnames=("n_kp",))
def unpack_kf_feats(buf: jnp.ndarray, n_kp: int) -> matching.FrameFeatures:
    N = n_kp
    o = 0
    xy = _slice_f(buf, o, (N, 2)); o += 2 * N
    ur = _slice_f(buf, o, (N,)); o += N
    oct_ = _slice_i(buf, o, (N,)); o += N
    angle = _slice_f(buf, o, (N,)); o += N
    desc = _slice_u(buf, o, (N, 8)); o += 8 * N
    valid = _slice_i(buf, o, (N,)) > 0
    return matching.FrameFeatures(xy=xy, ur=ur, octave=oct_, angle=angle,
                                  desc=desc, valid=valid)


def np_pack_bits_rows(a: np.ndarray) -> np.ndarray:
    """(B, N) bool -> (B, ceil(N/32)) int32 little-endian bit words (host
    side; inverse of unpack_bits_rows_dev)."""
    b = np.packbits(a, axis=1, bitorder="little")
    pad = (-b.shape[1]) % 4
    if pad:
        b = np.concatenate(
            [b, np.zeros((b.shape[0], pad), np.uint8)], axis=1)
    return b.view(np.int32)


def unpack_bits_rows_dev(w: jnp.ndarray, n: int) -> jnp.ndarray:
    """(B, ceil(n/32)) int32 -> (B, n) bool on device."""
    wu = jax.lax.bitcast_convert_type(w, jnp.uint32)
    bits = (wu[:, :, None] >> jnp.arange(32, dtype=jnp.uint32)) & 1
    return bits.reshape(w.shape[0], -1)[:, :n] > 0


def pack_bits_dev(b: jnp.ndarray) -> jnp.ndarray:
    """(M,) bool -> (ceil(M/32),) int32 little-endian bit words (32x
    smaller readback for the BA keep masks)."""
    m = b.shape[0]
    pad = (-m) % 32
    if pad:
        b = jnp.concatenate([b, jnp.zeros(pad, bool)])
    w = (b.reshape(-1, 32).astype(jnp.uint32)
         << jnp.arange(32, dtype=jnp.uint32)[None]).sum(
             axis=-1, dtype=jnp.uint32)
    return jax.lax.bitcast_convert_type(w, jnp.int32)


def unpack_bits_np(w: np.ndarray, m: int) -> np.ndarray:
    """Inverse of pack_bits_dev on host."""
    bits = np.unpackbits(w.view(np.uint8), bitorder="little")
    return bits[:m].astype(bool)


def n_bit_words(m: int) -> int:
    return -(-m // 32)


@jax.jit
def concat_flat(*arrs):
    """Flatten + concatenate int32 device buffers into ONE vector so the
    host fetches them in a single device_get (one transfer latency instead
    of one per buffer)."""
    return jnp.concatenate([a.reshape(-1) for a in arrs])


# ---------------------------------------------------------------------------
# fused keyframe stage + windowed BA: ONE upload, ONE readback per keyframe
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cam", "slay", "blay", "n_levels",
                                   "scale", "voc_L"))
def fused_kf_ba_flat(cam: StereoCamera, slay: KfStageLayout, blay: BaLayout,
                     cache: CacheArrays, buf: jnp.ndarray,
                     inv_sigma2_lut: jnp.ndarray,
                     voc_ch, voc_nd, voc_nw,
                     n_levels: int, scale: float, voc_L: int):
    """Triangulation + fusion (+BoW descent) AND the windowed local BA of
    the same keyframe in ONE program over ONE uploaded buffer, flattened
    for ONE readback. Separately dispatched, the keyframe path makes 4
    transfers (stage put, stage fetch, BA put, BA fetch); fused it makes 2.
    The BA consumes the store state at
    keyframe-creation time (this KF's triangulations join the NEXT window's
    BA) — the deterministic analogue of the reference's mbAbortBA-
    interrupted local BA under keyframe-burst load (LocalMapping.cc
    InterruptBA; Optimizer.cc:473 pbStopFlag). voc_L=0 compiles the
    no-vocabulary variant (loop closing disabled)."""
    n_st = slay.offsets["_total"]
    if voc_L:
        flat, tri_bufs, fuse_bufs = kf_stage_words_flat(
            cam, slay, cache, buf[:n_st], inv_sigma2_lut,
            voc_ch, voc_nd, voc_nw, n_levels, scale, voc_L)
    else:
        tri_bufs, fuse_bufs = kf_stage_cached(
            cam, slay, cache, buf[:n_st], inv_sigma2_lut, n_levels, scale)
        flat = concat_flat(tri_bufs, fuse_bufs)
    result, view = ba_view_cached(cam, blay, cache, buf[n_st:],
                                  inv_sigma2_lut)
    return jnp.concatenate([flat, result]), tri_bufs, fuse_bufs, view


@partial(jax.jit, static_argnames=("cam", "slay", "jlay", "n_levels",
                                   "scale", "voc_L", "gamma"))
def fused_kf_joint_ba_flat(cam: StereoCamera, slay: KfStageLayout,
                           jlay: JointBaLayout, cache: CacheArrays,
                           buf: jnp.ndarray, inv_sigma2_lut: jnp.ndarray,
                           voc_ch, voc_nd, voc_nw,
                           n_levels: int, scale: float, voc_L: int,
                           gamma: float):
    """fused_kf_ba_flat with the joint point+line windowed BA."""
    n_st = slay.offsets["_total"]
    if voc_L:
        flat, tri_bufs, fuse_bufs = kf_stage_words_flat(
            cam, slay, cache, buf[:n_st], inv_sigma2_lut,
            voc_ch, voc_nd, voc_nw, n_levels, scale, voc_L)
    else:
        tri_bufs, fuse_bufs = kf_stage_cached(
            cam, slay, cache, buf[:n_st], inv_sigma2_lut, n_levels, scale)
        flat = concat_flat(tri_bufs, fuse_bufs)
    result, view = joint_ba_view_cached(cam, jlay, cache, buf[n_st:],
                                        inv_sigma2_lut, gamma)
    return jnp.concatenate([flat, result]), tri_bufs, fuse_bufs, view
