"""Deterministic per-frame stereo tracking.

Replaces the Tracking thread of the reference (`Tracking::Track`,
src/Tracking.cc:293-518) with a synchronous schedule (design stance
SURVEY.md §7): every frame runs

    build_frame -> motion-model match -> pose opt -> local-map match
    -> pose opt -> KF decision -> (on KF) map update + local BA

All per-feature compute is jitted device code with fixed shapes; the host
only sequences calls and updates the SoA map at keyframe rate.

Key reference semantics kept:
- stereo initialization needs > 250 depth'd keypoints (Tracking.cc:520-556),
- motion-model matching with radius 7, retried at 2x on failure
  (Tracking.cc:907-911), minimum 7 matches (Tracking.cc:992),
- TrackLocalMap succeeds at >= 15 inliers (>=25 right after reloc)
  (Tracking.cc:1206-1217),
- keyframe insertion when tracked matches fall under 75% of the reference
  KF's, or too few close points are tracked (NeedNewKeyFrame,
  Tracking.cc:1223-1310),
- close-point creation at each new KF: all features closer than ThDepth,
  or the 100 nearest (CreateNewKeyFrame, Tracking.cc:1386-1430),
- per-frame relative-pose bookkeeping for trajectory replay
  (Tracking.cc:497-514).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig
from ..frontend import matching
from ..frontend.frame import FrameData, build_frame, build_frame_pair
from ..geometry import se3
from ..geometry.camera import StereoCamera
from ..ops import hamming
from ..optim import pose_opt
from ..slammap.map_store import MapStore
from . import local_mapping


class TrackState(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


@partial(jax.jit, static_argnames=("cam",))
def _gather_pose_obs(
    cam: StereoCamera,
    pt_pos: jnp.ndarray,       # (P, 3) padded local point positions
    kp2pt: jnp.ndarray,        # (N,) local point index per keypoint or -1
    feats: matching.FrameFeatures,
    inv_sigma2_lut: jnp.ndarray,  # (L,) per-octave information
) -> pose_opt.PointPoseObs:
    """Per-keypoint observation table for pose-only optimization — the
    analogue of building mono/stereo g2o edges from mvpMapPoints
    (Optimizer.cc:712-804), fixed shape (N,)."""
    idx = jnp.maximum(kp2pt, 0)
    X = pt_pos[idx]
    obs = jnp.concatenate([feats.xy, feats.ur[:, None]], axis=-1)
    return pose_opt.PointPoseObs(
        X=X,
        obs=obs,
        inv_sigma2=inv_sigma2_lut[feats.octave],
        is_stereo=feats.ur >= 0,
        valid=(kp2pt >= 0) & feats.valid,
    )


def _prov_update(decide, prov_parts):
    """Next-frame provisional-identity table: when the on-device keyframe
    decision fires, the frame's close unassociated features become the
    provisional points (their own feature index is the identity the host
    resolves against the created keyframe); otherwise the carried table
    propagates (see _track_core docstring)."""
    carried, close_unassoc = prov_parts
    n = carried.shape[0]
    fresh = jnp.where(close_unassoc, jnp.arange(n, dtype=jnp.int32), -1)
    return jnp.where(decide > 0, fresh, carried)


def _pack_bits(b: jnp.ndarray) -> jnp.ndarray:
    """(M,) bool -> (ceil(M/32),) int32 little-endian bit words."""
    m = b.shape[0]
    pad = (-m) % 32
    if pad:
        b = jnp.concatenate([b, jnp.zeros(pad, bool)])
    w = (b.reshape(-1, 32).astype(jnp.uint32)
         << jnp.arange(32, dtype=jnp.uint32)[None]).sum(
             axis=-1, dtype=jnp.uint32)
    return jax.lax.bitcast_convert_type(w, jnp.int32)


def _unpack_bits_np(w: "np.ndarray", m: int) -> "np.ndarray":
    """Inverse of _pack_bits on host."""
    bits = np.unpackbits(w.view(np.uint8), bitorder="little")
    return bits[:m].astype(bool)


def _kf_decision(packed, since_kf, kf_scal, min_gap: int, max_gap: int):
    """On-device NeedNewKeyFrame (Tracking.cc:1223-1310): computed INSIDE the
    chained step from the per-frame stats so the decision carries ZERO
    readback latency — the host only reacts to the flag when the ring window
    arrives, which lets the readback window widen without stale decisions
    over-firing keyframes (the round-3 ceiling). `since_kf` is a device
    counter of frames since the last fired decision (the min-gap/max-gap
    gates stay exact for in-flight frames). `kf_scal` = [ref_m, kappa]:
    ref_m is the reference-KF tracked-point count; when a decision fires it
    is refreshed ON DEVICE as kappa * n_in — the new reference IS this
    frame, and kappa calibrates the frame's inlier count down to the >=3-
    observation count the host actually uses (_refresh_ref_matches), as
    measured at the previous keyframe. The host's exact value (and a fresh
    kappa) swaps in via a side-thread upload once the keyframe is created.
    Without the calibration the raw n_in over-estimates ref_m ~2x and the
    weak gate fires a keyframe every min_gap frames (measured 16 KFs/40
    frames vs the host schedule's 10)."""
    stats = packed[16:22]
    n_in, tracked_close, untracked_close = stats[1], stats[2], stats[3]
    ref_m, kappa = kf_scal[0], kf_scal[1]
    gap = since_kf + 1
    weak = n_in.astype(jnp.float32) < 0.75 * ref_m
    need_close = (tracked_close < 100) & (untracked_close > 70)
    too_old = gap >= max_gap
    decide = (n_in > 15) & (gap >= min_gap) \
        & (weak | need_close | too_old)
    since2 = jnp.where(decide, 0, gap)
    refm2 = jnp.where(decide, kappa * n_in.astype(jnp.float32), ref_m)
    return decide.astype(jnp.int32), since2, jnp.stack([refm2, kappa])


@partial(jax.jit, static_argnames=("cam", "n_levels", "scale", "min_mm",
                                   "close_depth", "min_gap", "max_gap",
                                   "n_snap"))
def _track_step_chained(
    cam: StereoCamera,
    T_prev: jnp.ndarray,
    vel_prev: jnp.ndarray,
    last_feats: matching.FrameFeatures,
    last_ptpos: jnp.ndarray,
    last_haspt: jnp.ndarray,
    cur: matching.FrameFeatures,
    depth: jnp.ndarray,
    view: matching.MapPointView,
    inv_sigma2_lut: jnp.ndarray,
    last_ismap: jnp.ndarray,
    last_prov: jnp.ndarray,
    since_kf: jnp.ndarray,
    kf_scal: jnp.ndarray,
    ring: jnp.ndarray,
    slot: jnp.ndarray,
    n_levels: int,
    scale: float,
    min_mm: int,
    close_depth: float,
    min_gap: int,
    max_gap: int,
    snap: jnp.ndarray | None = None,
    snap_cnt: jnp.ndarray | None = None,
    n_snap: int = 0,
):
    """Pipelined variant: the motion prediction T_pred = vel @ T_prev and the
    velocity update happen ON DEVICE, so frame i+1 can be dispatched before
    frame i's results ever reach the host (the host finalizes with a 1-frame
    lag — the deterministic analogue of the reference's tracking-vs-mapping
    thread overlap).

    `ring` (W, L) is a device-resident accumulator of the last W frames'
    packed outputs: each step writes its row at `slot`, and the host fetches
    the WHOLE ring in one device_get every W frames, so one readback
    serves W frames (see StereoTracker.readback_window; kept until a W=1
    schedule is measured on the GPU, ROADMAP Design). The keyframe decision
    runs on device
    too (_kf_decision) and rides the packed row at index 22. Returns
    (packed, ptpos2, haspt2, ismap2, prov2, T2, vel2, ring', since_kf',
    kf_scal')."""
    T_pred = vel_prev @ T_prev
    packed, ptpos2, haspt2, ismap2, prov_parts, _, T2 = _track_core(
        cam, T_pred, last_feats, last_ptpos, last_haspt, last_ismap,
        last_prov, cur, depth, view, inv_sigma2_lut, n_levels, scale,
        min_mm, close_depth)
    decide, since2, scal2 = _kf_decision(packed, since_kf, kf_scal,
                                         min_gap, max_gap)
    prov2 = _prov_update(decide, prov_parts)
    packed = jnp.concatenate([packed[:22], decide[None], packed[22:]])
    vel2 = T2 @ jnp.linalg.inv(T_prev)
    # flat ring layout [W rows of packed | n_snap snapshot slots]: the
    # frame snapshot is stashed into a KF slot ONLY when the on-device
    # decision fires (cnt advances on decide), so the window fetch carries
    # W small rows + ~W/min_gap snapshots instead of W full snapshots
    # (the snapshot is most of a row's bytes)
    L = packed.shape[0]
    ring = jax.lax.dynamic_update_slice(ring, packed, (slot * L,))
    cnt2 = snap_cnt
    if snap is not None and n_snap > 0:
        off = ring.shape[0] - n_snap * snap.shape[0] \
            + (snap_cnt % n_snap) * snap.shape[0]
        ring = jax.lax.dynamic_update_slice(ring, snap, (off,))
        cnt2 = snap_cnt + decide
    return (packed, ptpos2, haspt2, ismap2, prov2, T2, vel2, ring, since2,
            scal2, cnt2)


@partial(jax.jit, static_argnames=("cam", "n_levels", "scale", "min_mm",
                                   "close_depth"))
def _track_step(
    cam: StereoCamera,
    T_pred: jnp.ndarray,
    last_feats: matching.FrameFeatures,
    last_ptpos: jnp.ndarray,
    last_haspt: jnp.ndarray,
    last_ismap: jnp.ndarray,
    last_prov: jnp.ndarray,
    cur: matching.FrameFeatures,
    depth: jnp.ndarray,
    view: matching.MapPointView,
    inv_sigma2_lut: jnp.ndarray,
    n_levels: int,
    scale: float,
    min_mm: int,
    close_depth: float,
):
    return _track_core(cam, T_pred, last_feats, last_ptpos, last_haspt,
                       last_ismap, last_prov, cur, depth, view,
                       inv_sigma2_lut, n_levels, scale, min_mm, close_depth)


def _track_core(
    cam: StereoCamera,
    T_pred: jnp.ndarray,
    last_feats: matching.FrameFeatures,
    last_ptpos: jnp.ndarray,
    last_haspt: jnp.ndarray,
    last_ismap: jnp.ndarray,
    last_prov: jnp.ndarray,
    cur: matching.FrameFeatures,
    depth: jnp.ndarray,
    view: matching.MapPointView,
    inv_sigma2_lut: jnp.ndarray,
    n_levels: int,
    scale: float,
    min_mm: int,
    close_depth: float,
):
    """The whole per-frame tracking math as ONE device program:
    motion-model match (narrow + wide, selected on-device) -> pose opt ->
    local-map projection search -> pose opt -> stats. Fusing the stages into
    a single XLA computation removes ~8 host<->device round trips per
    frame.

    TEMPORAL ("visual odometry") seeding: the reference creates depth-
    unprojected temporary MapPoints for the last frame's close features so
    motion-model tracking never starves (UpdateLastFrame,
    Tracking.cc:830-883 — gated there on localization-only mode because the
    concurrent LocalMapping thread keeps the full-SLAM map fresh). In this
    deterministic pipeline the map update is staged several frames behind
    the dispatch chain, so the SAME mechanism runs every frame ON DEVICE:
    close features without a landmark carry a depth-unprojected position
    into the next frame's chain. The `last_ismap` mask keeps the keyframe-
    decision statistics map-only (mnMatchesInliers counts real MapPoints,
    Tracking.cc:1206), so temporal matches stabilize the POSE without
    masking map starvation from NeedNewKeyFrame.

    PROVISIONAL identity (`last_prov`): when the on-device KF decision
    fires, the frame's close unassociated features are exactly the points
    CreateNewKeyFrame will make (Tracking.cc:1386-1430). Their origin
    feature index is seeded into the chain (_prov_update) and PROPAGATED
    through the per-frame matches here, so (a) they count as map matches
    in the decision statistics — the reference's mapper makes them real
    within a frame, ours within a readback window — and (b) the host
    resolves them to the created point ids at finalize, recording real
    observations. Without this, every feature born between readbacks is
    invisible to the map for the full fetch latency and the tracked-close
    statistic collapses (measured: n_in 1355 -> 25 over 30 frames).

    Returns (packed, new_ptpos (N,3), new_haspt (N,), new_ismap (N,),
    new_prov (N,), final_ok (N,) — association inliers incl. temporal, for
    the line-step pose observations — and T2 (4,4)).
    """
    obs = jnp.concatenate([cur.xy, cur.ur[:, None]], axis=-1)
    lut = inv_sigma2_lut[cur.octave]
    is_stereo = cur.ur >= 0

    # --- motion-model association (Tracking.cc:885-994) ---
    kp2last_a = matching.match_last_frame(
        cam, T_pred, last_feats, last_ptpos, last_haspt, cur,
        n_levels=n_levels, scale=scale, radius=7.0)
    n_a = jnp.sum(kp2last_a >= 0)
    kp2last_b = matching.match_last_frame(
        cam, T_pred, last_feats, last_ptpos, last_haspt, cur,
        n_levels=n_levels, scale=scale, radius=14.0)
    kp2last = jnp.where(n_a >= 20, kp2last_a, kp2last_b)
    n_mm = jnp.sum(kp2last >= 0)
    has_mm = n_mm >= min_mm

    pobs1 = pose_opt.PointPoseObs(
        X=last_ptpos[jnp.maximum(kp2last, 0)],
        obs=obs, inv_sigma2=lut, is_stereo=is_stereo,
        valid=(kp2last >= 0) & cur.valid)
    T1, pt_in1, _, _ = pose_opt.optimize_pose(cam, T_pred, pobs1)
    T1 = jnp.where(has_mm, T1, T_pred)
    kp2last = jnp.where(pt_in1 & has_mm, kp2last, -1)

    # --- local-map association + final pose (Tracking.cc:1126-1221) ---
    _, kp2pt_l, _, in_frustum = matching.search_by_projection(
        cam, T1, view, cur, n_levels=n_levels, scale=scale, th=1.0)
    use_l = kp2pt_l >= 0
    X2 = jnp.where(use_l[:, None], view.pos[jnp.maximum(kp2pt_l, 0)],
                   last_ptpos[jnp.maximum(kp2last, 0)])
    valid2 = (use_l | (kp2last >= 0)) & cur.valid
    pobs2 = pose_opt.PointPoseObs(
        X=X2, obs=obs, inv_sigma2=lut, is_stereo=is_stereo, valid=valid2)
    T2, pt_in2, _, _ = pose_opt.optimize_pose(cam, T1, pobs2)

    final_ok = valid2 & pt_in2
    # provisional identity carried through the last-frame match
    carried = jnp.where((kp2last >= 0) & final_ok,
                        last_prov[jnp.maximum(kp2last, 0)], -1)
    # map-only association mask: a local-view hit IS a map point; a
    # last-frame hit inherits the carried flag (temporal seeds are False,
    # provisional keyframe-born features count as map — see docstring)
    ismap2 = use_l | ((kp2last >= 0) & last_ismap[jnp.maximum(kp2last, 0)]) \
        | (carried >= 0)
    map_ok = final_ok & ismap2
    n_in = jnp.sum(map_ok)
    # keyframe-decision close-point counts, MAP-only (Tracking.cc:1282-1295)
    close = (depth > 0) & (depth < close_depth) & cur.valid
    tracked_close = jnp.sum(close & map_ok)
    untracked_close = jnp.sum(close & ~map_ok)
    n_kp = jnp.sum(cur.valid)
    n_stereo = jnp.sum((cur.ur >= 0) & cur.valid)
    # next-frame chain state with temporal seeding: associated features keep
    # their landmark (or carried temporal) position; unassociated close
    # features seed from stereo depth at the solved pose
    T_wc = jnp.linalg.inv(T2)
    zc = jnp.maximum(depth, 1e-6)
    Xc = jnp.stack([(cur.xy[:, 0] - cam.cx) * zc / cam.fx,
                    (cur.xy[:, 1] - cam.cy) * zc / cam.fy, zc], axis=-1)
    Xw_depth = Xc @ T_wc[:3, :3].T + T_wc[:3, 3]
    new_ptpos = jnp.where(final_ok[:, None], X2, Xw_depth)
    new_haspt = final_ok | close
    new_ismap = final_ok & ismap2
    close_unassoc = close & ~final_ok
    # pack EVERY host-bound output into ONE int32 vector (pose bitcast in;
    # boolean masks as 32x bit-packed words): one readback per window, and
    # the fewest bytes in it
    packed = jnp.concatenate([
        jax.lax.bitcast_convert_type(T2.reshape(-1), jnp.int32),
        jnp.stack([n_mm, n_in, tracked_close, untracked_close,
                   n_kp, n_stereo]).astype(jnp.int32),
        kp2last.astype(jnp.int32),
        kp2pt_l.astype(jnp.int32),
        _pack_bits(map_ok),
        _pack_bits(in_frustum),
        carried.astype(jnp.int32),
    ])
    return (packed, new_ptpos, new_haspt, new_ismap,
            (carried, close_unassoc), final_ok, T2)


@partial(jax.jit, static_argnames=("cam", "n_levels", "scale", "min_mm",
                                   "close_depth", "gamma", "md_thr",
                                   "min_gap", "max_gap", "n_snap"))
def _track_step_chained_lines(
    cam: StereoCamera,
    T_prev: jnp.ndarray,
    vel_prev: jnp.ndarray,
    last_feats: matching.FrameFeatures,
    last_ptpos: jnp.ndarray,
    last_haspt: jnp.ndarray,
    cur: matching.FrameFeatures,
    depth: jnp.ndarray,
    view: matching.MapPointView,
    inv_sigma2_lut: jnp.ndarray,
    ln_x0, ln_d, ln_desc, ln_oct, ln_valid,   # padded map-line view
    fl,                                        # line_match.FrameLines
    last_ismap: jnp.ndarray,
    last_prov: jnp.ndarray,
    since_kf: jnp.ndarray,
    kf_scal: jnp.ndarray,
    ring: jnp.ndarray,
    slot: jnp.ndarray,
    n_levels: int,
    scale: float,
    min_mm: int,
    close_depth: float,
    gamma: float,
    md_thr: float,
    min_gap: int,
    max_gap: int,
    snap: jnp.ndarray | None = None,
    lines_snap: jnp.ndarray | None = None,
    snap_cnt: jnp.ndarray | None = None,
    n_snap: int = 0,
):
    """Pipelined variant WITH the line pipeline chained in: point tracking,
    then line association + joint point/line pose refinement
    (AddLinesFrom + line edges of PoseOptimization, reference
    Tracking.cc:996-1124 / Optimizer.cc:653-931) as ONE device program.
    The packed buffer appends [det2ln (Ld,), n_line] and carries the
    line-refined pose T3; the on-device keyframe decision rides index 22
    as in _track_step_chained."""
    T_pred = vel_prev @ T_prev
    packed, ptpos2, haspt2, ismap2, prov_parts, final_ok, T2 = _track_core(
        cam, T_pred, last_feats, last_ptpos, last_haspt, last_ismap,
        last_prov, cur, depth, view, inv_sigma2_lut, n_levels, scale,
        min_mm, close_depth)
    obs = jnp.concatenate([cur.xy, cur.ur[:, None]], axis=-1)
    pobs = pose_opt.PointPoseObs(
        X=ptpos2, obs=obs, inv_sigma2=inv_sigma2_lut[cur.octave],
        is_stereo=cur.ur >= 0, valid=final_ok)
    T3, det2ln, n_line = _line_step(
        cam, T2, ln_x0, ln_d, ln_desc, ln_oct, ln_valid, fl, pobs,
        gamma, md_thr)
    decide, since2, scal2 = _kf_decision(packed, since_kf, kf_scal,
                                         min_gap, max_gap)
    prov2 = _prov_update(decide, prov_parts)
    vel2 = T3 @ jnp.linalg.inv(T_prev)
    packed = jnp.concatenate([
        jax.lax.bitcast_convert_type(T3.reshape(-1), jnp.int32),
        packed[16:22],
        decide[None],
        packed[22:],
        det2ln.astype(jnp.int32),
        n_line.astype(jnp.int32)[None],
    ])
    # point + line snapshots go to the flat ring's decide-gated KF slots
    # (see _track_step_chained)
    L = packed.shape[0]
    ring = jax.lax.dynamic_update_slice(ring, packed, (slot * L,))
    cnt2 = snap_cnt
    if snap is not None and n_snap > 0:
        srow = jnp.concatenate([snap] + ([lines_snap]
                                         if lines_snap is not None else []))
        off = ring.shape[0] - n_snap * srow.shape[0] \
            + (snap_cnt % n_snap) * srow.shape[0]
        ring = jax.lax.dynamic_update_slice(ring, srow, (off,))
        cnt2 = snap_cnt + decide
    return (packed, ptpos2, haspt2, ismap2, prov2, T3, vel2, ring, since2,
            scal2, cnt2)


@partial(jax.jit, static_argnames=("cam", "gamma", "md_thr"))
def _line_step(
    cam: StereoCamera,
    T: jnp.ndarray,
    ln_x0: jnp.ndarray,      # (M, 3) padded map-line view (world)
    ln_d: jnp.ndarray,
    ln_desc: jnp.ndarray,
    ln_oct: jnp.ndarray,
    ln_valid: jnp.ndarray,
    fl,                       # line_match.FrameLines
    pobs: pose_opt.PointPoseObs,
    gamma: float,
    md_thr: float,
):
    """Per-frame line association + joint point/line pose refinement
    (AddLinesFrom + the line edges of PoseOptimization,
    Tracking.cc:996-1124 / Optimizer.cc:653-931)."""
    from ..frontend import line_match as lm

    ln2det, det2ln = lm.associate_lines(
        cam, T, ln_x0, ln_d, ln_desc, ln_oct, ln_valid, fl, md_thr=md_thr)
    idx = jnp.maximum(det2ln, 0)
    lobs = pose_opt.LinePoseObs(
        X0=ln_x0[idx],
        d=ln_d[idx],
        x1_l=fl.kl.p1, x2_l=fl.kl.p2,
        x1_r=fl.p1_r, x2_r=fl.p2_r,
        octave=fl.kl.octave,
        has_right=fl.has_stereo,
        valid=(det2ln >= 0) & fl.kl.valid,
    )
    T3, pt_in, ln_in, n_in = pose_opt.optimize_pose(
        cam, T, pobs, lobs, gamma=gamma, rounds=2, iters=6)
    det2ln = jnp.where(ln_in, det2ln, -1)
    n_line = jnp.sum(det2ln >= 0)
    return T3, det2ln, n_line


@partial(jax.jit, static_argnames=("cap",))
def _unpack_view_dev(buf: jnp.ndarray, cap: int):
    from . import mapper_fast
    return mapper_fast.unpack_view(buf, 0, cap)


@partial(jax.jit, static_argnames=("cap", "d"))
def _unpack_line_view(buf: jnp.ndarray, cap: int, d: int):
    from .mapper_fast import _slice_f, _slice_i
    o = 0
    x0 = _slice_f(buf, o, (cap, 3)); o += 3 * cap
    dr = _slice_f(buf, o, (cap, 3)); o += 3 * cap
    de = _slice_f(buf, o, (cap, d)); o += d * cap
    oc = _slice_i(buf, o, (cap,)); o += cap
    va = _slice_i(buf, o, (cap,)) > 0
    return x0, dr, de, oc, va


@jax.jit
def _pack_frame_lines(fl) -> jnp.ndarray:
    """Flatten the per-frame line state the keyframe snapshot needs into ONE
    int32 buffer: one readback instead of 10 leaves."""
    bc = lambda a: jax.lax.bitcast_convert_type(
        a.astype(jnp.float32).reshape(-1), jnp.int32)
    return jnp.concatenate([
        bc(fl.kl.p1), bc(fl.kl.p2), bc(fl.p1_r), bc(fl.p2_r),
        fl.has_stereo.astype(jnp.int32), fl.kl.octave.astype(jnp.int32),
        bc(fl.kl.desc), fl.kl.valid.astype(jnp.int32),
        bc(fl.X0), bc(fl.d),
    ])


def _unpack_frame_lines_np(buf: np.ndarray, L: int, D: int):
    o = 0
    p1 = buf[o:o + 2 * L].view(np.float32).reshape(L, 2); o += 2 * L
    p2 = buf[o:o + 2 * L].view(np.float32).reshape(L, 2); o += 2 * L
    p1r = buf[o:o + 2 * L].view(np.float32).reshape(L, 2); o += 2 * L
    p2r = buf[o:o + 2 * L].view(np.float32).reshape(L, 2); o += 2 * L
    has_r = buf[o:o + L].astype(bool); o += L
    octave = buf[o:o + L].copy(); o += L
    desc = buf[o:o + D * L].view(np.float32).reshape(L, D); o += D * L
    valid = buf[o:o + L].astype(bool); o += L
    X0 = buf[o:o + 3 * L].view(np.float32).reshape(L, 3); o += 3 * L
    d = buf[o:o + 3 * L].view(np.float32).reshape(L, 3)
    return dict(p1=p1, p2=p2, p1r=p1r, p2r=p2r, has_r=has_r, octave=octave,
                desc=desc, valid=valid, X0=X0, d=d)


@dataclass
class FrameLog:
    """Per-frame trajectory bookkeeping entry (Tracking.cc:497-514)."""

    timestamp: float
    T_cr: np.ndarray      # pose relative to reference KF
    ref_kf: int
    lost: bool


@dataclass
class TrackMetrics:
    """Structured per-frame telemetry (SURVEY.md §5.5 rebuild plan)."""

    frame_id: int = 0
    state: str = ""
    n_kp: int = 0
    n_stereo: int = 0
    n_motion_matches: int = 0
    n_inliers: int = 0
    n_tracked_close: int = 0
    n_untracked_close: int = 0
    new_kf: bool = False
    n_points: int = 0
    n_kfs: int = 0
    n_line_matches: int = 0
    n_lines: int = 0
    # per-stage wall-clock (seconds): frame build+stats, fused track step
    # (incl. device sync), keyframe path (map update + local BA + loop)
    t_build: float = 0.0
    t_step: float = 0.0
    t_kf: float = 0.0
    t_dispatch: float = 0.0
    t_get: float = 0.0
    # window-fetch diagnostics (set on the last frame of each readback
    # window): total submit->complete latency of the ring fetch RPC and
    # the background time it had before the host blocked on it
    t_fetch_lat: float = 0.0
    t_fetch_lead: float = 0.0


class StereoTracker:
    def __init__(self, cfg: SlamConfig, store: MapStore | None = None,
                 local_pt_cap: int = 8192, mapper_kwargs: dict | None = None,
                 enable_loops: bool = True, vocabulary=None,
                 pipeline: bool = False, pipeline_depth: int = 2,
                 readback_window: int = 3):
        self.cfg = cfg
        self.cam = cfg.camera.stereo_camera()
        self.orb = cfg.orb
        self.store = store or MapStore(self.cam, self.orb)
        self.local_pt_cap = local_pt_cap
        self.state = TrackState.NOT_INITIALIZED
        self.T_cw = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)
        self.ref_kf = -1
        self.last_kf_frame = -1
        self.frame_id = -1
        self._ref_matches = 0
        # measured ratio ref_matches/n_in at the last keyframe — calibrates
        # the on-device weak-gate approximation (_kf_decision)
        self._kappa = 0.7
        self.logs: list[FrameLog] = []
        self.metrics: list[TrackMetrics] = []
        self.kf_timings: list[dict] = []
        # last-frame device state
        self._last_feats = None
        self._last_ptpos = None    # (N, 3) world position per keypoint
        self._last_haspt = None    # (N,) bool
        self._last_ismap = None    # (N,) bool: position is a real MapPoint
        self._last_prov = None     # (N,) int32 provisional origin feature
        # feature index -> created point id table of the LAST keyframe
        # (resolves on-device provisional identities at finalize)
        self._prov_kf_pid = None
        self._last_kp2pt = None    # (N,) np global point id
        self._inv_sigma2_lut = jnp.asarray(np.power(
            1.0 / self.orb.scale ** 2, np.arange(self.orb.n_levels))).astype(jnp.float32)
        self._has_velocity = False
        self._view = None
        self._view_pid = None
        self._reloc_key = jax.random.PRNGKey(7)
        self.localization_only = False
        # pipelined (finalize-lag-N) mode state: up to `pipeline_depth - 1`
        # frames stay in flight before their host finalize, so the host
        # finalize of one frame overlaps the device work of the next
        self.pipeline = pipeline
        self.pipeline_depth = max(1, pipeline_depth)
        # frames finalized per batched readback (ONE flat-latency ring
        # fetch covers W frames; see _process_pipelined). Host bookkeeping
        # (KF decision, metrics, trajectory) lags up to W-1 frames.
        self.readback_window = max(1, readback_window)
        # how many window fetches may ride the IO pool before the dispatch
        # thread blocks on the oldest: each extra inflight window hides one
        # more fetch completion behind dispatch work, and the on-device KF
        # decision keeps the added host lag safe. The W x inflight schedule
        # is kept until it is measured on the GPU against W=1 (ROADMAP
        # Design)
        self.max_inflight_windows = 3
        self._dev_ring = None
        self._ring_slot = 0
        self._pending: list[dict] = []
        self._dev_T = None
        self._dev_vel = None
        self._resync = True
        # on-device KF-decision chain state (see _kf_decision): a device
        # frames-since-KF counter + the host-computed ref-KF match count
        # (refreshed by a side-thread upload at each keyframe)
        self._dev_since = None
        self._dev_refm = None
        self._refm_fut = None
        self._dev_snap_cnt = None
        self._snap_cnt_host = 0
        # completed ring windows whose device_get runs on the tracker IO
        # pool: deque of (recs, future) — finalized in order when each fetch
        # lands, so a readback never blocks the dispatch thread. The
        # on-device provisional point identity (_track_core) keeps tracking
        # healthy across the resulting fetch lag.
        from collections import deque
        self._ring_inflight = deque()
        self._tr_io = None
        if pipeline:
            from concurrent.futures import ThreadPoolExecutor
            self._tr_io = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="tracker_io")
            # staged line retriangulation readbacks ride the same pool
            self.store.retri_io = self._tr_io
        self._mono = False
        self._init_ref = None
        # staged loop-closing queue: [kf_id, words|None] entries awaiting
        # absorb (words filled in when the KF's stage readback lands)
        from collections import deque as _deque
        self._pending_loops = _deque()
        # line pipeline (the LLD differentiator; off when ldType is `empty`,
        # matching the reference config gate)
        self.enable_lines = cfg.line.enabled
        self._cur_lines = None
        self._line_view = None
        self._line_view_fut = None
        self._line_view_ids = None
        self.line_view_cap = 512
        if self.enable_lines:
            from ..frontend.line_extract import LineDetConfig
            self.line_cfg = LineDetConfig(
                max_lines=self.store.n_ln_det,
                min_len=cfg.line.min_line_len)
            # stored-line route (the reference's benchmark configuration:
            # StoredLineExtractor selected by `ldType: LBDFloat` +
            # lineDetectionsPath, stereo_kitti.cc:61-85, Frame.cc:116-117).
            # Layout: <detections_path>/{left,right}/%06d.npz, or
            # detections_path=left dir and descriptors_path=right dir.
            self._line_source = None
            if cfg.line.ld_type.lower() == "lbdfloat" \
                    and cfg.line.detections_path:
                from pathlib import Path
                from ..io.stored_lines import StoredLineSource
                base = Path(cfg.line.detections_path)
                if (base / "left").is_dir():
                    left, right = base / "left", base / "right"
                else:
                    left = base
                    right = Path(cfg.line.descriptors_path or base)
                dim = self.store.ln_desc.shape[1]
                self._line_source = (
                    StoredLineSource(left, cap=self.store.n_ln_det,
                                     desc_dim=dim),
                    StoredLineSource(right, cap=self.store.n_ln_det,
                                     desc_dim=dim))
                # stored LBD descriptors live on LBDMOD's unnormalized L2
                # scale: `mdThr` applies directly (Tracking.cc:1092)
                self._md_gate = float(cfg.line.md_thr)
            else:
                # native detector: descriptors are L2-normalized, so map the
                # configured mdThr proportionally from its LBDMOD default
                # (2.0) onto the native gate
                self._md_gate = float(
                    self.line_cfg.desc_thr * cfg.line.md_thr / 2.0)
            self._refresh_line_view()
        # TrackReferenceKeyFrame matcher: global descriptor association with
        # ratio 0.7 + mutual check (SearchByBoW semantics, ORBmatcher.cc:159;
        # without the BoW-node gating, which only exists to prune CPU work)
        self._ref_match = jax.jit(partial(
            hamming.match_descriptors, max_dist=hamming.TH_LOW, ratio=0.7))
        self._mapper_kwargs = dict(mapper_kwargs or {})
        from .kf_cache import KfCache
        self.kf_cache = KfCache(n_slots=32, n_kp=self.store.n_kp)
        self.mapper = local_mapping.LocalMapper(
            self.store, cfg, cache=self.kf_cache, **self._mapper_kwargs)
        if pipeline and self.mapper.fixed_tv_cap is None:
            # pin the tracking-view capacity: a mid-run bucket jump
            # (2048 -> 4096 as the map grows) changes the chained step's
            # packed length, forcing a ring flush + ~10 s mid-sequence
            # recompile; one fixed shape keeps the pipeline warm
            self.mapper.fixed_tv_cap = 4096
        if pipeline:
            self.mapper.adaptive_ba_cadence = True
        # loop closing: vocabulary supplied up front, or trained from the
        # first keyframe's descriptors at initialization (System.cc:70 loads
        # ORBvoc.txt; loop/bow.py reads that format too)
        self.enable_loops = enable_loops
        self.vocabulary = vocabulary
        self.loop_closer = None
        if enable_loops and vocabulary is not None:
            from ..loop.closing import LoopCloser
            self.loop_closer = LoopCloser(self.store, vocabulary, cfg)
            self.mapper.on_kf_culled = self.loop_closer.db.erase

    # ------------------------------------------------------------------

    @staticmethod
    def stage_pair(img_l: np.ndarray, img_r: np.ndarray):
        """Stage a stereo pair on device: ONE stacked uint8 upload (each
        host->device transfer pays a full serialized link round trip, so two
        separate image uploads doubled the per-frame ingest cost). Returns
        the device array; pass it to `process(..., pair_dev=...)` — callers
        that stage a few frames ahead overlap the transfer with tracking."""
        if img_l.dtype != np.uint8:
            if img_l.max(initial=0.0) <= 255.0:
                img_l = img_l.astype(np.uint8)
                img_r = img_r.astype(np.uint8)
        return jax.device_put(np.stack([img_l, img_r]))

    def process(self, img_l: np.ndarray, img_r: np.ndarray,
                timestamp: float = 0.0, pair_dev=None, lines_dev=None):
        """Track one stereo pair; returns (T_cw (4,4) np, TrackMetrics).
        `lines_dev` optionally passes pre-staged (KeyLines, KeyLines) from
        io.stored_lines.stage_stored_pair, overriding the stored source."""
        import time as _time
        self.frame_id += 1
        m = TrackMetrics(frame_id=self.frame_id)
        t0 = _time.perf_counter()
        if pair_dev is None:
            pair_dev = self.stage_pair(img_l, img_r)
        fd = build_frame_pair(pair_dev, self.cam, self.orb)
        if self.enable_lines:
            from ..frontend import line_extract, line_match
            if lines_dev is not None:
                kld, krd = lines_dev
            elif self._line_source is not None:
                from ..io.stored_lines import stage_stored_pair
                kld, krd = stage_stored_pair(
                    self._line_source[0], self._line_source[1],
                    self.frame_id)
            else:
                kld = line_extract.detect_lines(pair_dev[0], self.line_cfg)
                krd = line_extract.detect_lines(pair_dev[1], self.line_cfg)
            self._cur_fl = line_match.match_stereo_lines(
                self.cam, kld, krd, md_thr=self._md_gate,
                min_len=self.cfg.line.min_line_len)
        m.t_build = _time.perf_counter() - t0
        return self._process_fd(fd, timestamp, m)

    def process_rgbd(self, img: np.ndarray, depthmap: np.ndarray,
                     timestamp: float = 0.0, depth_factor: float = 1.0):
        """Track one RGB-D frame (TrackRGBD path; lines are stereo-seeded
        and stay disabled here)."""
        import time as _time
        from ..frontend.frame import build_frame_rgbd
        self.frame_id += 1
        m = TrackMetrics(frame_id=self.frame_id)
        t0 = _time.perf_counter()
        if img.dtype == np.float32 and img.max(initial=0.0) <= 255.0:
            img = img.astype(np.uint8)
        self._cur_fl = None  # lines are stereo-seeded; not available here
        fd = build_frame_rgbd(jnp.asarray(img), jnp.asarray(depthmap),
                              self.cam, self.orb, depth_factor=depth_factor)
        m.t_build = _time.perf_counter() - t0
        return self._process_fd(fd, timestamp, m)

    def process_mono(self, img: np.ndarray, timestamp: float = 0.0):
        """Track one monocular frame (TrackMonocular path): bootstrap via
        the H/F initializer, then the standard pipeline with mono-only
        observations (new points come from epipolar triangulation)."""
        import time as _time
        from ..frontend.frame import build_frame_mono
        self._mono = True
        self.frame_id += 1
        m = TrackMetrics(frame_id=self.frame_id)
        t0 = _time.perf_counter()
        if img.dtype == np.float32 and img.max(initial=0.0) <= 255.0:
            img = img.astype(np.uint8)
        self._cur_fl = None
        fd = build_frame_mono(jnp.asarray(img), self.orb)
        m.t_build = _time.perf_counter() - t0
        return self._process_fd(fd, timestamp, m)

    def _initialize_mono(self, fd: FrameData, timestamp: float,
                         m: TrackMetrics):
        """Monocular bootstrap (MonocularInitialization +
        CreateInitialMapMonocular, Tracking.cc:558-770): hold a reference
        frame, match, run the H/F initializer, build the scale-normalized
        two-keyframe map."""
        from ..optim import initializer

        snap = self._snapshot_np(fd)
        if self._init_ref is None:
            if int(snap[0]["valid"].sum()) > 100:
                self._init_ref = (fd, snap, timestamp)
            return
        ref_fd, ref_snap, ref_ts = self._init_ref
        idx = np.asarray(matching.search_for_initialization(
            ref_fd.feats, fd.feats))
        valid = idx >= 0
        if valid.sum() < 100:  # Tracking.cc:708-713 -> restart init
            self._init_ref = (fd, snap, timestamp)
            return
        x1 = ref_snap[0]["xy"]
        x2 = snap[0]["xy"][np.maximum(idx, 0)]
        self._reloc_key, key = jax.random.split(self._reloc_key)
        ok, R, t, X, good = initializer.initialize(
            self.cam, jnp.asarray(x1), jnp.asarray(x2),
            jnp.asarray(valid), key)
        if not ok:
            return  # keep reference, try next frame
        # scale normalization: median depth -> 1 (Tracking.cc:745-760)
        med = float(np.median(X[good][:, 2]))
        if med <= 0:
            self._init_ref = (fd, snap, timestamp)
            return
        X = X / med
        t = t / med
        s = self.store
        T0 = np.eye(4, dtype=np.float32)
        T1 = np.eye(4, dtype=np.float32)
        T1[:3, :3] = R
        T1[:3, 3] = t
        kf0 = s.add_keyframe(T0, ref_snap[0], ref_snap[1],
                             np.full(s.n_kp, -1, np.int32), 0, ref_ts)
        kf1 = s.add_keyframe(T1, snap[0], snap[1],
                             np.full(s.n_kp, -1, np.int32),
                             self.frame_id, timestamp)
        sel = np.nonzero(good)[0]
        ids = s.create_points(kf0, sel, X[sel].astype(np.float32))
        s.kf_pt_ids[kf1, idx[sel]] = ids
        s.mark_obs_dirty()
        s.set_parent_from_covisibility(kf1)
        s.refresh_obs_counts()
        self.T_cw = T1
        self.velocity = np.eye(4, dtype=np.float32)
        self.ref_kf = kf1
        self.last_kf_frame = self.frame_id
        if self.enable_loops and self.loop_closer is None:
            from ..loop.bow import Vocabulary
            from ..loop.closing import LoopCloser
            self.vocabulary = Vocabulary.train(
                snap[0]["desc"][snap[0]["valid"]], k=8, L=3, seed=0)
            self.loop_closer = LoopCloser(self.store, self.vocabulary, self.cfg)
            self.mapper.on_kf_culled = self.loop_closer.db.erase
        if self.loop_closer is not None:
            self.loop_closer.process_keyframe(kf0)
            self.loop_closer.process_keyframe(kf1)
        # no BA here: the two-view bootstrap is already the ML estimate, and
        # a 2-KF monocular BA wanders along the scale gauge (one fixed KF
        # leaves scale near-null; observed: init pose direction destroyed)
        self.store.refresh_obs_counts()
        self.state = TrackState.OK
        self._has_velocity = False
        kp2pt = np.full(s.n_kp, -1, np.int32)
        kp2pt[idx[sel]] = ids
        self._refresh_local_view()
        self._refresh_ref_matches()
        self._remember_frame(fd, kp2pt)
        self._log_frame(timestamp)
        m.new_kf = True
        m.n_inliers = len(ids)
        self._init_ref = None

    def _process_fd(self, fd: FrameData, timestamp: float, m: TrackMetrics):
        import time as _time
        if self.pipeline and self.state == TrackState.OK \
                and not self._mono and not self.localization_only:
            return self._process_pipelined(fd, timestamp, m)
        self.flush()
        t0 = _time.perf_counter()
        if self.state == TrackState.NOT_INITIALIZED:
            self._initialize(fd, timestamp, m)
        else:
            self._track(fd, timestamp, m)
        self._resync = True  # device pose chain reseeds at next dispatch
        m.t_step = _time.perf_counter() - t0 - m.t_kf
        self._finish_metrics(m)
        return self.T_cw.copy(), m

    def _finish_metrics(self, m: TrackMetrics):
        if not m.state:  # a reset path may have recorded LOST already
            m.state = self.state.name
        m.n_points = int(self.store.pt_valid.sum())
        m.n_kfs = self.store.n_kf
        m.n_lines = int(self.store.ln_valid.sum())
        self.metrics.append(m)

    # ------------------------------------------------------------------
    # pipelined mode: dispatch frame i, finalize frame i-1 (1-frame lag).
    # The motion prediction + velocity update run on device
    # (_track_step_chained), so the dispatch needs nothing from frame i-1's
    # readback. Host bookkeeping (associations, stats, KF decision, mapping,
    # loops) happens one frame late — the deterministic analogue of the
    # reference's tracking/LocalMapping thread overlap (LocalMapping.cc:48):
    # a new keyframe's map points reach the tracker's local-map view two
    # frames after the keyframe, exactly like the reference's queue lag.
    # ------------------------------------------------------------------

    def _process_pipelined(self, fd: FrameData, timestamp: float,
                           m: TrackMetrics):
        import time as _time
        # opportunistic absorb: finalize the previous ring window if its
        # side-thread fetch already landed (spreads host bookkeeping across
        # frames; the dispatch thread never waits on a fresh readback).
        # Finalizing old recs overwrites _cur_fl (keyframe-line creation
        # reads it) — restore the CURRENT frame's lines before dispatching.
        cur_fl = self._cur_fl if self.enable_lines else None
        ret = self._absorb_ring(block=False)
        if (self._pending or self._ring_inflight) and self._resync:
            # chain poisoned (LOST/fallback/loop jump): fix host state first
            ret = self.flush()
        if self._resync or self._dev_T is None:
            self._dev_T = jnp.asarray(self.T_cw)
            self._dev_vel = jnp.asarray(self.velocity)
            self._dev_since = jnp.asarray(np.int32(
                max(0, self.frame_id - 1 - self.last_kf_frame)))
            self._dev_refm = jnp.asarray(
                np.float32([self._ref_matches, self._kappa]))
            self._refm_fut = None
            self._dev_snap_cnt = jnp.zeros((), jnp.int32)
            self._snap_cnt_host = 0
            self._resync = False
        if self._refm_fut is not None and self._refm_fut.done():
            # the post-KF reference match count arrived: swap it into the
            # decision chain (the device counter itself is authoritative)
            self._dev_refm = self._refm_fut.result()
            self._refm_fut = None
        if self.enable_lines:
            self._cur_fl = cur_fl
        t0 = _time.perf_counter()
        prev = (self._last_feats, self._last_ptpos,
                self._last_haspt, self._last_ismap, self._last_prov)
        with_lines = (self.enable_lines and self._cur_fl is not None
                      and (self._line_view is not None
                           or self._line_view_fut is not None))
        # device ring for batched readback: each chained step writes its
        # packed output into row `slot`; the host fetches the whole ring in
        # ONE device_get every W frames instead of one per frame. A
        # packed-length change (view-capacity growth, lines toggling)
        # flushes and reallocates.
        W = self.readback_window
        n_kp_ = self.store.n_kp
        L = (23 + 3 * n_kp_ + -(-n_kp_ // 32)
             + -(-len(self._view_pid) // 32))
        if with_lines:
            L += self.store.n_ln_det + 1
        # min gap 3: the deterministic analogue of the reference's
        # LocalMapping-idle damper (NeedNewKeyFrame c1b, Tracking.cc:1282 —
        # insertion waits for the mapper unless interrupted); our staged
        # mapper is busy for ~3 finalized frames after each keyframe
        min_gap = max(self.cfg.tracking.min_frames_between_kf, 3)
        max_gap = self.cfg.tracking.max_frames_between_kf
        if self.localization_only:
            # localization mode creates no keyframes (Tracking.cc:772): force
            # the on-device decision off so no provisional identities are
            # seeded against a stale _prov_kf_pid table and the device/host
            # snap counters stay aligned (the host suppresses KF creation,
            # so an on-device fire would desync both)
            min_gap = max_gap = 1 << 28
        # the flat ring is [W packed rows | S snapshot slots]: snapshots
        # (83% of a row's bytes) are stashed ONLY when the on-device KF
        # decision fires, so the window fetch pays for ~W/min_gap of them
        # instead of W. S bounds the KFs one window can hold (min_gap
        # spacing); ring immutability across steps makes the in-flight
        # window's version safe from later overwrites.
        Ls = 15 * n_kp_
        Lls = 0
        if with_lines:
            # must EXACTLY match _pack_frame_lines: 4 endpoint pairs (8) +
            # has_stereo + octave + valid (3) + X0 + d (6) + desc (D)
            ld_ = self.store.n_ln_det
            Lls = (17 + self.store.ln_desc.shape[1]) * ld_
        Lsnap = Ls + Lls
        S = (W - 1) // min_gap + 2
        Lt = W * L + S * Lsnap
        layout = (W, L, S, Ls, Lls)
        if self._dev_ring is None or self._dev_ring.shape != (Lt,):
            if self._pending or self._ring_inflight:
                ret = self.flush()
            self._dev_ring = jnp.zeros(Lt, jnp.int32)
            self._ring_slot = 0
            self._dev_snap_cnt = jnp.zeros((), jnp.int32)
            self._snap_cnt_host = 0
        from ..frontend.frame import pack_frame
        snap_dev = pack_frame(fd)
        if with_lines:
            lines_snap_dev = _pack_frame_lines(self._cur_fl)
            out = _track_step_chained_lines(
                self.cam, self._dev_T, self._dev_vel, self._last_feats,
                self._last_ptpos, self._last_haspt, fd.feats, fd.depth,
                self._view, self._inv_sigma2_lut, *self._get_line_view(),
                self._cur_fl, self._last_ismap, self._last_prov,
                self._dev_since, self._dev_refm, self._dev_ring,
                self._ring_slot,
                self.orb.n_levels, self.orb.scale,
                self.cfg.tracking.min_motion_matches,
                float(self.cfg.close_depth), float(self.cfg.line.gamma),
                float(self._md_gate), min_gap, max_gap,
                snap=snap_dev, lines_snap=lines_snap_dev,
                snap_cnt=self._dev_snap_cnt, n_snap=S)
        else:
            out = _track_step_chained(
                self.cam, self._dev_T, self._dev_vel, self._last_feats,
                self._last_ptpos, self._last_haspt, fd.feats, fd.depth,
                self._view, self._inv_sigma2_lut, self._last_ismap,
                self._last_prov, self._dev_since, self._dev_refm,
                self._dev_ring, self._ring_slot,
                self.orb.n_levels, self.orb.scale,
                self.cfg.tracking.min_motion_matches,
                float(self.cfg.close_depth), min_gap, max_gap,
                snap=snap_dev, snap_cnt=self._dev_snap_cnt, n_snap=S)
        # no per-frame copy_to_host_async: results leave the device through
        # the windowed ring fetch below
        m.t_dispatch = _time.perf_counter() - t0
        rec = dict(fd=fd, out=out, ts=timestamp, m=m, fid=self.frame_id,
                   view_pid=self._view_pid,
                   view_cap=len(self._view_pid), prev=prev,
                   ring_slot=self._ring_slot, ring_after=out[7],
                   layout=layout)
        if with_lines:
            rec["fl"] = self._cur_fl
            rec["line_view_ids"] = self._line_view_ids
        self._dev_T, self._dev_vel = out[5], out[6]
        self._dev_ring = out[7]
        self._dev_since, self._dev_refm = out[8], out[9]
        self._dev_snap_cnt = out[10]
        self._ring_slot += 1
        self._last_feats = fd.feats
        self._last_ptpos, self._last_haspt = out[1], out[2]
        self._last_ismap, self._last_prov = out[3], out[4]
        self._pending.append(rec)
        # adaptive fetch cadence: while the map is YOUNG every map update
        # matters (new landmarks dominate the view), so finalize in very
        # short windows until the first keyframes land
        n_kf = self.store.n_kf
        W_eff = W if n_kf >= 4 else min(W, 2)
        # young-map damper also caps pipeline DEPTH: while the map is
        # young (and for lines, while map lines are still sparse) every
        # map update must reach the device view quickly, so the deep
        # inflight schedule would starve association for its whole lag
        young = n_kf < 4 or (with_lines
                             and int(self.store.ln_valid.sum()) < 8)
        inflight_eff = 1 if young else self.max_inflight_windows
        if self._ring_slot >= W_eff:
            # window complete: hand the ring fetch to the IO pool and keep
            # dispatching — finalize happens when the readback lands (the
            # on-device KF decision makes the fetch-latency lag safe: the
            # decision was taken at frame rate on device, not at fetch rate
            # on the host)
            self._ring_slot = 0
            recs, self._pending = self._pending, []
            # submit THIS window's fetch BEFORE block-absorbing the previous
            # one, so its latency overlaps the previous window's finalize +
            # keyframe work instead of sitting on the critical path. The
            # ring buffer version is immutable (no donation), so later
            # steps can't clobber it.
            t_sub = _time.perf_counter()

            def _fetch(a=recs[-1]["ring_after"]):
                arr = np.asarray(a)
                return arr, _time.perf_counter()

            fut = self._tr_io.submit(_fetch)
            self._ring_inflight.append((recs, fut, t_sub))
            if len(self._ring_inflight) >= inflight_eff + 1:
                r2 = self._absorb_ring(block=True)  # keep windows ordered
                if r2 is not None:
                    ret = r2
            if self._resync and self._ring_inflight:
                # the absorb poisoned the chain: re-route the still-inflight
                # window(s) through the resync path on the next call (their
                # fetched results were computed from a poisoned pose chain)
                self._pending = [r for recs_, _, _ in self._ring_inflight
                                 for r in recs_] + self._pending
                self._ring_inflight.clear()
        return ret if ret is not None else (self.T_cw.copy(), None)

    def _absorb_ring(self, block: bool):
        """Finalize completed ring windows whose fetches ride the tracker
        IO pool, oldest first. Non-blocking unless `block` (then the OLDEST
        window is waited for; newer done windows drain too)."""
        import time as _time
        ret = None
        first = True
        while self._ring_inflight:
            recs, fut, t_sub = self._ring_inflight[0]
            if not fut.done() and not (block and first):
                break
            first = False
            t_g = _time.perf_counter()
            if not fut.done():
                # steal the ring-fetch wait: instead of idling until the
                # fetch lands, absorb already-landed mapper stage/BA
                # readbacks (they otherwise wait for the next finalize
                # burst and then force blocking absorbs at queue overflow)
                from concurrent.futures import TimeoutError as _FTimeout
                while not fut.done():
                    mp = self.mapper
                    state = (len(mp._pending_kfq),
                             mp._pending_ba is not None,
                             len(self._pending_loops))
                    self._step_kf_pipeline()
                    progressed = state != (len(mp._pending_kfq),
                                           mp._pending_ba is not None,
                                           len(self._pending_loops))
                    try:
                        fut.result(timeout=0.002 if progressed else 0.02)
                    except _FTimeout:
                        pass
            batch, t_done = fut.result()
            m_last = recs[-1]["m"]
            m_last.t_get = _time.perf_counter() - t_g
            m_last.t_fetch_lat = t_done - t_sub
            m_last.t_fetch_lead = t_g - t_sub
            self._ring_inflight.popleft()
            self._attach_snaps(recs, batch)
            for r in recs:
                W, L, _, _, _ = r["layout"]
                s = r["ring_slot"]
                ret = self._finalize_rec(r, packed_np=batch[s * L:
                                                            (s + 1) * L])
            if self._resync:
                break
        return ret

    def _attach_snaps(self, recs, batch):
        """Unpack the keyframe feature snapshots of a fetched window's
        KF-flagged rows. The snapshots sit in the flat ring's decide-gated
        KF slots (written by the chained step when the on-device decision
        fired), so this is a pure host-side slice: no separate readback per
        keyframe, and no full snapshot in every row. The host-side counter
        mirrors the
        device snap_cnt: both advance once per fired decision, in finalize
        order, and both reset together on resync."""
        if self.localization_only:
            return
        from ..frontend.frame import unpack_frame_np
        n_kp = self.store.n_kp
        for r in recs:
            W, L, S, Ls, Lls = r["layout"]
            row = batch[r["ring_slot"] * L:(r["ring_slot"] + 1) * L]
            if row[22] > 0 and Ls:
                o = W * L + (self._snap_cnt_host % S) * (Ls + Lls)
                self._snap_cnt_host += 1
                r["snap_np"] = unpack_frame_np(batch[o:o + Ls], n_kp)
                if "fl" in r:
                    r["lines_snap_np"] = batch[o + Ls:o + Ls + Lls]

    def flush(self):
        """Finalize all in-flight pipelined frames (one ring fetch) and
        absorb any staged keyframe work (sequence end, resync, or before
        synchronous processing)."""
        ret = None
        while getattr(self, "_ring_inflight", None):
            r = self._absorb_ring(block=True)
            if r is not None:
                ret = r
        while getattr(self, "_pending", None):
            # one ring window at a time (slot wraps to 0 at a window edge);
            # the window's last rec's ring version holds all its rows
            recs = [self._pending.pop(0)]
            while self._pending \
                    and self._pending[0]["ring_slot"] > recs[-1]["ring_slot"]:
                recs.append(self._pending.pop(0))
            batch = np.asarray(recs[-1]["ring_after"])
            if not self._resync:
                self._attach_snaps(recs, batch)
            for rec in recs:
                W, L, _, _, _ = rec["layout"]
                s = rec["ring_slot"]
                r = self._finalize_rec(rec,
                                       packed_np=batch[s * L:(s + 1) * L])
                if r is not None:
                    ret = r
        self._ring_slot = 0
        self._flush_kf_pipeline()
        return ret

    def _flush_kf_pipeline(self):
        """Absorb pending staged mapper/loop work synchronously."""
        mp = self.mapper
        mp.flush()
        if self.enable_lines:
            # the last keyframe window's staged line retriangulation would
            # otherwise be dropped from the output map at sequence end
            self.store.absorb_retriangulate()
        self._adopt_view()
        self._match_loop_words()
        while self._pending_loops:
            self._absorb_loop()

    def _adopt_view(self):
        """Adopt the mapper's freshest post-BA tracking view once its
        IO-thread dispatch has resolved (dispatch_ba fires from paths whose
        return value no caller sees; until then the previous view keeps
        tracking)."""
        fut = self.mapper.pending_view_fut
        if fut is not None and fut.done():
            self.mapper.pending_view_fut = None
            self._view, self._view_pid = fut.result()

    def _step_kf_pipeline(self):
        """Advance the staged keyframe pipeline by one stage per finalized
        frame (the deterministic analogue of the LocalMapping/LoopClosing
        thread overlap, reference src/LocalMapping.cc:48-113). Returns True
        when a loop correction rewrote the map (callers must resync)."""
        self.mapper.step_pending()
        self._adopt_view()
        self._match_loop_words()
        if self._pending_loops and self._pending_loops[0][1] is not None \
                and not self.mapper.busy:
            return self._absorb_loop()
        return False

    def _match_loop_words(self):
        """Attach freshly absorbed staged BoW words to their queued loop
        entry."""
        if self.mapper.absorbed_words is not None:
            wkf, words = self.mapper.absorbed_words
            self.mapper.absorbed_words = None
            for e in self._pending_loops:
                if e[0] == wkf:
                    e[1] = words
                    break

    def _absorb_loop(self) -> bool:
        """Absorb the staged BoW words -> loop detection for a keyframe
        (+ full Sim3/correction when a loop fires — rare)."""
        kf_id, words = self._pending_loops.popleft()
        if self.loop_closer is None:
            return False
        T_ref_old = self.store.kf_pose[self.ref_kf].copy()
        if words is None:
            # flat readback hasn't happened (e.g. reset dropped the KF
            # stage): recompute words from the host KF snapshot
            corrected = self.loop_closer.process_keyframe(kf_id)
        else:
            corrected = self.loop_closer.finish_keyframe(
                kf_id, np.asarray(words))
        if corrected:
            # re-express the tracker pose through the corrected reference
            # (CorrectLoop pose propagation, reference LoopClosing.cc:455-465)
            T_cr = self.T_cw @ np.linalg.inv(T_ref_old)
            self.T_cw = (T_cr @ self.store.kf_pose[self.ref_kf]).astype(
                np.float32)
            self._refresh_local_view()
            self._refresh_ref_matches()
            if self.enable_lines:
                self._refresh_line_view()
            self._resync = True
        return corrected

    @staticmethod
    def _rec_fd(rec):
        """rec["fd"] may be a thunk (batched multi-sequence driver: device
        slices are only materialized on keyframe / resync paths)."""
        fd = rec["fd"]
        if callable(fd):
            fd = rec["fd"] = fd()
        return fd

    def _finalize_rec(self, rec: dict, packed_np: "np.ndarray | None" = None):
        import time as _time
        m: TrackMetrics = rec["m"]
        t0 = _time.perf_counter()
        # advance staged keyframe work one stage per frame; a loop
        # correction poisons the in-flight chain (resync below)
        self._step_kf_pipeline()
        if self._resync:
            # the device results were computed from a poisoned pose chain —
            # reprocess this frame through the synchronous path (rare:
            # tracking failure, relocalization, loop-closure jump). The
            # predecessor was itself finalized synchronously, so _last_*
            # already hold ITS corrected state — do not restore rec["prev"],
            # which still points at the poisoned device chain.
            self._cur_fl = rec.get("fl")
            if self.state == TrackState.NOT_INITIALIZED:
                # a full reset happened while this frame was in flight
                # (Tracking.cc:482-488): it becomes the reinit candidate
                self._initialize(self._rec_fd(rec), rec["ts"], m,
                                 fid=rec["fid"])
            else:
                self._track(self._rec_fd(rec), rec["ts"], m, fid=rec["fid"])
            m.t_step = _time.perf_counter() - t0 - m.t_kf
            self._finish_metrics(m)
            return self.T_cw.copy(), m

        if packed_np is not None:
            # callers hand the already-sliced packed row (snapshots live in
            # the flat ring's KF slots, split off in _attach_snaps)
            packed = packed_np
        else:
            t_g = _time.perf_counter()
            packed = jax.device_get(rec["out"][0])
            m.t_get = _time.perf_counter() - t_g
        has_lines = "fl" in rec
        if has_lines:
            ld = self.store.n_ln_det
            det2ln = packed[-(ld + 1):-1]
            n_line = int(packed[-1])
            packed = packed[:-(ld + 1)]
        (T_np, n_mm, n_in, tracked_close, untracked_close, n_kp, n_st,
         kp2last, kp2pt_l, ok, in_frustum, prov, decide) = self._unpack(
             packed, rec["view_cap"], has_decide=True)
        m.n_motion_matches = int(n_mm)
        m.n_kp = int(n_kp)
        m.n_stereo = int(n_st)
        m.n_tracked_close = int(tracked_close)
        m.n_untracked_close = int(untracked_close)

        if n_in < self.cfg.tracking.min_track_inliers:
            # weak — rerun this frame synchronously (ref-KF fallback / LOST
            # handling live there) and poison the chain for the in-flight
            # frame
            self._resync = True
            prev = rec["prev"]
            (self._last_feats, self._last_ptpos, self._last_haspt,
             self._last_ismap, self._last_prov) = (
                prev() if callable(prev) else prev)
            self._cur_fl = rec.get("fl")
            self._track(self._rec_fd(rec), rec["ts"], m, fid=rec["fid"])
            m.t_step = _time.perf_counter() - t0 - m.t_kf
            self._finish_metrics(m)
            return self.T_cw.copy(), m

        m.n_inliers = n_in
        self._cur_det2ln = None
        if has_lines:
            self._cur_fl = rec["fl"]
            self._cur_det2ln = np.where(
                det2ln >= 0,
                rec["line_view_ids"][np.maximum(det2ln, 0)],
                -1).astype(np.int32)
            m.n_line_matches = n_line
        pid = rec["view_pid"]
        kp2pt = np.where(
            kp2pt_l >= 0, pid[np.maximum(kp2pt_l, 0)],
            np.where(kp2last >= 0,
                     self._last_kp2pt[np.maximum(kp2last, 0)], -1),
        ).astype(np.int32)
        if self._prov_kf_pid is not None:
            # resolve on-device provisional identities to the point ids the
            # last keyframe actually created (records REAL observations for
            # features born between readbacks)
            sel = (kp2pt < 0) & (prov >= 0)
            kp2pt[sel] = self._prov_kf_pid[prov[sel]]
        kp2pt[~ok] = -1
        vis_ids = pid[in_frustum & (pid >= 0)]
        np.add.at(self.store.pt_visible, vis_ids, 1)
        np.add.at(self.store.pt_found, kp2pt[kp2pt >= 0], 1)

        self.state = TrackState.OK
        self.velocity = (T_np @ np.linalg.inv(self.T_cw)).astype(np.float32)
        self.T_cw = T_np.astype(np.float32)

        # the KF decision was taken ON DEVICE at frame rate (_kf_decision);
        # the host only reacts — no stale-decision over-firing however deep
        # the finalize lag
        new_kf = bool(decide) and not self.localization_only
        if new_kf:
            t_kf0 = _time.perf_counter()
            self._create_kf(self._rec_fd(rec), kp2pt, rec["ts"],
                            fid=rec["fid"],
                            pipelined=True, snap_fut=rec.get("snap_fut"),
                            lines_snap_fut=rec.get("lines_snap_fut"),
                            snap_np=rec.get("snap_np"),
                            lines_snap_np=rec.get("lines_snap_np"),
                            n_in_kf=int(n_in))
            m.t_kf = _time.perf_counter() - t_kf0
            m.new_kf = True
        self._last_kp2pt = kp2pt
        self._log_frame(rec["ts"])
        m.t_step = _time.perf_counter() - t0 - m.t_kf
        self._finish_metrics(m)
        return self.T_cw.copy(), m

    # ------------------------------------------------------------------

    def _feats_np(self, fd: FrameData) -> dict:
        feats, depth = self._snapshot_np(fd)
        return feats

    def _snapshot_np(self, fd: FrameData):
        """Single-round-trip host snapshot of (features, depth)."""
        from ..frontend.frame import pack_frame, unpack_frame_np
        buf = np.asarray(pack_frame(fd))
        return unpack_frame_np(buf, self.store.n_kp)

    def _initialize(self, fd: FrameData, timestamp: float, m: TrackMetrics,
                    fid: int | None = None):
        """StereoInitialization (Tracking.cc:520-556): all stereo-depth'd
        keypoints become map points, the frame becomes KF 0 at identity.
        Monocular input dispatches to the H/F bootstrap instead."""
        if fid is None:
            fid = self.frame_id
        self._flush_kf_pipeline()
        if self._mono:
            return self._initialize_mono(fd, timestamp, m)
        feats, depth = self._snapshot_np(fd)
        n_depth = int(((depth > 0) & feats["valid"]).sum())
        if n_depth <= self.cfg.tracking.min_init_points:
            return
        T0 = np.eye(4, dtype=np.float32)
        kf = self.store.add_keyframe(
            T0, feats, depth, np.full(self.store.n_kp, -1, np.int32),
            fid, timestamp)
        good = np.nonzero((depth > 0) & feats["valid"])[0]
        uv = feats["xy"][good]
        z = depth[good]
        cam = self.cam
        Xw = np.stack([(uv[:, 0] - cam.cx) * z / cam.fx,
                       (uv[:, 1] - cam.cy) * z / cam.fy, z], -1).astype(np.float32)
        ids = self.store.create_points(kf, good, Xw)
        if self.enable_lines and self._cur_fl is not None:
            self._cur_det2ln = None
            self._create_kf_lines(kf)
        self.T_cw = T0
        self.velocity = np.eye(4, dtype=np.float32)
        self.ref_kf = kf
        self.last_kf_frame = fid
        if self.enable_loops and self.loop_closer is None:
            from ..loop.bow import Vocabulary
            from ..loop.closing import LoopCloser
            self.vocabulary = Vocabulary.train(
                feats["desc"][feats["valid"]], k=8, L=3, seed=0)
            self.loop_closer = LoopCloser(self.store, self.vocabulary, self.cfg)
            self.mapper.on_kf_culled = self.loop_closer.db.erase
        if self.loop_closer is not None:
            self.loop_closer.process_keyframe(kf)
        # register KF 0's device features in the cache NOW — leaving it to
        # the first neighbor-window backfill costs a host re-upload
        self.mapper.cache_frame(kf, fd.feats)
        self.state = TrackState.OK
        self._has_velocity = False
        kp2pt = np.full(self.store.n_kp, -1, np.int32)
        kp2pt[good] = ids
        self._refresh_local_view()
        self._refresh_ref_matches()
        if self.enable_lines:
            self._refresh_line_view()
        self._remember_frame(fd, kp2pt)
        self._log_frame(timestamp)
        m.new_kf = True
        m.n_inliers = len(ids)

    def _remember_frame(self, fd: FrameData, kp2pt: np.ndarray,
                        dev_ptpos=None, dev_haspt=None, dev_ismap=None,
                        dev_prov=None, refresh: bool = False):
        """Stash the frame state the next frame's motion model needs. Between
        keyframes the per-keypoint positions computed on device are reused
        as-is; at keyframe rate (map changed: new points, BA moved things)
        they are rebuilt from the store and uploaded once."""
        self._last_feats = fd.feats
        self._last_kp2pt = kp2pt
        if dev_ptpos is not None and not refresh:
            self._last_ptpos = dev_ptpos
            self._last_haspt = dev_haspt
            self._last_ismap = (dev_ismap if dev_ismap is not None
                                else dev_haspt)
            self._last_prov = (dev_prov if dev_prov is not None
                               else jnp.full(self.store.n_kp, -1, jnp.int32))
        else:
            haspt = kp2pt >= 0
            pos = np.zeros((self.store.n_kp, 3), np.float32)
            pos[haspt] = self.store.pt_pos[kp2pt[haspt]]
            self._last_ptpos = jnp.asarray(pos)
            self._last_haspt = jnp.asarray(haspt)
            self._last_ismap = self._last_haspt
            self._last_prov = jnp.full(self.store.n_kp, -1, jnp.int32)

    def _log_frame(self, timestamp: float, lost: bool = False):
        T_rw = self.store.kf_pose[self.ref_kf]
        T_cr = self.T_cw @ np.linalg.inv(T_rw)
        self.logs.append(FrameLog(timestamp, T_cr.astype(np.float32),
                                  self.ref_kf, lost))

    # ------------------------------------------------------------------

    def _refresh_ref_matches(self):
        """Reference-KF tracked-point count for the KF decision
        (KeyFrame::TrackedMapPoints(minObs), used at Tracking.cc:1259):
        features whose map point has >= 3 observations (2 while the map is
        tiny). Counting every associated slot instead (first implementation)
        made every frame 'weak' vs a reference full of just-created points —
        a keyframe per frame."""
        s = self.store
        min_obs = 3 if s.n_kf > 2 else 2
        ids = s.kf_pt_ids[self.ref_kf]
        ids = ids[ids >= 0]
        ids = ids[s.pt_valid[ids]]
        if len(ids) == 0:
            self._ref_matches = 0
            return
        s.refresh_obs_counts()
        self._ref_matches = int((s.pt_nobs[ids] >= min_obs).sum())

    def _refresh_line_view(self):
        """Padded device view of the local map lines (lines observed by the
        local keyframes), refreshed at keyframe rate like the point view —
        packed into ONE host->device transfer."""
        s = self.store
        cap = self.line_view_cap
        if self.ref_kf >= 0:
            covis, _ = s.covisible_kfs(self.ref_kf, min_shared=15, top=19)
            local_kfs = np.concatenate([[self.ref_kf], covis]).astype(np.int32)
            ids = np.unique(s.kf_ln_ids[local_kfs])
            ids = ids[ids >= 0]
            ids = ids[s.ln_valid[ids]]
            if len(ids) > cap:
                self.mapper.stage_times["line_view_dropped"] = \
                    self.mapper.stage_times.get("line_view_dropped", 0) \
                    + (len(ids) - cap)
                ids = ids[-cap:]
        else:
            ids = np.zeros(0, np.int32)
        P = len(ids)
        pad = cap - P
        self._line_view_ids = np.concatenate([ids, np.full(pad, -1, np.int32)])
        D = s.ln_desc.shape[1]
        bc = lambda a: np.ascontiguousarray(a, np.float32).reshape(-1).view(np.int32)
        x0 = np.concatenate([s.ln_x0[ids], np.zeros((pad, 3), np.float32)])
        dr = np.concatenate([s.ln_dir[ids],
                             np.tile(np.array([1, 0, 0], np.float32),
                                     (pad, 1))])
        de = np.concatenate([s.ln_desc[ids], np.zeros((pad, D), np.float32)])
        buf_np = np.concatenate([
            bc(x0), bc(dr), bc(de),
            np.concatenate([s.ln_oct[ids],
                            np.zeros(pad, np.int32)]).astype(np.int32),
            np.concatenate([np.ones(P, np.int32), np.zeros(pad, np.int32)]),
        ])
        self._line_D = D
        # inline upload: host->device puts are async enqueues. Routing this
        # through the 2-worker tracker IO pool would make the NEXT
        # dispatch's _get_line_view .result() wait behind a ring fetch
        # occupying both workers.
        self._line_view_fut = None
        self._line_view = _unpack_line_view(jax.device_put(buf_np), cap, D)

    def _get_line_view(self):
        """Resolve the (possibly in-flight) device map-line view."""
        if self._line_view_fut is not None:
            buf = self._line_view_fut.result()
            self._line_view_fut = None
            self._line_view = _unpack_line_view(buf, self.line_view_cap,
                                                self._line_D)
        return self._line_view

    def _refresh_local_view(self):
        """Rebuild the padded MapPointView over the local map
        (UpdateLocalPoints, Tracking.cc:1677-1724: points of the
        covisibility-local keyframes) with ONE packed upload. In the steady
        state the view ships with the BA program instead
        (mapper_fast.ba_view_cached); this path covers initialization,
        relocalization and loop corrections."""
        from . import mapper_fast
        s = self.store
        ids = self.mapper._select_view_pids(self.ref_kf)
        cap = self.mapper.fixed_tv_cap or (2048 if len(ids) <= 2048
                                           else 4096)
        if len(ids) > cap:
            # ids arrive sorted by ascending covisibility weight — the tail
            # keeps the most-covisible points (see _select_view_pids)
            ids = ids[-cap:]
        pad = cap - len(ids)
        self._view_pid = np.concatenate([ids, np.full(pad, -1, ids.dtype)])
        buf = jax.device_put(mapper_fast.pack_view(s, ids, cap))
        self._view = _unpack_view_dev(buf, cap)

    def _ref_anchor_pose(self, fd: FrameData) -> np.ndarray | None:
        """TrackReferenceKeyFrame pose: global descriptor match against the
        reference KF -> robust pose optimization from the current pose
        (Tracking.cc:773-830). Returns T_cw or None when the match is too
        thin (< 10 associations)."""
        kp2pt_ref = self._match_ref_kf(fd)
        if (kp2pt_ref >= 0).sum() < 10:
            return None
        pobs = _gather_pose_obs(
            self.cam, jnp.asarray(self.store.pt_pos),
            jnp.asarray(kp2pt_ref), fd.feats, self._inv_sigma2_lut)
        T_fb, _, _, _ = pose_opt.optimize_pose(
            self.cam, jnp.asarray(self.T_cw), pobs)
        T_fb = np.asarray(T_fb)
        return T_fb if np.isfinite(T_fb).all() else None

    def _match_ref_kf(self, fd: FrameData) -> np.ndarray:
        """TrackReferenceKeyFrame association (Tracking.cc:773-830): global
        descriptor match of the frame against the reference KF's features
        that carry map points. Returns kp2pt (N,) global point ids."""
        s = self.store
        ref_valid = s.kf_kp_valid[self.ref_kf] & (s.kf_pt_ids[self.ref_kf] >= 0)
        idx, ok, _ = self._ref_match(
            fd.feats.desc, fd.feats.valid,
            jnp.asarray(s.kf_desc[self.ref_kf]), jnp.asarray(ref_valid))
        ok = hamming.rotation_consistency_mask(
            fd.feats.angle, jnp.asarray(s.kf_angle[self.ref_kf]), idx, ok)
        idx, ok = np.asarray(idx), np.asarray(ok)
        kp2pt = np.full(s.n_kp, -1, np.int32)
        kp2pt[ok] = s.kf_pt_ids[self.ref_kf, idx[ok]]
        return kp2pt

    def _run_step(self, fd: FrameData, T_pred: np.ndarray):
        return _track_step(
            self.cam, jnp.asarray(T_pred), self._last_feats, self._last_ptpos,
            self._last_haspt, self._last_ismap, self._last_prov, fd.feats,
            fd.depth, self._view, self._inv_sigma2_lut, self.orb.n_levels,
            self.orb.scale, self.cfg.tracking.min_motion_matches,
            float(self.cfg.close_depth))

    def _attempt_reloc(self, fd: FrameData):
        """Relocalization (Tracking::Relocalization, Tracking.cc:1837-1998):
        BoW reloc candidates -> per-candidate descriptor match -> batched
        EPnP RANSAC -> robust pose opt. Returns T_cw or None."""
        if self.loop_closer is None:
            return None
        from ..optim import pnp
        s = self.store
        voc, db = self.loop_closer.voc, self.loop_closer.db
        desc = np.asarray(fd.feats.desc)
        valid = np.asarray(fd.feats.valid)
        ids, vals = voc.bow_vector(desc, valid)
        cands = db.detect_reloc_candidates(ids, vals)[:5]
        for kf in cands:
            has_kf = s.kf_kp_valid[kf] & (s.kf_pt_ids[kf] >= 0)
            idx, ok, _ = self._ref_match(
                fd.feats.desc, fd.feats.valid,
                jnp.asarray(s.kf_desc[kf]), jnp.asarray(has_kf))
            idx, ok = np.asarray(idx), np.asarray(ok)
            sel = np.nonzero(ok)[0]
            if len(sel) < 15:  # SearchByBoW >= 15 gate (Tracking.cc:1873)
                continue
            pts = s.kf_pt_ids[kf, idx[sel]]
            cap = 512
            n = min(len(sel), cap)
            Pw = np.zeros((cap, 3), np.float32)
            uv = np.zeros((cap, 2), np.float32)
            s2 = np.ones(cap, np.float32)
            Pw[:n] = s.pt_pos[pts[:n]]
            uv[:n] = np.asarray(fd.feats.xy)[sel[:n]]
            oct_ = np.asarray(fd.feats.octave)[sel[:n]]
            s2[:n] = self.orb.scale ** (2.0 * oct_)
            self._reloc_key, key = jax.random.split(self._reloc_key)
            T, inl, n_inl = pnp.ransac_pnp(
                self.cam, jnp.asarray(Pw), jnp.asarray(uv), jnp.asarray(s2),
                jnp.asarray(np.arange(cap) < n), key)
            if int(n_inl) < 10:
                continue
            # robust refinement on the full candidate set (Tracking.cc:1936)
            kp2pt = np.full(s.n_kp, -1, np.int32)
            kp2pt[sel] = pts
            pobs = _gather_pose_obs(
                self.cam, jnp.asarray(s.pt_pos), jnp.asarray(kp2pt),
                fd.feats, self._inv_sigma2_lut)
            T2, _, _, n_in = pose_opt.optimize_pose(self.cam, T, pobs)
            n_in = int(n_in)
            if n_in < 10:
                continue
            # widen/narrow projection rounds to >= 50 inliers
            # (Tracking.cc:1946-1983): local points around the candidate,
            # wide window first, then a narrow confirmation pass
            covis, _ = s.covisible_kfs(kf, min_shared=15, top=10)
            kfs = np.concatenate([[kf], covis]).astype(np.int32)
            pids = np.unique(s.kf_pt_ids[kfs])
            pids = pids[pids >= 0]
            pids = pids[s.pt_valid[pids]]
            for th in (2.5, 0.75):  # ~10 px then ~3 px windows
                if n_in >= 50:
                    break
                kp2pt_w = self._project_view_match(fd, pids, np.asarray(T2),
                                                   th=th)
                kp2pt = np.where(kp2pt >= 0, kp2pt, kp2pt_w)
                pobs = _gather_pose_obs(
                    self.cam, jnp.asarray(s.pt_pos), jnp.asarray(kp2pt),
                    fd.feats, self._inv_sigma2_lut)
                T2, _, _, n_in = pose_opt.optimize_pose(
                    self.cam, jnp.asarray(np.asarray(T2)), pobs)
                n_in = int(n_in)
            if n_in >= 50:  # Tracking.cc:1983 accept gate
                self.ref_kf = kf
                self._refresh_local_view()
                self._refresh_ref_matches()
                return np.asarray(T2).astype(np.float32)
        return None

    def _project_view_match(self, fd: FrameData, pids: np.ndarray,
                            T_cw: np.ndarray, th: float,
                            cap: int = 8192) -> np.ndarray:
        """Project the given map points into the current frame and match
        (SearchByProjection reloc variant, ORBmatcher.cc:1472). Returns
        kp2pid (N,) global ids."""
        s = self.store
        pids = pids[-cap:]
        P = len(pids)
        pad = cap - P
        view = matching.MapPointView(
            pos=jnp.asarray(np.concatenate(
                [s.pt_pos[pids], np.zeros((pad, 3), np.float32)])),
            desc=jnp.asarray(np.concatenate(
                [s.pt_desc[pids], np.zeros((pad, 8), np.uint32)])),
            normal=jnp.asarray(np.concatenate(
                [s.pt_normal[pids], np.zeros((pad, 3), np.float32)])),
            min_dist=jnp.asarray(np.concatenate(
                [s.pt_min_dist[pids], np.zeros(pad, np.float32)])),
            max_dist=jnp.asarray(np.concatenate(
                [s.pt_max_dist[pids], np.zeros(pad, np.float32)])),
            valid=jnp.asarray(np.concatenate(
                [np.ones(P, bool), np.zeros(pad, bool)])),
        )
        _, kp2pt, _, _ = matching.search_by_projection(
            self.cam, jnp.asarray(T_cw.astype(np.float32)), view, fd.feats,
            n_levels=self.orb.n_levels, scale=self.orb.scale, th=th)
        kp2pt = np.asarray(kp2pt)
        pid_arr = np.concatenate([pids, np.full(pad, -1, pids.dtype)])
        return np.where(kp2pt >= 0, pid_arr[np.maximum(kp2pt, 0)],
                        -1).astype(np.int32)

    def _reset_full(self):
        """Auto-reset when tracking is lost soon after initialization
        (Tracking.cc:482-488 -> Tracking::Reset, Tracking.cc:2000-2046):
        clear the map, database and trajectory bookkeeping, reinitialize."""
        self.store = MapStore(self.cam, self.orb)
        self.mapper.close()
        self.kf_cache.clear()
        self.mapper = local_mapping.LocalMapper(
            self.store, self.cfg, cache=self.kf_cache,
            **self._mapper_kwargs)
        if self.pipeline:
            # re-apply the pipelined-mode wiring the constructor set on the
            # ORIGINAL store/mapper: staged line retriangulation rides the
            # tracker IO pool, the view capacity stays pinned, and the BA
            # cadence gate stays load-adaptive
            if self._tr_io is not None:
                self.store.retri_io = self._tr_io
            if self.mapper.fixed_tv_cap is None:
                self.mapper.fixed_tv_cap = 4096
            self.mapper.adaptive_ba_cadence = True
        self._pending_loops.clear()
        if self.loop_closer is not None:
            from ..loop.closing import LoopCloser
            self.loop_closer = LoopCloser(self.store, self.vocabulary,
                                          self.cfg)
            self.mapper.on_kf_culled = self.loop_closer.db.erase
        self.state = TrackState.NOT_INITIALIZED
        self.T_cw = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)
        self.ref_kf = -1
        self.last_kf_frame = -1
        self.logs.clear()
        self._view = None
        self._view_pid = None
        self._prov_kf_pid = None
        # NOTE: self._pending is kept — the in-flight pipelined frame must
        # still be finalized (it reinitializes the fresh map via the
        # _finalize_rec resync path); dropping it here lost its metrics
        # and broke the one-finalize-per-frame invariant.
        self._dev_T = None
        self._resync = True
        if self.enable_lines:
            self._refresh_line_view()

    def _unpack(self, packed: np.ndarray, view_cap: int | None = None,
                has_decide: bool = False):
        """`has_decide`: pipelined rows carry the on-device KF-decision flag
        at index 22 (appended last in the return tuple)."""
        n = self.store.n_kp
        p = view_cap if view_cap is not None else len(self._view_pid)
        T_np = packed[:16].view(np.float32).reshape(4, 4)
        scal = packed[16:22]
        o = 22
        decide = 0
        if has_decide:
            decide = int(packed[22])
            o = 23
        kp2last = packed[o:o + n]; o += n
        kp2pt_l = packed[o:o + n]; o += n
        nw = -(-n // 32)
        pw = -(-p // 32)
        ok = _unpack_bits_np(packed[o:o + nw], n); o += nw
        in_frustum = _unpack_bits_np(packed[o:o + pw], p); o += pw
        prov = packed[o:o + n]
        out = (T_np, *[int(x) for x in scal], kp2last, kp2pt_l, ok,
               in_frustum, prov)
        return out + (decide,) if has_decide else out

    def _track(self, fd: FrameData, timestamp: float, m: TrackMetrics,
               fid: int | None = None):
        if fid is None:
            fid = self.frame_id
        self._flush_kf_pipeline()
        if self.state == TrackState.LOST:
            T_reloc = self._attempt_reloc(fd)
            if T_reloc is not None:
                self.T_cw = T_reloc
                self.velocity = np.eye(4, dtype=np.float32)
                self._has_velocity = False
        if not self._has_velocity and self.ref_kf >= 0 \
                and self.state == TrackState.OK:
            # no motion model (frame after init / reloc / map change): the
            # reference anchors on the reference KF via BoW, not on a blind
            # identity-velocity projection (Tracking.cc:336-344)
            T_anchor = self._ref_anchor_pose(fd)
            T_pred = (T_anchor if T_anchor is not None
                      else (self.velocity @ self.T_cw)).astype(np.float32)
        else:
            T_pred = (self.velocity @ self.T_cw).astype(np.float32)
        import time as _time
        t_d0 = _time.perf_counter()
        out = self._run_step(fd, T_pred)
        m.t_dispatch = _time.perf_counter() - t_d0
        # next-frame device state (stays on device, no transfer)
        dev_ptpos, dev_haspt, dev_ismap = out[1], out[2], out[3]
        dev_prov, dev_final = out[4][0], out[5]
        t_g0 = _time.perf_counter()
        packed = jax.device_get(out[0])
        m.t_get = _time.perf_counter() - t_g0
        return self._track_finalize(fd, packed, dev_ptpos, dev_haspt,
                                    timestamp, m, fid, dev_ismap=dev_ismap,
                                    dev_prov=dev_prov, dev_final=dev_final)

    def _track_finalize(self, fd: FrameData, packed, dev_ptpos, dev_haspt,
                        timestamp: float, m: TrackMetrics, fid: int,
                        dev_ismap=None, dev_prov=None, dev_final=None):
        """Host half of the synchronous track step, from the packed device
        readback on (also the per-sequence finalize of the batched
        multi-sequence driver, parallel/multi_seq.py)."""
        (T_np, n_mm, n_in, tracked_close, untracked_close, n_kp, n_st,
         kp2last, kp2pt_l, ok, in_frustum, prov) = self._unpack(packed)
        m.n_motion_matches = int(n_mm)
        m.n_kp = int(n_kp)
        m.n_stereo = int(n_st)

        if (n_in < self.cfg.tracking.min_track_inliers or n_mm < 20) \
                and self.ref_kf >= 0:
            # motion-model match too weak, or motion+local failed ->
            # re-anchor on the reference KF and redo the step from the
            # anchored pose (TrackReferenceKeyFrame fallback,
            # Tracking.cc:336-345 nmatches<20 gate at :945-948, :773-830)
            T_fb = self._ref_anchor_pose(fd)
            if T_fb is not None:
                out = self._run_step(fd, T_fb)
                packed = jax.device_get(out[0])
                (T_np2, n_mm2, n_in2, tracked_close2, untracked_close2,
                 n_kp, n_st, kp2last2, kp2pt_l2, ok2, in_frustum2,
                 prov2) = self._unpack(packed)
                if n_in2 > n_in:  # keep the better of the two associations
                    # adopt device state TOGETHER with the host association:
                    # a rejected fallback must leave both untouched, or the
                    # next frame pairs point ids from one run with positions
                    # from the other
                    dev_ptpos, dev_haspt, dev_ismap = out[1], out[2], out[3]
                    dev_prov, dev_final = out[4][0], out[5]
                    (T_np, n_mm, n_in, tracked_close, untracked_close,
                     kp2last, kp2pt_l, ok, in_frustum, prov) = (
                        T_np2, n_mm2, n_in2, tracked_close2,
                        untracked_close2, kp2last2, kp2pt_l2, ok2,
                        in_frustum2, prov2)
        m.n_inliers = n_in

        # global point id per keypoint: local-map association wins, else the
        # carried-over last-frame association; masked by the final inliers
        pid = self._view_pid
        kp2pt = np.where(
            kp2pt_l >= 0, pid[np.maximum(kp2pt_l, 0)],
            np.where(kp2last >= 0, self._last_kp2pt[np.maximum(kp2last, 0)], -1),
        ).astype(np.int32)
        if self._prov_kf_pid is not None:
            sel = (kp2pt < 0) & (prov >= 0)
            kp2pt[sel] = self._prov_kf_pid[prov[sel]]
        kp2pt[~ok] = -1

        # visibility stats (SearchLocalPoints IncreaseVisible,
        # Tracking.cc:1613-1675; found via inlier associations)
        vis_ids = pid[in_frustum & (pid >= 0)]
        np.add.at(self.store.pt_visible, vis_ids, 1)
        np.add.at(self.store.pt_found, kp2pt[kp2pt >= 0], 1)

        if n_in < self.cfg.tracking.min_track_inliers:
            if self.store.n_kf <= 5 and not self.localization_only:
                # lost right after initialization: full reset
                # (Tracking.cc:482-488). The frame itself was LOST — the
                # reset to NOT_INITIALIZED is what happens next.
                m.state = TrackState.LOST.name
                self._reset_full()
                return
            self.state = TrackState.LOST
            self._has_velocity = False
            self._log_frame(timestamp, lost=True)
            return

        # --- line association + joint point/line pose refinement ---
        self._cur_det2ln = None
        if self.enable_lines and self._cur_fl is not None \
                and (self._line_view is not None
                     or self._line_view_fut is not None):
            fl = self._cur_fl
            cur = fd.feats
            pobs = pose_opt.PointPoseObs(
                X=dev_ptpos,
                obs=jnp.concatenate([cur.xy, cur.ur[:, None]], axis=-1),
                inv_sigma2=self._inv_sigma2_lut[cur.octave],
                is_stereo=cur.ur >= 0,
                # association inliers only: freshly depth-seeded temporal
                # rows have zero residual at T2 by construction and would
                # anchor the joint point+line refinement at T2
                valid=dev_final if dev_final is not None else dev_haspt,
            )
            T3, det2ln, n_line = _line_step(
                self.cam, jnp.asarray(T_np), *self._get_line_view(), fl, pobs,
                float(self.cfg.line.gamma), float(self._md_gate))
            T_np = np.asarray(T3)
            det2ln = np.asarray(det2ln)
            det2ln_g = np.where(det2ln >= 0,
                                self._line_view_ids[np.maximum(det2ln, 0)],
                                -1).astype(np.int32)
            self._cur_det2ln = det2ln_g
            m.n_line_matches = int(n_line)

        self.state = TrackState.OK
        self.velocity = (T_np @ np.linalg.inv(self.T_cw)).astype(np.float32)
        self._has_velocity = True
        self.T_cw = T_np.astype(np.float32)

        # --- keyframe decision + creation ---
        # (suppressed in localization-only mode,
        #  System::ActivateLocalizationMode, System.cc:121-161)
        new_kf = (not self.localization_only) \
            and self._need_new_kf(n_in, int(tracked_close),
                                  int(untracked_close), fid=fid)
        if new_kf:
            import time as _time
            t0 = _time.perf_counter()
            self._create_kf(fd, kp2pt, timestamp, fid=fid)
            m.t_kf = _time.perf_counter() - t0
            m.new_kf = True
        self._remember_frame(fd, kp2pt, dev_ptpos, dev_haspt,
                             dev_ismap=dev_ismap, dev_prov=dev_prov,
                             refresh=new_kf)
        self._log_frame(timestamp)

    # ------------------------------------------------------------------

    def _need_new_kf(self, n_in: int, tracked_close: int,
                     untracked_close: int, fid: int | None = None) -> bool:
        """NeedNewKeyFrame (Tracking.cc:1223-1310), deterministic-schedule
        reduction: with the mapper always idle the decisive conditions are
        the 75% reference-ratio and the close-point deficit."""
        if fid is None:
            fid = self.frame_id
        if n_in <= 15:
            return False
        # the reference blocks insertion while LocalMapping is busy with the
        # previous KF (Tracking.cc:1223-1310 c1b + InterruptBA); the
        # deterministic analogue is a minimum inter-KF gap of 3 — the depth
        # of the staged mapper pipeline (same constant as the pipelined
        # on-device decision, keeping both schedules identical)
        if fid - self.last_kf_frame < max(
                self.cfg.tracking.min_frames_between_kf, 3):
            return False
        ref_matches = self._ref_matches
        need_close = tracked_close < 100 and untracked_close > 70
        too_old = fid - self.last_kf_frame >= \
            self.cfg.tracking.max_frames_between_kf
        weak = n_in < 0.75 * ref_matches
        return weak or need_close or too_old

    def _create_kf(self, fd: FrameData, kp2pt: np.ndarray, timestamp: float,
                   fid: int | None = None, pipelined: bool = False,
                   snap_fut=None, lines_snap_fut=None,
                   snap_np=None, lines_snap_np=None,
                   n_in_kf: int | None = None) -> bool:
        """CreateNewKeyFrame (Tracking.cc:1367-1444): insert KF, create
        close-depth points (all < ThDepth, or 100 nearest), then run the
        deterministic local-mapping step. Returns True when a loop closure
        corrected the map (the pipelined caller must resync its pose chain).
        `snap_fut`/`lines_snap_fut` optionally carry the frame snapshots
        prefetched on the IO thread (_prefetch_kf_snaps)."""
        import time as _time
        if fid is None:
            fid = self.frame_id
        tt = {}
        t_prev = _time.perf_counter()

        def mark(key):
            nonlocal t_prev
            now = _time.perf_counter()
            tt[key] = now - t_prev
            t_prev = now

        s = self.store
        feats, depth = (snap_np if snap_np is not None
                        else snap_fut.result() if snap_fut is not None
                        else self._snapshot_np(fd))
        mark("snap")
        kf = s.add_keyframe(self.T_cw, feats, depth, kp2pt,
                            fid, timestamp)
        # candidates: valid stereo depth, no existing association
        cand = np.nonzero((depth > 0) & feats["valid"] & (kp2pt < 0))[0]
        order = cand[np.argsort(depth[cand])]
        z = depth[order]
        take = (z < self.cfg.close_depth)
        take[:min(100, len(take))] = True
        sel = order[take]
        if len(sel):
            cam = self.cam
            uv = feats["xy"][sel]
            zz = depth[sel]
            T_wc = np.linalg.inv(self.T_cw)
            Xc = np.stack([(uv[:, 0] - cam.cx) * zz / cam.fx,
                           (uv[:, 1] - cam.cy) * zz / cam.fy, zz], -1)
            Xw = (T_wc[:3, :3] @ Xc.T).T + T_wc[:3, 3]
            ids = s.create_points(kf, sel, Xw.astype(np.float32))
            kp2pt[sel] = ids
        # feature -> point-id table of this (now latest) keyframe: resolves
        # the on-device provisional identities of in-flight frames
        self._prov_kf_pid = kp2pt.copy()
        mark("pts")
        if self.enable_lines and self._cur_fl is not None:
            self._create_kf_lines(kf, lines_snap_fut=lines_snap_fut,
                                  lines_snap_np=lines_snap_np)
        mark("lines")
        s.set_parent_from_covisibility(kf)
        self.ref_kf = kf
        self.last_kf_frame = fid
        # register the frame's device feature arrays in the KF cache (zero
        # channel traffic: device->device copy)
        self.mapper.cache_frame(kf, fd.feats)
        mark("cache")
        t0 = _time.perf_counter()
        if pipelined:
            # staged: dispatch triangulation+fusion and the BoW descent now,
            # absorb one stage per subsequent finalized frame
            # (_step_kf_pipeline) — the deterministic analogue of the
            # reference's LocalMapping/LoopClosing thread overlap
            voc = (self.loop_closer.voc if self.loop_closer is not None
                   else None)
            mark("bow")
            # dispatching this KF force-absorbs a still-pending previous KF
            # stage (back-to-back keyframes) — its staged BoW words surface
            # via absorbed_words below, BEFORE the previous pending loop
            # step is absorbed, so the words ride the staged path instead
            # of falling back to the host descent
            self.mapper.dispatch_kf_stage(kf, voc=voc, fuse_ba=True)
            self._adopt_view()
            self._match_loop_words()
            if self.loop_closer is not None:
                # queue this KF's loop step; it absorbs once its staged
                # words land (every KF reaches the BoW database — absorbing
                # EARLY with words=None would fall back to the host
                # descent)
                self._pending_loops.append([kf, None])
            mark("dispatch")
            self._refresh_ref_matches()
            if self._tr_io is not None:
                # ship the fresh reference match count + measured
                # kappa = ref_matches/n_in to the on-device decision chain
                # (adopted at a subsequent dispatch; the gap gate covers the
                # swap latency)
                if n_in_kf:
                    self._kappa = float(np.clip(
                        self._ref_matches / max(n_in_kf, 1), 0.2, 1.2))
                self._refm_fut = self._tr_io.submit(
                    jax.device_put,
                    np.float32([self._ref_matches, self._kappa]))
            if self.enable_lines:
                self._refresh_line_view()
            mark("refresh")
            tt["mapper"] = tt.pop("dispatch")
            tt["loop"] = tt["view"] = 0.0
            self.kf_timings.append(tt)
            return False
        # deterministic local-mapping step (replaces the LocalMapping thread)
        view_out = self.mapper.process_keyframe(kf)
        t1 = _time.perf_counter()
        # deterministic loop-closing step (replaces the LoopClosing thread)
        corrected = False
        if self.loop_closer is not None:
            corrected = self.loop_closer.process_keyframe(kf)
        t2 = _time.perf_counter()
        # refresh current pose from the (BA/loop-)corrected KF pose
        self.T_cw = s.kf_pose[kf].copy()
        if view_out is not None and not corrected:
            # post-BA view assembled on device by the BA program
            self._view, self._view_pid = view_out
        else:
            self._refresh_local_view()
        self._refresh_ref_matches()
        if self.enable_lines:
            self._refresh_line_view()
        t3 = _time.perf_counter()
        self.kf_timings.append(
            dict(mapper=t1 - t0, loop=t2 - t1, view=t3 - t2))
        return corrected

    def _create_kf_lines(self, kf: int, lines_snap_fut=None,
                         lines_snap_np=None):
        """Line half of keyframe creation: snapshot the frame's detections,
        attach observations of associated map lines, create new map lines
        from unassociated stereo-triangulated detections (the MatchLinesLastKF
        -> new MapLine path, Tracking.cc:1449-1611 intent), and cull."""
        import time as _time
        lt = getattr(self, "line_kf_times", None)
        if lt is None:
            lt = self.line_kf_times = {}

        def lmark(key, t0=[None]):
            now = _time.perf_counter()
            if key is not None and t0[0] is not None:
                lt[key] = lt.get(key, 0.0) + (now - t0[0])
            t0[0] = now

        lmark(None)
        s = self.store
        fl = self._cur_fl
        buf = (lines_snap_np if lines_snap_np is not None
               else lines_snap_fut.result() if lines_snap_fut is not None
               else np.asarray(_pack_frame_lines(fl)))
        snap = _unpack_frame_lines_np(buf, s.n_ln_det, s.ln_desc.shape[1])
        lmark("snap")
        lines_np = {k: snap[k] for k in
                    ("p1", "p2", "p1r", "p2r", "has_r", "octave", "desc",
                     "valid")}
        det2ln = (self._cur_det2ln if self._cur_det2ln is not None
                  else np.full(s.n_ln_det, -1, np.int32))
        s.add_keyframe_lines(kf, lines_np, det2ln.copy())
        # new lines: valid stereo-triangulated detections without a map line;
        # only long segments seed (direction noise of single-pair stereo
        # triangulation scales with 1/length; multi-view refinement below
        # sharpens them once a second KF observes them)
        lengths = np.linalg.norm(lines_np["p2"] - lines_np["p1"], axis=-1)
        # >= 28 px seeding gate: single-pair direction noise scales with
        # 1/length, but the multi-view retriangulation sharpens survivors —
        # the round-3 40 px gate starved the map (median 2-4 matches/frame
        # vs the reference's line-rich benchmark configs)
        newsel = np.nonzero(lines_np["valid"] & lines_np["has_r"]
                            & (det2ln < 0) & (lengths >= 28.0))[0]
        newsel = newsel[: s.room_for_lines(len(newsel))]
        if len(newsel):
            X0c = snap["X0"][newsel]
            dc = snap["d"][newsel]
            T_wc = np.linalg.inv(self.T_cw)
            Pw = (T_wc[:3, :3] @ X0c.T).T + T_wc[:3, 3]
            dw = (T_wc[:3, :3] @ dc.T).T
            dw /= np.maximum(np.linalg.norm(dw, axis=-1, keepdims=True), 1e-9)
            X0w = Pw - np.sum(Pw * dw, axis=-1, keepdims=True) * dw
            s.create_lines(kf, newsel, X0w.astype(np.float32),
                           dw.astype(np.float32))
        lmark("create")
        s.retriangulate_lines()
        lmark("retri")
        s.cull_lines()
        lmark("cull")
        # keep line descriptors distinctive as viewpoints accumulate
        # (MapLine.cc:133-201)
        s.update_line_descriptors()
        lmark("desc")
        lt["n"] = lt.get("n", 0) + 1

    # ------------------------------------------------------------------

    def trajectory(self):
        """(timestamps, T_wc stack) replayed through reference keyframes."""
        from ..io import trajectory as traj
        rel = np.stack([l.T_cr for l in self.logs])
        refs = np.array([l.ref_kf for l in self.logs])
        ts = np.array([l.timestamp for l in self.logs])
        T_wc = traj.replay_trajectory(rel, refs, self.store.kf_pose)
        return ts, T_wc
