"""Headline benchmark: stereo tracking throughput at the KITTI workload.

Runs the full deterministic pipeline (System.track_stereo: ORB extraction,
stereo matching, projection association, pose optimization, staged keyframe
path — triangulation, fusion, local BA, BoW loop detection) on a synthetic
KITTI-sized sequence (1241x376, 2000 features, 8 levels — the reference
workload, KITTI04-12_LBD.yaml:38-51) and reports frames/second on the
GPU. It stops with a non-zero exit when JAX finds no GPU: a CPU run's
numbers are never printed as the result.

Baseline: the reference's real-time budget on an i7 CPU is 10 fps at this
workload (BASELINE.md: KITTI pacing, stereo_kitti.cc:116-124).
`vs_baseline` = measured fps / 10; the BASELINE.json target is >= 3.

The headline metric PRE-STAGES the measured frames in device memory (the
analogue of the reference reading page-cached PNGs) and times the full
pipeline; the ingest-included number (host->device upload inside the timed
loop, prefetch depth 4) is also measured and printed alongside.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
...}.
"""
import json
import sys
import time

import numpy as np


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _make_tex(rng, h_m: float, w_m: float, res: float, stripe_every=None):
    """Multi-octave block texture for a plane (h_m x w_m metres, `res`
    px/metre): random intensity blocks at 2 m / 0.5 m / 0.125 m cells give
    FAST corners and BRIEF texture at every viewing distance, exactly the
    scale-covariant statistics ORB's octave prediction assumes. Optional
    vertical stripes (for the line workload) at `stripe_every` metres."""
    h_px, w_px = int(h_m * res), int(w_m * res)
    t = np.zeros((h_px, w_px), np.float32)
    for cell_m, amp in ((2.0, 55.0), (0.5, 45.0), (0.125, 35.0)):
        c_px = max(int(cell_m * res), 1)
        ch, cw = h_px // c_px + 1, w_px // c_px + 1
        blocks = rng.uniform(-amp, amp, (ch, cw)).astype(np.float32)
        t += np.kron(blocks, np.ones((c_px, c_px), np.float32))[:h_px, :w_px]
    t = np.clip(t + 128.0, 8.0, 248.0)
    if stripe_every is not None:
        x = stripe_every
        while x < w_m:
            x0, x1 = int(x * res), int((x + 0.18) * res)
            t[:, x0:x1] = 235.0 if (int(x / stripe_every) % 2 == 0) else 18.0
            x += stripe_every
    return t


def _sample_tex(tex, u_px, v_px):
    """Bilinear texture fetch with clipped coordinates (vectorized)."""
    h, w = tex.shape
    u = np.clip(u_px, 0.0, w - 1.001)
    v = np.clip(v_px, 0.0, h - 1.001)
    u0 = u.astype(np.int32)
    v0 = v.astype(np.int32)
    fu = u - u0
    fv = v - v0
    return (tex[v0, u0] * (1 - fu) * (1 - fv)
            + tex[v0, u0 + 1] * fu * (1 - fv)
            + tex[v0 + 1, u0] * (1 - fu) * fv
            + tex[v0 + 1, u0 + 1] * fu * fv)


def _make_sequence(cam, n_frames: int, n_per_m: float = 40.0, seed: int = 0,
                   with_lines: bool = False, half_w: float = 8.0,
                   cam_h: float = 1.65, speed: float = 1.0,
                   return_poses: bool = False):
    """Synthetic forward-motion stereo corridor, rendered by ray-casting
    textured planes (ground + two walls + end wall) with full perspective.

    Unlike the round-2/early-round-3 sprite worlds (fixed- or scaled-pixel
    patch stamps), every pixel here is a true projection of static 3D
    texture, so appearance is scale- and viewpoint-covariant: detected ORB
    octaves track MapPoint::PredictScale, descriptors are stable between
    frames, and association statistics match real imagery (KITTI-like
    feature lifetimes -> the reference's natural ~1-KF-per-4-8-frames
    cadence, NeedNewKeyFrame Tracking.cc:1223-1310). `with_lines` paints
    high-contrast vertical stripes on the walls — static 3D vertical line
    segments for the LLD line workload. `n_per_m` kept for signature
    compatibility (texture density is fixed per metre)."""
    import jax.numpy as jnp
    from lldslam_tpu.geometry import se3

    rng = np.random.default_rng(seed)
    W, H = cam.width, cam.height
    length = 220.0 + 1.0 * n_frames
    res = 48.0                      # texture px per metre
    # half_w: corridor half-width (m); cam_h: camera height over ground;
    # speed: metres per frame — narrower/slower = indoor (EuRoC-like)
    wall_top = -6.0                 # wall extent above camera (y up is -)
    stripes = 3.0 if with_lines else None
    ground = _make_tex(rng, 2 * half_w, length, res)
    wall_l = _make_tex(rng, cam_h - wall_top, length, res,
                       stripe_every=stripes)
    wall_r = _make_tex(rng, cam_h - wall_top, length, res,
                       stripe_every=stripes)
    endw = _make_tex(rng, cam_h - wall_top, 2 * half_w, res)

    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    dx = (xs - cam.cx) / cam.fx     # camera-frame ray dirs at z=1
    dy = (ys - cam.cy) / cam.fy

    def render(C, Rwc):
        """Ray-cast one camera: center C (world), rotation Rwc (cam->world).
        Camera frame: x right, y down, z forward; world starts aligned."""
        d = (Rwc[:, 0][:, None, None] * dx[None]
             + Rwc[:, 1][:, None, None] * dy[None]
             + Rwc[:, 2][:, None, None])          # (3, H, W)
        img = np.full((H, W), 12.0, np.float32)
        best_t = np.full((H, W), np.inf, np.float32)
        # plane list: (axis, offset, sign test, tex, (u_m, v_m) mapping)
        # ground: y = +cam_h
        with np.errstate(divide="ignore", invalid="ignore"):
            for which in ("ground", "wl", "wr", "end"):
                if which == "ground":
                    denom = d[1]
                    tt = (cam_h - C[1]) / denom
                elif which == "wl":
                    denom = d[0]
                    tt = (-half_w - C[0]) / denom
                elif which == "wr":
                    denom = d[0]
                    tt = (half_w - C[0]) / denom
                else:
                    denom = d[2]
                    tt = (length - C[2]) / denom
                valid = (np.abs(denom) > 1e-9) & (tt > 0.25)
                X = C[0] + tt * d[0]
                Y = C[1] + tt * d[1]
                Z = C[2] + tt * d[2]
                if which == "ground":
                    inside = (np.abs(X) <= half_w) & (Z >= 0) & (Z <= length)
                    u_m, v_m, tex = Z, X + half_w, ground
                elif which in ("wl", "wr"):
                    inside = (Y >= wall_top) & (Y <= cam_h) \
                        & (Z >= 0) & (Z <= length)
                    tex = wall_l if which == "wl" else wall_r
                    u_m, v_m = Z, Y - wall_top
                else:
                    inside = (np.abs(X) <= half_w) & (Y >= wall_top) \
                        & (Y <= cam_h)
                    u_m, v_m, tex = X + half_w, Y - wall_top, endw
                hit = valid & inside & (tt < best_t)
                if not hit.any():
                    continue
                val = _sample_tex(tex, u_m[hit] * res, v_m[hit] * res)
                img[hit] = val
                best_t[hit] = tt[hit]
        return img

    frames = []
    poses = []
    T = np.eye(4, dtype=np.float32)   # T_cw
    xi = np.array([0.0, 0.0, -1.0 * speed, 0.0, 0.003, 0.0], np.float32)
    dT = np.asarray(se3.exp(jnp.asarray(xi)))
    for _ in range(n_frames):
        poses.append(T.copy())
        Twc = np.linalg.inv(T)
        Rwc, C = Twc[:3, :3], Twc[:3, 3]
        C_r = C + Rwc[:, 0] * cam.baseline
        imL = render(C, Rwc) + rng.normal(0, 1.2, (H, W))
        imR = render(C_r, Rwc) + rng.normal(0, 1.2, (H, W))
        frames.append((np.clip(imL, 0, 255).astype(np.uint8),
                       np.clip(imR, 0, 255).astype(np.uint8)))
        T = dT @ T
    if return_poses:
        return frames, poses, dict(half_w=half_w, cam_h=cam_h,
                                   length=length, wall_top=wall_top)
    return frames


def _snap_times(sys_):
    """Snapshot cumulative stage-time dicts so _report can show the
    MEASURED section only (warmup compiles/cache backfills otherwise smear
    every per-KF average)."""
    lc = sys_.tracker.loop_closer
    return (dict(sys_.tracker.mapper.stage_times),
            dict(lc.stage_times) if lc is not None else {},
            dict(getattr(sys_.tracker, "line_kf_times", {}) or {}))


def _delta(cur, base):
    return {k: v - base.get(k, 0) for k, v in cur.items()
            if v - base.get(k, 0)}


def _report(sys_, ms, label, kt0: int = 0, t_snap=None):
    _log("bench[{}]: avg dispatch {:.1f}ms get {:.1f}ms".format(
        label,
        1e3 * np.mean([x.t_dispatch for x in ms]),
        1e3 * np.mean([x.t_get for x in ms])))
    n_kf = sum(x.new_kf for x in ms)
    _log("bench[{}]: avg build {:.1f}ms step {:.1f}ms kf {:.1f}ms ({} KFs)"
         .format(label,
                 1e3 * np.mean([x.t_build for x in ms]),
                 1e3 * np.mean([x.t_step for x in ms]),
                 1e3 * np.sum([x.t_kf for x in ms]) / max(1, n_kf), n_kf))
    kt = sys_.tracker.kf_timings[kt0:]
    if kt:
        keys = sorted({k for d in kt for k in d})
        _log("bench[{}]: kf path avg ".format(label) + " ".join(
            f"{k}={1e3 * np.mean([d.get(k, 0.0) for d in kt]):.0f}ms"
            for k in keys))
    mst = sys_.tracker.mapper.stage_times
    if t_snap is not None:
        mst = _delta(mst, t_snap[0])
    if mst.get("n"):
        _log("bench[{}]: mapper stages avg ".format(label) + " ".join(
            f"{k}={1e3 * v / mst['n']:.0f}ms" for k, v in mst.items()
            if k != "n" and not k.endswith("dropped")))
        drops = {k: v for k, v in mst.items() if k.endswith("dropped")}
        if drops:
            _log(f"bench[{label}]: mapper drops {drops}")
    lkt = getattr(sys_.tracker, "line_kf_times", None)
    if t_snap is not None and lkt:
        lkt = _delta(lkt, t_snap[2])
    if lkt and lkt.get("n"):
        _log("bench[{}]: line kf avg ".format(label) + " ".join(
            f"{k}={1e3 * v / lkt['n']:.0f}ms" for k, v in lkt.items()
            if k != "n"))
    lc = sys_.tracker.loop_closer
    if lc is not None and lc.stage_times.get("n"):
        ls = lc.stage_times
        if t_snap is not None:
            ls = _delta(ls, t_snap[1])
        # stage_times mixes per-stage seconds with event COUNTS
        # (n_candidates); only the former go through the ms formatter
        counts = {k: v for k, v in ls.items()
                  if k == "n" or k.startswith("n_")}
        _log("bench[{}]: loop stages avg ".format(label) + " ".join(
            f"{k}={1e3 * v / ls['n']:.0f}ms" for k, v in ls.items()
            if k not in counts))
        _log("bench[{}]: loop counts ".format(label) + " ".join(
            f"{k}={v}" for k, v in counts.items()))
        if lc.events:
            _log("bench[{}]: LOOP EVENTS (should be none on this corridor): "
                 .format(label) + ", ".join(
                     f"{e.query_kf}<->{e.matched_kf}({e.n_inliers})"
                     for e in lc.events))
    st_ = sys_.tracker.store
    if getattr(st_, "covis_n", 0):
        _log(f"bench[{label}]: covisible_kfs calls {st_.covis_n} "
             f"({1e3 * st_.covis_s / st_.covis_n:.1f}ms avg)")
    if getattr(st_, "obs_rebuild_n", 0):
        _log(f"bench[{label}]: obs index rebuilds {st_.obs_rebuild_n} "
             f"({1e3 * st_.obs_rebuild_s / st_.obs_rebuild_n:.1f}ms avg)")
    if sys_.tracker.store.cap_events:
        _log(f"bench[{label}]: capacity events "
             f"{sys_.tracker.store.cap_events}")


def main():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        _log(f"bench: no GPU (JAX platform {dev.platform!r}); nothing measured")
        sys.exit(2)
    from lldslam_tpu.config import CameraConfig, SlamConfig, TrackingConfig
    from lldslam_tpu.ops.orb import OrbConfig
    from lldslam_tpu.system import System

    cam_cfg = CameraConfig(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                           bf=386.1448, fps=10.0, width=1241, height=376)
    cfg = SlamConfig(camera=cam_cfg, orb=OrbConfig(n_features=2000),
                     tracking=TrackingConfig(min_init_points=100))
    n_warm, n_meas = 6, 40
    _log("bench: generating sequence...")
    frames = _make_sequence(cam_cfg.stereo_camera(), n_warm + n_meas)

    # --- headline: device-staged frames, MEDIAN OF 3 runs (single runs
    # vary with host scheduling) ---
    def _headline_once(rep: int) -> float:
        sys_ = System(cfg, pipeline=True)
        if rep == 0:
            _log("bench: pre-compiling device programs...")
        sys_.warmup()
        for i in range(n_warm):
            t = time.perf_counter()
            sys_.track_stereo(*frames[i], timestamp=i * 0.1)
            if rep == 0:
                _log(f"bench: warm frame {i}: {time.perf_counter() - t:.1f}s")
        staged = [sys_.tracker.stage_pair(l, r)
                  for l, r in frames[n_warm:n_warm + n_meas]]
        import jax
        jax.block_until_ready(staged[-1])
        m0 = len(sys_.tracker.metrics)
        kt0 = len(sys_.tracker.kf_timings)
        t_snap = _snap_times(sys_)
        import gc
        gc.collect()
        gc.disable()
        t0 = time.perf_counter()
        for i, h in enumerate(staged):
            sys_.track_stereo(None, None, timestamp=(n_warm + i) * 0.1,
                              pair_dev=h)
        sys_.flush()
        gc.enable()
        dt = time.perf_counter() - t0
        f = n_meas / dt
        _log(f"bench: {n_meas} frames in {dt:.2f}s (device-staged, rep "
             f"{rep})")
        if rep == 0:
            _report(sys_, sys_.tracker.metrics[m0:], "staged", kt0=kt0,
                    t_snap=t_snap)
        sys_.shutdown()   # stop this System's IO pools before the next
        return f

    reps = [_headline_once(r) for r in range(3)]
    fps = float(np.median(reps))
    _log("bench: headline reps " + " ".join(f"{r:.2f}" for r in reps)
         + f" -> median {fps:.2f} (spread {max(reps) - min(reps):.2f})")

    # --- ingest-included: frames uploaded inside the timed loop,
    # prefetch depth 4 ---
    frames2 = _make_sequence(cam_cfg.stereo_camera(), n_meas, seed=1)
    sys2 = System(cfg, pipeline=True)
    for i in range(4):
        sys2.track_stereo(*frames2[i], timestamp=i * 0.1)
    depth = 4
    t0 = time.perf_counter()
    q = [sys2.stage_stereo(*frames2[4 + j]) for j in range(depth)]
    for i in range(4, n_meas):
        k = i + depth
        if k < n_meas:
            q.append(sys2.stage_stereo(*frames2[k]))
        sys2.track_stereo(None, None, timestamp=i * 0.1, pair_dev=q.pop(0))
    sys2.flush()
    dt2 = time.perf_counter() - t0
    sys2.shutdown()
    fps2 = (n_meas - 4) / dt2
    _log(f"bench: ingest-included {fps2:.2f} fps "
         f"({1e3 * dt2 / (n_meas - 4):.1f} ms/frame)")

    # --- lines configuration: the reference's benchmark config (stored
    # LBD detections + points, KITTI04-12_LBD.yaml:73-77) ---
    fps3 = _bench_lines(cam_cfg, n_meas)

    # --- batched multi-sequence sweep (BASELINE 13-sequence capability:
    # S sequences' per-frame compute in ONE vmapped program) ---
    fps4 = _bench_multi_seq()

    print(json.dumps({
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "metric": "kitti_stereo_tracking_throughput",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / 10.0, 2),
        "headline_reps": [round(r, 2) for r in reps],
        "lines_fps": round(fps3, 2),
        "ingest_fps": round(fps2, 2),
        "multi_seq_fps_agg": round(fps4, 2),
    }))


def _bench_multi_seq(n_seq: int = 13, n_meas: int = 14) -> float:
    """Aggregate frames/s of the batched multi-sequence driver at the
    BASELINE 13-sequence sweep scale (the reference runs its per-sequence
    CLI loop once per sequence, stereo_kitti.cc:96-142; here the per-frame
    compute of all S sequences shares one vmapped program). Also measures a
    SOLO pipelined run at the SAME per-sequence workload so the batching
    payoff (aggregate/solo) is explicit. Smaller camera keeps the one-off
    S-batched compile bounded."""
    import time
    import jax
    from lldslam_tpu.config import CameraConfig, SlamConfig, TrackingConfig
    from lldslam_tpu.ops.orb import OrbConfig
    from lldslam_tpu.parallel.multi_seq import PipelinedMultiSequenceDriver
    from lldslam_tpu.system import System

    cam_cfg = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=120.0,
                           bf=200.0, fps=10.0, width=640, height=240)
    cfg = SlamConfig(camera=cam_cfg, orb=OrbConfig(n_features=600),
                     tracking=TrackingConfig(min_init_points=80))
    n_warm = 4
    _log("bench: multi-seq worlds...")
    seqs = [_make_sequence(cam_cfg.stereo_camera(), n_warm + n_meas,
                           seed=10 + i) for i in range(n_seq)]

    # solo baseline: one pipelined tracker at the identical workload
    # (warmed over a full pass so no first-compiles land in the timing;
    # device-staged frames, same as the batch measurement)
    solo = System(cfg, enable_loops=False, pipeline=True)
    solo.warmup()
    for f in range(n_warm + n_meas):
        solo.track_stereo(*seqs[0][f], timestamp=f * 0.1)
    solo.flush()
    solo2 = System(cfg, enable_loops=False, pipeline=True)
    staged0 = [solo2.tracker.stage_pair(*seqs[0][f])
               for f in range(n_warm + n_meas)]
    jax.block_until_ready(staged0[-1])
    for f in range(n_warm):
        solo2.track_stereo(None, None, timestamp=f * 0.1,
                           pair_dev=staged0[f])
    t0 = time.perf_counter()
    for f in range(n_warm, n_warm + n_meas):
        solo2.track_stereo(None, None, timestamp=f * 0.1,
                           pair_dev=staged0[f])
    solo2.flush()
    solo_fps = n_meas / (time.perf_counter() - t0)
    solo.shutdown()
    solo2.shutdown()
    _log(f"bench: multi-seq solo baseline {solo_fps:.2f} fps "
         f"(same workload, pipelined, device-staged)")

    # warm a throwaway driver over a FULL pass first: keyframe/BA programs
    # compile lazily as the maps grow (p-bucket jumps mid-sequence), and a
    # compile landing inside the timed loop would dominate the measurement
    _log("bench: multi-seq warmup (full compile pass)...")
    drv0 = PipelinedMultiSequenceDriver(cfg, n_seq, enable_loops=False)
    staged = [[drv0.trackers[i].stage_pair(*seqs[i][f])
               for i in range(n_seq)] for f in range(n_warm + n_meas)]
    for f in range(n_warm + n_meas):
        drv0.process([None] * n_seq, [f * 0.1] * n_seq,
                     pair_devs=staged[f])
    drv0.flush()
    for tr in drv0.trackers:
        if tr._tr_io is not None:
            tr._tr_io.shutdown(wait=False, cancel_futures=True)
            tr._tr_io = None
        tr.mapper.close()
    drv0._io.shutdown(wait=False, cancel_futures=True)

    drv = PipelinedMultiSequenceDriver(cfg, n_seq, enable_loops=False)
    staged = [[drv.trackers[i].stage_pair(*seqs[i][f])
               for i in range(n_seq)] for f in range(n_warm + n_meas)]
    for f in range(n_warm):
        drv.process([None] * n_seq, [f * 0.1] * n_seq,
                    pair_devs=staged[f])
    drv.step_times = {}
    t0 = time.perf_counter()
    for f in range(n_warm, n_warm + n_meas):
        drv.process([None] * n_seq, [f * 0.1] * n_seq,
                    pair_devs=staged[f])
    drv.flush()
    dt = time.perf_counter() - t0
    fps = n_seq * n_meas / dt
    states = [tr.state.name for tr in drv.trackers]
    _log(f"bench: multi-seq {n_seq}x{n_meas} frames in {dt:.2f}s "
         f"({fps:.2f} fps aggregate, {fps / n_seq:.2f}/seq, "
         f"{fps / max(solo_fps, 1e-9):.2f}x solo); states {states}")
    _log("bench: multi-seq note: all sequences share ONE GPU, so the "
         "aggregate is the batched program's rate, not a multi-device one")
    st = getattr(drv, "step_times", None)
    if st:
        _log("bench: multi-seq step phases (per measured frame) " + " ".join(
            f"{k}={1e3 * v / n_meas:.0f}ms" for k, v in st.items()))
    _log(f"bench: multi-seq rebuilds {getattr(drv, 'n_rebuilds', 0)}")
    return fps


def _gen_stored_lines_ref_scale(cam, poses, world, left: str, right: str,
                                seed: int = 5, dz: float = 0.32,
                                desc_dim: int = 40):
    """Reference-scale stored LBD detections, generated GEOMETRICALLY.

    The reference's benchmark configs load precomputed LBD detections from
    disk — hundreds per frame (KITTI04-12_LBD.yaml:73-77; the O(L^2)
    TwoFrameLineMatcher is sized for that) — and never touch pixels for
    lines. This does the same: dense 3D wall segments of the bench corridor
    projected with the ground-truth trajectory, one stable 40-d descriptor
    per SEGMENT plus per-observation noise well inside the md gate. Yields
    ~300-450 lines/frame, so a 256 capacity also exercises the
    capacity-overflow logging (StoredLineSource.cap_events)."""
    from lldslam_tpu.io.stored_lines import save_frame_lines

    rng = np.random.default_rng(seed)
    half_w, cam_h = world["half_w"], world["cam_h"]
    length, wall_top = world["length"], world["wall_top"]
    segs, descs = [], []
    for x in (-half_w, half_w):
        for z in np.arange(1.0, length, dz):
            y0 = rng.uniform(wall_top + 1.0, 0.2)
            y1 = min(y0 + rng.uniform(1.2, 3.0), cam_h - 0.1)
            segs.append(((x, y0, z + rng.uniform(-0.15, 0.15)),
                         (x, y1, z + rng.uniform(-0.15, 0.15))))
            d = rng.normal(size=desc_dim).astype(np.float32)
            descs.append(d / np.linalg.norm(d))
        # horizontal rails every ~4 m
        for z in np.arange(2.0, length, 7.5 * dz):
            y = rng.uniform(wall_top + 1.5, 0.8)
            segs.append(((x, y, z), (x, y, z + rng.uniform(2.0, 4.0))))
            d = rng.normal(size=desc_dim).astype(np.float32)
            descs.append(d / np.linalg.norm(d))
    P1 = np.array([s[0] for s in segs], np.float32)
    P2 = np.array([s[1] for s in segs], np.float32)
    D = np.array(descs, np.float32)
    W, H = cam.width, cam.height

    def project(T_cw, off_x=0.0):
        R, t = T_cw[:3, :3], T_cw[:3, 3].copy()
        # right camera: shift the CAMERA center by +baseline along cam x
        t = t - np.array([off_x, 0.0, 0.0], np.float32)
        X1 = P1 @ R.T + t
        X2 = P2 @ R.T + t
        ok = (X1[:, 2] > 0.5) & (X2[:, 2] > 0.5)
        u1 = cam.fx * X1[:, 0] / np.maximum(X1[:, 2], 1e-6) + cam.cx
        v1 = cam.fy * X1[:, 1] / np.maximum(X1[:, 2], 1e-6) + cam.cy
        u2 = cam.fx * X2[:, 0] / np.maximum(X2[:, 2], 1e-6) + cam.cx
        v2 = cam.fy * X2[:, 1] / np.maximum(X2[:, 2], 1e-6) + cam.cy
        m = 2.0
        ok &= (u1 > m) & (u1 < W - m) & (v1 > m) & (v1 < H - m)
        ok &= (u2 > m) & (u2 < W - m) & (v2 > m) & (v2 < H - m)
        ok &= np.hypot(u2 - u1, v2 - v1) > 26.0
        return np.stack([u1, v1], -1), np.stack([u2, v2], -1), ok

    counts = []
    for i, T_cw in enumerate(poses):
        for d, off in ((left, 0.0), (right, cam.baseline)):
            p1, p2, ok = project(T_cw, off)
            idx = np.nonzero(ok)[0]
            nz = rng.normal(0, 0.008, (len(idx), desc_dim)).astype(np.float32)
            save_frame_lines(d, i, p1[idx], p2[idx],
                             np.zeros(len(idx), np.int32),
                             D[idx] + nz,
                             valid=np.ones(len(idx), bool))
            if off == 0.0:
                counts.append(len(idx))
    _log(f"bench: stored-line workload {int(np.median(counts))} lines/frame "
         f"median (min {min(counts)}, max {max(counts)}), "
         f"{len(segs)} world segments")


def _bench_lines(cam_cfg, n_meas: int) -> float:
    """Stored-LBD lines + points throughput (the reference's KITTI benchmark
    configuration): precomputed detections at REFERENCE SCALE (hundreds of
    lines/frame) loaded from disk, tracked with the stored-line route,
    pre-staged like the images."""
    import tempfile
    import jax
    from lldslam_tpu.config import LineConfig, SlamConfig, TrackingConfig
    from lldslam_tpu.io.stored_lines import stage_stored_pair
    from lldslam_tpu.ops.orb import OrbConfig
    from lldslam_tpu.system import System

    n_warm = 6
    cam = cam_cfg.stereo_camera()
    frames, poses, world = _make_sequence(cam, n_warm + n_meas, seed=2,
                                          with_lines=True, return_poses=True)
    tmp = tempfile.mkdtemp(prefix="bench_lines_")
    left, right = f"{tmp}/left", f"{tmp}/right"
    _log("bench: generating reference-scale stored line detections...")
    _gen_stored_lines_ref_scale(cam, poses, world, left, right)
    cfg = SlamConfig(
        camera=cam_cfg, orb=OrbConfig(n_features=2000),
        line=LineConfig(ld_type="LBDFloat", md_thr=0.6,
                        detections_path=left, descriptors_path=right),
        tracking=TrackingConfig(min_init_points=100))
    sys_ = System(cfg, pipeline=True)
    _log("bench: lines warmup...")
    sys_.warmup()
    for i in range(n_warm):
        t = time.perf_counter()
        sys_.track_stereo(*frames[i], timestamp=i * 0.1)
        _log(f"bench: lines warm frame {i}: {time.perf_counter() - t:.1f}s")
    src = sys_.tracker._line_source
    staged = [(sys_.tracker.stage_pair(*frames[n_warm + j]),
               stage_stored_pair(src[0], src[1], n_warm + j))
              for j in range(n_meas)]
    jax.block_until_ready(staged[-1][0])
    m0 = len(sys_.tracker.metrics)
    kt0 = len(sys_.tracker.kf_timings)
    t_snap = _snap_times(sys_)
    t0 = time.perf_counter()
    for j, (h, lv) in enumerate(staged):
        sys_.track_stereo(None, None, timestamp=(n_warm + j) * 0.1,
                          pair_dev=h, lines_dev=lv)
    sys_.flush()
    dt = time.perf_counter() - t0
    fps = n_meas / dt
    ms = sys_.tracker.metrics[m0:]
    n_line = [m.n_line_matches for m in ms]
    _log(f"bench: lines {n_meas} frames in {dt:.2f}s ({fps:.2f} fps); "
         f"line matches/frame median {int(np.median(n_line))}; "
         f"map lines {sys_.map.n_ln}")
    _log(f"bench: stored-line cap events {src[0].cap_events + src[1].cap_events} "
         f"frames, {src[0].cap_dropped + src[1].cap_dropped} lines dropped "
         f"(capacity {sys_.tracker.store.n_ln_det})")
    _report(sys_, ms, "lines", kt0=kt0, t_snap=t_snap)
    sys_.shutdown()
    return fps


if __name__ == "__main__":
    main()
