"""Fine-grained profile of the per-frame and keyframe paths on the GPU.

Times, in steady state (post-compile), each device program separately:
  build_frame | _track_step | end-to-end process() | KF path pieces
and prints a ms breakdown to stderr.
"""
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp


def log(m):
    print(m, file=sys.stderr, flush=True)


def timeit(fn, *a, n=10, **kw):
    out = fn(*a, **kw)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*a, **kw)
        jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from lldslam_tpu.config import CameraConfig, SlamConfig, TrackingConfig
    from lldslam_tpu.ops.orb import OrbConfig
    from lldslam_tpu.system import System
    from bench import _make_sequence

    cam_cfg = CameraConfig(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                           bf=386.1448, fps=10.0, width=1241, height=376)
    cfg = SlamConfig(camera=cam_cfg, orb=OrbConfig(n_features=2000),
                     tracking=TrackingConfig(min_init_points=100))
    slam = System(cfg)
    cam = cam_cfg.stereo_camera()
    log("generating sequence...")
    frames = _make_sequence(cam, 12)
    log("running 12 frames (warmup + map growth)...")
    for i, (l, r) in enumerate(frames):
        t0 = time.perf_counter()
        slam.track_stereo(l, r, timestamp=i * 0.1)
        log(f"  frame {i}: {time.perf_counter()-t0:.2f}s")
    tr = slam.tracker

    # --- 1. build_frame alone (same jit instance the tracker uses) ---
    from lldslam_tpu.frontend.frame import build_frame
    imL = jnp.asarray(frames[-1][0].astype(np.uint8))
    imR = jnp.asarray(frames[-1][1].astype(np.uint8))
    fd = build_frame(imL, imR, cam, cfg.orb)
    jax.block_until_ready(fd)
    log(f"build_frame:      {timeit(build_frame, imL, imR, cam, cfg.orb):7.1f} ms")

    # --- 2. the fused track step ---
    T_pred = (tr.velocity @ tr.T_cw).astype(np.float32)
    out = tr._run_step(fd, T_pred)
    jax.block_until_ready(out)
    log(f"_track_step:      {timeit(lambda: tr._run_step(fd, T_pred)):7.1f} ms")

    # --- 3. both chained, one block at the end (what a frame really costs) ---
    def chain():
        f = build_frame(imL, imR, cam, cfg.orb)
        return tr._run_step(f, T_pred)[0]
    log(f"chain(build+step):{timeit(chain):7.1f} ms")

    # --- 3b. device_get of packed output only ---
    pk = tr._run_step(fd, T_pred)[0]
    jax.block_until_ready(pk)
    t0 = time.perf_counter()
    for _ in range(10):
        jax.device_get(pk)
    log(f"device_get(packed): {(time.perf_counter()-t0)*100:5.1f} ms  (size {pk.size*4/1024:.0f} KB)")

    # --- 3c. upload of a stereo pair ---
    a = frames[-1][0].astype(np.uint8)
    b = frames[-1][1].astype(np.uint8)
    t0 = time.perf_counter()
    for _ in range(10):
        x = jnp.asarray(a); y = jnp.asarray(b)
        jax.block_until_ready((x, y))
    log(f"upload(u8 pair):   {(time.perf_counter()-t0)*100:5.1f} ms  ({(a.size+b.size)/1024:.0f} KB)")

    # --- 4. snapshot round trip (used on KF path) ---
    t0 = time.perf_counter()
    for _ in range(5):
        tr._snapshot_np(fd)
    log(f"_snapshot_np:     {(time.perf_counter()-t0)*200:7.1f} ms")

    # --- 5. KF path pieces, run once for real on a fresh KF ---
    kt = tr.kf_timings
    if kt:
        log("kf timings so far: " + ", ".join(
            f"mapper={x['mapper']*1e3:.0f} loop={x['loop']*1e3:.0f} view={x['view']*1e3:.0f}"
            for x in kt[-5:]))
    # mapper sub-pieces
    import cProfile, pstats, io as _io
    # force one more KF and profile its host side
    l, r = frames[-1]
    tr.last_kf_frame = -999  # force too_old -> new KF on next frame
    pr = cProfile.Profile()
    pr.enable()
    t0 = time.perf_counter()
    slam.track_stereo(l, r, timestamp=99.0)
    dt = time.perf_counter() - t0
    pr.disable()
    log(f"forced-KF frame: {dt*1e3:.0f} ms  (mapper={tr.kf_timings[-1]['mapper']*1e3:.0f} loop={tr.kf_timings[-1]['loop']*1e3:.0f} view={tr.kf_timings[-1]['view']*1e3:.0f})")
    s = _io.StringIO()
    ps = pstats.Stats(pr, stream=s).sort_stats("cumulative")
    ps.print_stats(35)
    log(s.getvalue())


if __name__ == "__main__":
    main()
