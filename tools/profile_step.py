"""Profile the per-frame device programs on the GPU.

Times (steady state, block_until_ready):
  - build_frame (ORB pyramid + FAST + BRIEF + stereo depth)
  - _track_step (motion match -> pose LM -> local search -> pose LM)
and prints a per-piece ms breakdown to stderr.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax


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
    from lldslam_tpu.config import CameraConfig, SlamConfig, TrackingConfig
    from lldslam_tpu.ops.orb import OrbConfig
    from lldslam_tpu.system import System
    sys.path.insert(0, ".")
    from bench import _make_sequence

    cam_cfg = CameraConfig(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                           bf=386.1448, fps=10.0, width=1241, height=376)
    cfg = SlamConfig(camera=cam_cfg, orb=OrbConfig(n_features=2000),
                     tracking=TrackingConfig(min_init_points=100))
    slam = System(cfg)
    frames = _make_sequence(cam_cfg.stereo_camera(), 8)
    for i, (l, r) in enumerate(frames):
        slam.track_stereo(l, r, timestamp=i * 0.1)

    tr = slam.tracker
    fd = tr._last_fd if hasattr(tr, "_last_fd") else None

    # 1. frame build
    from lldslam_tpu.frontend.frame import build_frame
    import jax.numpy as jnp
    cam = cam_cfg.stereo_camera()
    imL = jnp.asarray(frames[-1][0])
    imR = jnp.asarray(frames[-1][1])
    from functools import partial
    bf = jax.jit(partial(build_frame, cam=cam, cfg=cfg.orb))
    log(f"build_frame: {timeit(bf, imL, imR):.1f} ms")

    # 2. the fused track step, via the tracker's own call path
    import lldslam_tpu.pipeline.tracker as T
    # re-run one process() with stage timers around _run_step
    l, r = frames[-1]
    t0 = time.perf_counter()
    fdn = tr._build(jnp.asarray(l), jnp.asarray(r)) if hasattr(tr, "_build") else None
    log("timing full process() stages over 5 frames:")
    for i in range(5):
        t0 = time.perf_counter()
        slam.track_stereo(l, r, timestamp=100 + i * 0.1)
        log(f"  frame: {(time.perf_counter() - t0) * 1e3:.0f} ms")
    m = tr.metrics[-1]
    log(f"  metrics: build={m.t_build*1e3:.0f} step(get)={m.t_get*1e3:.0f}")


if __name__ == "__main__":
    main()
