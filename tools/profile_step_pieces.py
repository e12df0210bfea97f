"""Device-only (fori_loop-chained) breakdown of build_frame + _track_step."""
import os
import sys
import time
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(m):
    print(m, file=sys.stderr, flush=True)


def loop_time(body, x0, n=16, label=""):
    def run(k):
        @jax.jit
        def f(x):
            return jax.lax.fori_loop(0, k, lambda i, x: body(x, i), x)
        ts = []
        for j in range(3):
            xj = jax.tree.map(lambda a: a + jnp.asarray(j, a.dtype), x0)
            jax.block_until_ready(xj)
            t0 = time.perf_counter()
            jax.device_get(jax.tree.leaves(jax.tree.map(jnp.sum, f(xj)))[0])
            ts.append(time.perf_counter() - t0)
        return min(ts[1:])
    t1 = run(1)
    tn = run(1 + n)
    log(f"{label:32s} {(tn - t1) / n * 1e3:7.2f} ms/iter")


def main():
    from lldslam_tpu.ops import fast, image, orb, stereo
    from lldslam_tpu.frontend.frame import build_frame
    from lldslam_tpu.frontend import matching
    from lldslam_tpu.optim import pose_opt
    from lldslam_tpu.config import CameraConfig
    cfg = orb.OrbConfig(n_features=2000)
    cam = CameraConfig(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                       bf=386.1448, fps=10.0, width=1241, height=376).stereo_camera()
    rng = np.random.default_rng(0)
    img = np.round(rng.uniform(0, 255, (2, 376, 1241))).astype(np.float32)
    stack = jnp.asarray(img)
    pyr = tuple(jax.jit(partial(image.build_pyramid, n_levels=cfg.n_levels,
                                scale=cfg.scale))(stack))
    pyr = jax.block_until_ready(pyr)

    # FAST all levels
    def fast_all(x, i):
        s = [jax.vmap(lambda a: fast.nms3x3(fast.fast_score_map(a, cfg.min_th)))(l)
             for l in (x,) + pyr[1:]]
        return x + s[0] * 1e-20 + 1e-21 * jnp.sum(s[-1])
    loop_time(fast_all, pyr[0], label="FAST+nms all levels (pair)")

    # select all levels
    scores = [jax.jit(lambda l: jax.vmap(lambda a: fast.nms3x3(fast.fast_score_map(a, cfg.min_th)))(l))(l)
              for l in pyr]
    scores = jax.block_until_ready(scores)
    budgets = cfg.per_level_budget()

    def sel_all(x, i):
        acc = x
        out = 0.0
        for s, b in zip((x,) + tuple(scores[1:]), budgets):
            xy, r = jax.vmap(lambda a: orb._select_level_keypoints(a, b, cfg))(s)
            out = out + jnp.sum(r) + 1e-6 * jnp.sum(xy)
        return acc + out * 1e-20
    loop_time(sel_all, scores[0], label="select all levels (pair)")

    # ic_angle all levels
    xys = [jax.jit(lambda s, b=b: jax.vmap(lambda a: orb._select_level_keypoints(a, b, cfg))(s)[0].astype(jnp.int32))(s)
           for s, b in zip(scores, budgets)]
    xys = jax.block_until_ready(xys)

    def ic_all(x, i):
        out = 0.0
        for l, xy in zip((x,) + pyr[1:], xys):
            out = out + jnp.sum(jax.vmap(orb._ic_angle)(l, xy))
        return x + out * 1e-20
    loop_time(ic_all, pyr[0], label="ic_angle all levels (pair)")

    # blur all levels
    def blur_all(x, i):
        out = 0.0
        for l in (x,) + pyr[1:]:
            out = out + jnp.sum(jnp.round(jax.vmap(image.gaussian_blur)(l)))
        return x + out * 1e-20
    loop_time(blur_all, pyr[0], label="blur all levels (pair)")

    # whole extract
    def ext(x, i):
        kp = orb.extract_stack_pyr.__wrapped__((x,) + pyr[1:], cfg)
        return x + 1e-20 * (jnp.sum(kp.desc.astype(jnp.float32))
                            + jnp.sum(kp.xy) + jnp.sum(kp.angle))
    loop_time(ext, pyr[0], label="extract_stack_pyr")

    # stereo match
    kp = jax.jit(lambda p: orb.extract_stack_pyr(p, cfg))(pyr)
    kp = jax.block_until_ready(kp)
    kl = jax.tree.map(lambda a: a[0], kp)
    kr = jax.tree.map(lambda a: a[1], kp)

    def sm(x, i):
        ur, d = stereo.match_stereo(
            kl._replace(xy=kl.xy + 1e-20 * jnp.sum(x)), kr,
            [x[0]] + [p[0] for p in pyr[1:]],
            [x[1]] + [p[1] for p in pyr[1:]], cam, cfg)
        return x + 1e-20 * (jnp.sum(ur) + jnp.sum(d))
    loop_time(sm, pyr[0], label="match_stereo")

    # ---- track step pieces ----
    N = kl.xy.shape[0]
    P = 8192
    view = matching.MapPointView(
        pos=jnp.asarray(rng.uniform(-30, 30, (P, 3)).astype(np.float32)),
        desc=jnp.asarray(rng.integers(0, 2**32, (P, 8), dtype=np.uint32)),
        normal=jnp.asarray(np.tile([0, 0, 1], (P, 1)).astype(np.float32)),
        min_dist=jnp.zeros(P), max_dist=jnp.full(P, 100.0),
        valid=jnp.ones(P, bool))
    lut = jnp.asarray(np.power(1 / 1.2**2, np.arange(8)).astype(np.float32))
    T0 = jnp.eye(4)
    feats = matching.FrameFeatures(kl.xy, kr.xy[:, 0], kl.octave, kl.angle,
                                   kl.desc, kl.valid)

    def mm(x, i):
        T = T0 + 1e-20 * jnp.sum(x)
        k2l = matching.match_last_frame(cam, T, feats,
                                        view.pos[:N], view.valid[:N],
                                        feats, n_levels=8, scale=1.2, radius=7.0)
        return x + 1e-20 * jnp.sum(k2l)
    loop_time(mm, pyr[0], label="match_last_frame (1x)")

    def sbp(x, i):
        T = T0 + 1e-20 * jnp.sum(x)
        _, k2p, _, inf = matching.search_by_projection(
            cam, T, view, feats, n_levels=8, scale=1.2, th=1.0)
        return x + 1e-20 * (jnp.sum(k2p) + jnp.sum(inf))
    loop_time(sbp, pyr[0], label="search_by_projection (8192)")

    obs = jnp.concatenate([kl.xy, kr.xy[:, :1]], axis=-1)
    pobs = pose_opt.PointPoseObs(
        X=view.pos[:N], obs=obs, inv_sigma2=lut[kl.octave],
        is_stereo=kl.valid, valid=kl.valid)

    def po(x, i):
        T = T0 + 1e-20 * jnp.sum(x)
        T2, _, _, n = pose_opt.optimize_pose(cam, T, pobs)
        return x + 1e-20 * (jnp.sum(T2) + n)
    loop_time(po, pyr[0], label="optimize_pose (4x10)")


if __name__ == "__main__":
    main()
