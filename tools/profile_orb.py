"""Per-stage timing of ORB extraction + stereo on the real device."""
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def log(m):
    print(m, file=sys.stderr, flush=True)


def t(fn, n=5):
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3


def main():
    from lldslam_tpu.ops import fast, image, orb, stereo
    from lldslam_tpu.ops.orb import OrbConfig

    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 255, (376, 1241)).astype(np.float32))
    cfg = OrbConfig(n_features=2000)

    f_pyr = jax.jit(partial(image.build_pyramid, n_levels=8, scale=1.2))
    log(f"pyramid x8: {t(lambda: f_pyr(img)):.1f} ms")

    f_score = jax.jit(lambda x: fast.nms3x3(fast.fast_score_map(x, 7.0)))
    log(f"fast+nms L0: {t(lambda: f_score(img)):.1f} ms")

    score = f_score(img)
    f_sel = jax.jit(partial(orb._select_level_keypoints, n_out=433, cfg=cfg))
    log(f"select L0: {t(lambda: f_sel(score)):.1f} ms")

    xy, _ = f_sel(score)
    f_ang = jax.jit(orb._ic_angle)
    log(f"ic_angle L0: {t(lambda: f_ang(img, xy)):.1f} ms")

    f_blur = jax.jit(lambda x: jnp.round(image.gaussian_blur(x)))
    log(f"blur L0: {t(lambda: f_blur(img)):.1f} ms")

    blur = f_blur(img)
    ang = f_ang(img, xy)
    f_desc = jax.jit(orb._brief_desc)
    log(f"brief L0: {t(lambda: f_desc(blur, xy, ang)):.1f} ms")

    f_ex = jax.jit(partial(orb.extract, cfg=cfg))
    log(f"extract full x1: {t(lambda: f_ex(img)):.1f} ms")

    kpl = f_ex(img)
    kpr = f_ex(img)
    from lldslam_tpu.geometry.camera import StereoCamera
    cam = StereoCamera(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                       bf=386.1448, width=1241, height=376)
    pyr = f_pyr(img)




def main2():
    from lldslam_tpu.ops import image, orb, stereo
    from lldslam_tpu.ops.orb import OrbConfig
    from lldslam_tpu.geometry.camera import StereoCamera

    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 255, (376, 1241)).astype(np.float32))
    cfg = OrbConfig(n_features=2000)
    cam = StereoCamera(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                       bf=386.1448, width=1241, height=376)

    f_ex = jax.jit(partial(orb.extract, cfg=cfg))
    f_pyr = jax.jit(partial(image.build_pyramid, n_levels=8, scale=1.2))
    kpl = jax.block_until_ready(f_ex(img))
    kpr = jax.block_until_ready(f_ex(img + 1.0))
    pyr = jax.block_until_ready(f_pyr(img))

    f_st = jax.jit(partial(stereo.match_stereo, cam=cam, cfg=cfg))
    log(f"match_stereo: {t(lambda: f_st(kpl, kpr, pyr, pyr)):.1f} ms")

    from lldslam_tpu.frontend.frame import build_frame
    f_bf = jax.jit(partial(build_frame, cam=cam, cfg=cfg))
    log(f"build_frame: {t(lambda: f_bf(img, img + 1.0)):.1f} ms")

    # isolate: extract x2 only
    f_2ex = jax.jit(lambda a, b: (orb.extract(a, cfg), orb.extract(b, cfg)))
    log(f"extract x2 fused: {t(lambda: f_2ex(img, img + 1.0)):.1f} ms")


main2()

