"""Decisive timing: force execution with a device_get of a derived scalar."""
import os
import sys
import time
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


def log(m):
    print(m, file=sys.stderr, flush=True)


def timeit_get(fn, *a, n=10):
    out = fn(*a)
    s = jax.tree.leaves(out)[0]
    jax.device_get(s)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*a)
        leaves = jax.tree.leaves(out)
        jax.device_get(leaves[0])  # forces the whole program (single output dep chain)
    return (time.perf_counter() - t0) / n * 1e3


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from lldslam_tpu.ops import image, orb, stereo
    from lldslam_tpu.frontend.frame import build_frame
    from lldslam_tpu.config import CameraConfig
    cfg = orb.OrbConfig(n_features=2000)
    cam = CameraConfig(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                       bf=386.1448, fps=10.0, width=1241, height=376).stereo_camera()
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (2, 376, 1241)).astype(np.float32)
    stack = jnp.asarray(img)
    imL, imR = stack[0].astype(jnp.uint8), stack[1].astype(jnp.uint8)
    jax.block_until_ready((imL, imR))

    # whole build_frame, forced via scalar get of desc sum
    fd = build_frame(imL, imR, cam, cfg)
    jax.block_until_ready(fd)
    log(f"build_frame (get-forced):  {timeit_get(lambda: build_frame(imL, imR, cam, cfg).feats.desc):7.1f} ms")

    # pieces chained in ONE jit, same forcing
    @jax.jit
    def pieces():
        pyr = image.build_pyramid(stack, cfg.n_levels, cfg.scale)
        kp = jax.vmap(partial(orb.extract_pyr, cfg=cfg))(tuple(pyr))
        return kp.desc
    log(f"pyr+extract one-jit:       {timeit_get(pieces):7.1f} ms")

    # extract_pyr alone with get-forcing
    pyr_fn = jax.jit(partial(image.build_pyramid, n_levels=cfg.n_levels, scale=cfg.scale))
    pyr = pyr_fn(stack)
    jax.block_until_ready(pyr)
    ext = jax.jit(lambda p: jax.vmap(partial(orb.extract_pyr, cfg=cfg))(tuple(p)).desc)
    log(f"extract_pyr (get-forced):  {timeit_get(ext, pyr):7.1f} ms")

    # does block_until_ready actually block? time it after a fresh dispatch
    out = build_frame(imL, imR, cam, cfg)
    t0 = time.perf_counter()
    jax.block_until_ready(out)
    log(f"block_until_ready after dispatch: {(time.perf_counter()-t0)*1e3:.1f} ms")
    t0 = time.perf_counter()
    out2 = build_frame(imL, imR, cam, cfg)
    t1 = time.perf_counter()
    jax.block_until_ready(out2)
    t2 = time.perf_counter()
    jax.device_get(out2.feats.desc)
    t3 = time.perf_counter()
    log(f"dispatch {1e3*(t1-t0):.1f} ms | block {1e3*(t2-t1):.1f} ms | get {1e3*(t3-t2):.1f} ms")


if __name__ == "__main__":
    main()
