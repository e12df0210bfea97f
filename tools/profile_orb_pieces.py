"""Per-piece timing of the frame-build program on the GPU.

Every iteration feeds DIFFERENT data (rolled image) and forces completion
with device_get, so no iteration can reuse an earlier result.
"""
import os
import sys
import time
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


def log(m):
    print(m, file=sys.stderr, flush=True)


def make_timer(n_variants=8):
    def timeit(fn, variants, n=8):
        # variants: list of arg tuples, all same shapes
        out = fn(*variants[0])
        jax.device_get(jax.tree.leaves(out)[0])
        t0 = time.perf_counter()
        for i in range(n):
            out = fn(*variants[(i + 1) % len(variants)])
            jax.device_get(jax.tree.leaves(out)[0])
        return (time.perf_counter() - t0) / n * 1e3
    return timeit


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from lldslam_tpu.ops import fast, image, orb, stereo
    from lldslam_tpu.config import CameraConfig
    cfg = orb.OrbConfig(n_features=2000)
    cam = CameraConfig(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                       bf=386.1448, fps=10.0, width=1241, height=376).stereo_camera()
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (2, 376, 1241)).astype(np.float32)
    base = jnp.asarray(img)
    stacks = [jnp.roll(base, i * 7, axis=2) for i in range(4)]
    jax.block_until_ready(stacks)
    timeit = make_timer()

    pyr_fn = jax.jit(partial(image.build_pyramid, n_levels=cfg.n_levels, scale=cfg.scale))
    log(f"build_pyramid (pair):   {timeit(pyr_fn, [(s,) for s in stacks]):7.1f} ms")
    pyrs = [tuple(pyr_fn(s)) for s in stacks]
    jax.block_until_ready(pyrs)

    f_score = jax.jit(lambda im: jax.vmap(lambda a: fast.nms3x3(fast.fast_score_map(a, cfg.min_th)))(im))
    log(f"FAST score+nms L0 pair: {timeit(f_score, [(p[0],) for p in pyrs]):7.1f} ms")
    # all levels
    f_all = jax.jit(lambda p: [jax.vmap(lambda a: fast.nms3x3(fast.fast_score_map(a, cfg.min_th)))(l) for l in p])
    log(f"FAST score+nms all-L:   {timeit(f_all, [(p,) for p in pyrs]):7.1f} ms")

    scores = [f_score(p[0]) for p in pyrs]
    jax.block_until_ready(scores)
    sel = jax.jit(lambda s: jax.vmap(lambda a: orb._select_level_keypoints(a, 431, cfg))(s))
    log(f"select L0 pair:         {timeit(sel, [(s,) for s in scores]):7.1f} ms")

    xys = [sel(s)[0].astype(jnp.int32) for s in scores]
    jax.block_until_ready(xys)
    ica = jax.jit(lambda im, xy: jax.vmap(orb._ic_angle)(im, xy))
    log(f"ic_angle L0 pair:       {timeit(ica, list(zip([p[0] for p in pyrs], xys))):7.1f} ms")

    blur_fn = jax.jit(lambda im: jax.vmap(lambda a: jnp.round(image.gaussian_blur(a)))(im))
    log(f"blur L0 pair:           {timeit(blur_fn, [(p[0],) for p in pyrs]):7.1f} ms")

    angs = [ica(p[0], xy) for p, xy in zip(pyrs, xys)]
    blurs = [blur_fn(p[0]) for p in pyrs]
    jax.block_until_ready((angs, blurs))
    brief = jax.jit(lambda b, xy, an: jax.vmap(orb._brief_desc)(b, xy, an))
    log(f"brief L0 pair:          {timeit(brief, list(zip(blurs, xys, angs))):7.1f} ms")

    ext = jax.jit(lambda p: jax.vmap(partial(orb.extract_pyr, cfg=cfg))(p))
    log(f"extract_pyr (pair):     {timeit(ext, [(p,) for p in pyrs]):7.1f} ms")

    kps = [ext(p) for p in pyrs]
    jax.block_until_ready(kps)
    def sm(kp, pl):
        kl = jax.tree.map(lambda a: a[0], kp)
        kr = jax.tree.map(lambda a: a[1], kp)
        return stereo.match_stereo(kl, kr, [x[0] for x in pl], [x[1] for x in pl], cam, cfg)
    smj = jax.jit(sm)
    log(f"match_stereo:           {timeit(smj, list(zip(kps, pyrs))):7.1f} ms")


if __name__ == "__main__":
    main()
