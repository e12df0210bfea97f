"""Device times of the frame-build and matching pieces at the KITTI widths:
pyramid, `extract_stack_pyr` and `match_stereo` on a 1241x376 pair, the
masked best-2 at 4096 map points x 2048 keypoints, alone and inside
`search_by_projection`.

    python tools/time_kernels.py [--reps 50]

Each time is the median over `reps` calls that end in block_until_ready,
after a warm-up call. Prints one JSON object."""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def timed(fn, *args, reps):
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def projection_inputs(rng, P=4096, N=2048):
    """Map points in front of a KITTI camera and a frame whose keypoints
    are noisy projections of half of them (descriptors with a few flipped
    bits), so the window gates pass a realistic candidate set."""
    import jax.numpy as jnp
    from lldslam_tpu.frontend.matching import FrameFeatures, MapPointView
    import chip_smoke as cs

    cam = cs.kitti_points_cfg()[0].stereo_camera()
    z = rng.uniform(4, 60, P)
    u = rng.uniform(0, cam.width, P)
    v = rng.uniform(0, cam.height, P)
    pos = np.stack([(u - cam.cx) * z / cam.fx, (v - cam.cy) * z / cam.fy, z],
                   -1).astype(np.float32)
    d = np.linalg.norm(pos, axis=-1)
    pdesc = rng.integers(0, 2**32, (P, 8), dtype=np.uint64).astype(np.uint32)
    src = rng.permutation(P)[:N]
    flips = np.packbits(rng.uniform(size=(N, 256)) < 0.05, axis=1,
                        bitorder="little").view(np.uint32)
    pts = MapPointView(pos=jnp.asarray(pos), desc=jnp.asarray(pdesc),
                       normal=jnp.asarray(pos / d[:, None]),
                       min_dist=jnp.asarray(0.5 * d),
                       max_dist=jnp.asarray(2.0 * d),
                       valid=jnp.ones(P, bool))
    xy = np.stack([u[src], v[src]], -1) + rng.normal(0, 1.0, (N, 2))
    feats = FrameFeatures(
        xy=jnp.asarray(xy.astype(np.float32)),
        ur=jnp.asarray((xy[:, 0] - cam.bf / z[src]).astype(np.float32)),
        octave=jnp.asarray(rng.integers(0, 3, N).astype(np.int32)),
        angle=jnp.zeros(N, jnp.float32),
        desc=jnp.asarray(pdesc[src] ^ flips), valid=jnp.ones(N, bool))
    return cam, pts, feats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import lldslam_tpu  # noqa: F401
    import chip_smoke as cs
    from lldslam_tpu.frontend import matching
    from lldslam_tpu.ops import hamming, image, orb, stereo

    dev = jax.devices()[0]
    out = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}}
    if dev.platform == "gpu":
        out["nvidia_smi"] = cs.gpu_name_and_power()
    rng = np.random.default_rng(0)
    cam_cfg, frames = cs._kitti_pair()
    cam = cam_cfg.stereo_camera()
    cfg = orb.OrbConfig(n_features=2000)
    stack = jnp.asarray(np.stack(frames[0])).astype(jnp.float32)
    pyr_fn = jax.jit(lambda s: tuple(image.build_pyramid(
        s, cfg.n_levels, cfg.scale, quantize=True)))
    pyr = pyr_fn(stack)
    out["pyramid_ms"] = timed(pyr_fn, stack, reps=args.reps)
    out["extract_stack_pyr_ms"] = timed(
        lambda p: orb.extract_stack_pyr(p, cfg), pyr, reps=args.reps)
    kp = orb.extract_stack_pyr(pyr, cfg)
    sargs = (jax.tree.map(lambda a: a[0], kp), jax.tree.map(lambda a: a[1], kp),
             [p[0] for p in pyr], [p[1] for p in pyr])
    out["match_stereo_ms"] = timed(
        lambda *a: stereo.match_stereo(*a, cam, cfg), *sargs, reps=args.reps)

    # best-2 alone, on the projection matcher's own candidate mask density
    a = jnp.asarray(rng.integers(0, 2**32, (4096, 8), dtype=np.uint64)
                    .astype(np.uint32))
    b = jnp.asarray(rng.integers(0, 2**32, (2048, 8), dtype=np.uint64)
                    .astype(np.uint32))
    mask = jnp.asarray(rng.uniform(size=(4096, 2048)) < 0.01)
    best2 = jax.jit(lambda a, b, m: hamming.masked_argmin(
        hamming.distance_matrix(a, b), m))
    out["best2_ms"] = timed(best2, a, b, mask, reps=args.reps)
    camp, pts, feats = projection_inputs(rng)
    T = jnp.eye(4, dtype=jnp.float32)
    out["search_by_projection_ms"] = timed(
        lambda: matching.search_by_projection(camp, T, pts, feats),
        reps=args.reps)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
