"""Distributed bundle adjustment scaling measurement (BASELINE.json target:
BA iters/sec at 1 chip / N devices, >= 0.7 scaling efficiency).

Builds a KITTI-00-scale synthetic global-BA problem (hundreds of keyframes,
tens of thousands of landmarks, ~half a million observations), runs the
matrix-free CG solver on a 1-device mesh and an observation-sharded N-device
mesh, and reports iterations/second + scaling efficiency as ONE JSON line.

On a host with virtual CPU devices the efficiency number is a compilation/
correctness check, not a hardware measurement — the flag `simulated` says
which. On a real multi-chip slice the same script measures true ICI scaling.

    python tools/bench_distributed_ba.py [--devices N] [--iters 10]
"""
import argparse
import json
import time

import numpy as np


def build_problem(K=256, P=40_000, O=1 << 19, seed=0, noise_px=0.0):
    """Global-BA problem with exact (noise_px=0) or noisy observations;
    landmarks start 5 cm off the truth."""
    import jax.numpy as jnp
    from lldslam_tpu.optim import ba

    rng = np.random.default_rng(seed)
    # keyframe k sits at world z = k (1 m spacing along the optical axis);
    # landmarks spread along the path, each observed from keyframes 2-40 m
    # behind it, so every observation has positive depth
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[:, 2, 3] = -np.arange(K) * 1.0
    t = np.arange(P) / P * K
    pts = np.stack([
        rng.uniform(-20, 20, P), rng.uniform(-5, 10, P),
        t + rng.uniform(5, 60, P),
    ], -1).astype(np.float32)
    p = rng.integers(0, P, O).astype(np.int32)
    k = np.clip(np.floor(pts[p, 2] - rng.uniform(2, 40, O)), 0, K - 1) \
        .astype(np.int32)
    cam = _camera()
    Xc = np.einsum("oij,oj->oi", poses[k, :3, :3], pts[p]) + poses[k, :3, 3]
    ok = Xc[:, 2] > 1.0
    z = np.maximum(Xc[:, 2], 1.0)
    u = cam.fx * Xc[:, 0] / z + cam.cx
    v = cam.fy * Xc[:, 1] / z + cam.cy
    ur = u - cam.bf / z
    uvr = np.stack([u, v, ur], -1)
    if noise_px:
        uvr = uvr + rng.normal(0, noise_px, uvr.shape)
    uvr = uvr.astype(np.float32)
    problem = ba.BAProblem(
        poses=jnp.asarray(poses),
        points=jnp.asarray(pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)),
        pose_fixed=jnp.asarray(np.arange(K) == 0),
        point_valid=jnp.ones(P, bool),
        obs=ba.BAObs(
            k=jnp.asarray(k), p=jnp.asarray(p), uvr=jnp.asarray(uvr),
            inv_sigma2=jnp.ones(O), is_stereo=jnp.ones(O, bool),
            valid=jnp.asarray(ok),
        ),
    )
    return problem


def build_joint_problem(K=256, P=40_000, O=1 << 19, L=2048, OL=16_384,
                        seed=0, noise_px=0.0):
    """Joint point+line global-BA problem at the KITTI-LBD scale: the point
    half of build_problem plus L 4-DoF lines with OL stereo endpoint
    observations (reference global BA marginalizes both landmark classes
    in one solve, Optimizer.cc:473 via AddLineMinimalGlobal :149)."""
    import jax.numpy as jnp
    from lldslam_tpu.geometry import lines as gl
    from lldslam_tpu.optim import lines_ba

    base = build_problem(K=K, P=P, O=O, seed=seed, noise_px=noise_px)
    rng = np.random.default_rng(seed + 1)
    cam = _camera()
    t = np.arange(L) / L * K
    mid = np.stack([rng.uniform(-15, 15, L), rng.uniform(-4, 8, L),
                    t + rng.uniform(8, 40, L)], -1).astype(np.float32)
    dd = rng.normal(size=(L, 3)).astype(np.float32)
    dd /= np.linalg.norm(dd, axis=-1, keepdims=True)
    A, B = mid - 1.5 * dd, mid + 1.5 * dd
    q, alpha = gl.minimal_from_x0dir(
        *gl.closest_point_form(jnp.asarray(mid), jnp.asarray(dd)))
    li = rng.integers(0, L, OL).astype(np.int32)
    lk = np.clip(np.floor(mid[li, 2] - rng.uniform(4, 30, OL)), 0, K - 1) \
        .astype(np.int32)
    poses = np.asarray(base.poses)

    def proj2(T, X):
        Xc = np.einsum("oij,oj->oi", T[:, :3, :3], X) + T[:, :3, 3]
        z = np.maximum(Xc[:, 2], 0.5)
        u = cam.fx * Xc[:, 0] / z + cam.cx
        v = cam.fy * Xc[:, 1] / z + cam.cy
        return np.stack([u, v], -1).astype(np.float32), Xc[:, 2] > 0.5

    Tr = poses[lk].copy()
    Tr[:, 0, 3] -= cam.baseline
    x1l, ok1 = proj2(poses[lk], A[li])
    x2l, ok2 = proj2(poses[lk], B[li])
    x1r, ok3 = proj2(Tr, A[li])
    x2r, ok4 = proj2(Tr, B[li])
    if noise_px:
        x1l, x2l, x1r, x2r = (
            (x + rng.normal(0, noise_px, x.shape)).astype(np.float32)
            for x in (x1l, x2l, x1r, x2r))
    lobs = lines_ba.LineBAObs(
        k=jnp.asarray(lk), l=jnp.asarray(li),
        x1l=jnp.asarray(x1l), x2l=jnp.asarray(x2l),
        x1r=jnp.asarray(x1r), x2r=jnp.asarray(x2r),
        octave=jnp.zeros(OL, jnp.int32),
        has_r=jnp.ones(OL, bool),
        valid=jnp.asarray(ok1 & ok2 & ok3 & ok4))
    return lines_ba.JointProblem(base=base, q=q, alpha=alpha,
                                 line_valid=jnp.ones(L, bool), lobs=lobs)


def _camera():
    from lldslam_tpu.geometry.camera import StereoCamera
    return StereoCamera(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                        bf=386.1448, width=1241, height=376)


def time_solve(problem, mesh, iters, cam):
    """Landmark-sharded shard_map solve (parallel/dist_schur.py): landmarks,
    observations and the landmark marginalization are partitioned over the
    mesh; only the reduced camera system crosses shards (one psum per CG
    matvec). The 1-device mesh is the degenerate baseline."""
    import jax
    from lldslam_tpu.parallel import dist_schur

    n = len(mesh.devices.flat)
    dp, _ = dist_schur.make_dist_problem(problem, n)
    dp = dist_schur.place(dp, mesh)
    out = dist_schur.dist_ba_solve(cam, dp, mesh, iters=2, cg_iters=24)
    jax.block_until_ready(out)  # compile + warm
    t0 = time.perf_counter()
    out = dist_schur.dist_ba_solve(cam, dp, mesh, iters=iters, cg_iters=24)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def time_solve_joint(joint, mesh, iters, cam):
    """Joint point+line sharded solve (dist_schur.dist_joint_ba_solve)."""
    import jax
    from lldslam_tpu.parallel import dist_schur

    n = len(mesh.devices.flat)
    djp, _, _ = dist_schur.make_dist_joint_problem(joint, n)
    djp = dist_schur.place_joint(djp, mesh)
    out = dist_schur.dist_joint_ba_solve(cam, djp, mesh, iters=2,
                                         cg_iters=24)
    jax.block_until_ready(out)  # compile + warm
    t0 = time.perf_counter()
    out = dist_schur.dist_joint_ba_solve(cam, djp, mesh, iters=iters,
                                         cg_iters=24)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--kfs", type=int, default=256)
    ap.add_argument("--joint", action="store_true",
                    help="point+LINE joint problem (both classes sharded)")
    args = ap.parse_args()

    import jax
    from lldslam_tpu.parallel import dist_schur

    devs = jax.devices()
    n = args.devices or len(devs)
    cam = _camera()
    if args.joint:
        problem = build_joint_problem(K=args.kfs)
        solver = time_solve_joint
    else:
        problem = build_problem(K=args.kfs)
        solver = time_solve

    t1 = solver(problem, dist_schur.make_mesh(1), args.iters, cam)
    tn = t1
    if n > 1:
        tn = solver(problem, dist_schur.make_mesh(n), args.iters, cam)
    eff = t1 / (tn * n) if n > 1 else 1.0
    simulated = devs[0].platform == "cpu"
    out = {
        "metric": ("joint_global_ba_iters_per_sec" if args.joint
                   else "global_ba_iters_per_sec"),
        "value": round(1.0 / tn, 3),
        "unit": "iters/s",
        "devices": n,
        "single_device_iters_per_sec": round(1.0 / t1, 3),
        "scaling_efficiency": round(eff, 3),
        "simulated": simulated,
    }
    if simulated and n > 1:
        # N virtual devices time-share ONE physical CPU, so the per-device
        # efficiency ceiling is 1/N (total FLOPs unchanged). The fraction of
        # that ceiling isolates the collective/partition overhead — the
        # quantity that transfers to real multi-chip hardware.
        out["timeshared_ceiling"] = round(1.0 / n, 3)
        out["of_timeshared_ceiling"] = round(eff * n, 3)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
