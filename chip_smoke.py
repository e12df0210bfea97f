#!/usr/bin/env python3
"""Smoke test of the stereo point+line SLAM main path on one NVIDIA GPU.

    python chip_smoke.py              # every phase below, one GPU
    python chip_smoke.py --four-gpus  # distributed global BA over 4 GPUs

Phases, in order, each printing one line with what it checked:

0. device: the JAX devices, versions, XLA_FLAGS, compile-cache directory
   and the card's name and power limit; fails unless the platform is gpu.
1. kernels: each hot-path piece at its real width against a plain
   reference — Hamming best-2 at 4096x2048 and full-width BRIEF against
   numpy, stereo matching and local / joint line BA against the same jitted
   function on the CPU device of this process.
2. points: `System(cfg, pipeline=True)` at the KITTI workload (1241x376,
   2000 ORB features, 8 levels), warmed up, tracking 6 + 40 synthetic
   frames; ATE against the generating poses.
3. lines: the stored-LBD configuration (256 lines/frame capacity), 40
   frames, then a full-map global BA.
4. multi-seq: PipelinedMultiSequenceDriver, 4 sequences x 10 frames.
5. cli: `lldslam_tpu.cli.main` on tests/data/mini_kitti.

Everything runs in this one process (a JAX process reserves most of the
card's memory). A failing phase is reported and the script exits 1 without
the result line; the last line of a passing run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# KITTI 00-02 / 04-12 intrinsics (KITTI04-12_LBD.yaml:38-51), as bench.py
KITTI_CAM = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                 bf=386.1448, fps=10.0, width=1241, height=376)
# ATE RMSE of phase 2's frames tracked on the CPU device, measured once with
# tools/ate_reference.py (same seed, same frames; XLA:CPU on the 16-core host
# of an H100 machine); the GPU run may be at most 1.5x worse.
CPU_POINTS_ATE_M = 0.04741830767743794

N_FEATURES = 2000
BEST2_SHAPE = (4096, 2048)   # map points x keypoints in the tracking step
MIN_LINE_MATCHES = 50         # median per frame in the lines phase
BA_CHI2_RTOL = 1e-3
BA_POSE_TOL = 1e-4        # metres and radians
# LM iterations of the local-BA comparisons: enough to converge from either
# device's path (at 10, one GPU run took a different accept/reject path and
# ended 2.5 mm away from the CPU result; converged, they agree to ~1e-5 m)
BA_ITERS = 20
# --four-gpus translation tolerance. The KITTI-00-scale problem chains 256
# keyframes from the one fixed keyframe; in f32 the far end's position is
# only defined to ~1 mm (the same distributed solve on a 1-device and a
# 4-device mesh differs by 0.7-1.2 mm there, XLA:CPU), so 1e-4 m is below
# the floor of any change of summation order.
DIST_POSE_TOL_M = 5e-3


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(Exception):
    """A check of the smoke test did not hold."""


def expect(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# phase 0
# ---------------------------------------------------------------------------

def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def phase_device(n_needed: int):
    import jax

    devs = jax.devices()
    log(f"devices: {devs}")
    log(f"device_kind: {devs[0].device_kind}  jax {jax.__version__}  "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}  compile cache "
        f"{jax.config.jax_compilation_cache_dir!r}")
    if devs[0].platform != "gpu":
        raise SystemExit(f"phase 0 device: FAIL platform "
                         f"{devs[0].platform!r} is not gpu")
    log(f"nvidia-smi: {gpu_name_and_power()}")
    if len(devs) < n_needed:
        raise SystemExit(f"phase 0 device: FAIL {len(devs)} GPUs visible, "
                         f"{n_needed} needed")
    log(f"phase 0 device: PASS {len(devs)} x {devs[0].device_kind}")
    return devs


# ---------------------------------------------------------------------------
# phase 1: kernels against plain references
# ---------------------------------------------------------------------------

def _popcount_best2(a, b, mask):
    """numpy XOR+popcount brute force: (best, second, best_idx, dist)."""
    d = np.empty((a.shape[0], b.shape[0]), np.int32)
    for r0 in range(0, a.shape[0], 512):
        x = a[r0:r0 + 512, None, :] ^ b[None, :, :]
        d[r0:r0 + 512] = np.bitwise_count(x).sum(-1)
    d = np.where(mask, d, 10_000)
    bi = d.argmin(1)
    best = d[np.arange(len(d)), bi]
    d2 = d.copy()
    d2[np.arange(len(d)), bi] = 10_000
    return best, d2.min(1), bi, d


def check_best2(rng) -> str:
    """hamming.masked_argmin over distance_matrix at the tracking shape (P map points x N
    keypoints) against numpy: both distances exact, indices equal except
    between equal-distance candidates."""
    import jax.numpy as jnp
    from lldslam_tpu.ops import hamming

    M, N = BEST2_SHAPE
    b = rng.integers(0, 2**32, (N, 8), dtype=np.uint64).astype(np.uint32)
    # map points near some keypoints (few flipped bits), so the gates see
    # realistic small distances and ties
    src = rng.integers(0, N, M)
    flips = rng.uniform(size=(M, 256)) < rng.uniform(0.02, 0.3, (M, 1))
    fl = np.packbits(flips, axis=1, bitorder="little").view(np.uint32)
    a = b[src] ^ fl
    out = []
    for name, dens in (("dense", 1.0), ("sparse", 0.02)):
        mask = rng.uniform(size=(M, N)) < dens
        mask[:8] = False
        got = [np.asarray(x) for x in hamming.masked_argmin(
            hamming.distance_matrix(jnp.asarray(a), jnp.asarray(b)),
            jnp.asarray(mask))]
        bi, bd, sd = got[0], got[1], got[2]
        r_bd, r_sd, r_bi, d = _popcount_best2(a, b, mask)
        expect((bd == r_bd).all(), f"{name}: best distance differs")
        expect((sd == r_sd).all(), f"{name}: second distance differs")
        rows = np.arange(M)
        tie_ok = (bi == r_bi) | (d[rows, bi] == r_bd)
        expect(tie_ok.all(), f"{name}: best index differs off ties")
        out.append(f"{name} {int((bi != r_bi).sum())} tie-swaps")
    return f"best2 {M}x{N} exact (" + ", ".join(out) + ")"


def _kitti_pair(n_frames: int = 1, seed: int = 0):
    from bench import _make_sequence
    from lldslam_tpu.config import CameraConfig
    cam_cfg = CameraConfig(**KITTI_CAM)
    return cam_cfg, _make_sequence(cam_cfg.stereo_camera(), n_frames,
                                   seed=seed)


def check_brief(pair, cfg) -> str:
    """BRIEF words of extract_stack_pyr on a full-width pair against a numpy
    gather of the same blurred levels at the same keypoints, angles and
    rotated taps fetched from the GPU: bit-exact, border slots included."""
    import jax
    import jax.numpy as jnp
    from lldslam_tpu.ops import image, orb

    stack = jnp.asarray(np.stack(pair)).astype(jnp.float32)
    pyr = tuple(image.build_pyramid(stack, cfg.n_levels, cfg.scale,
                                    quantize=True))
    kp = orb.extract_stack_pyr(pyr, cfg)
    blur_fn = jax.jit(lambda p: jnp.round(jax.vmap(image.gaussian_blur)(p))
                      .astype(p.dtype))
    taps_fn = jax.jit(orb._rotated_taps, static_argnums=(2, 3))
    xy0, octv, ang, desc = (np.asarray(x) for x in
                            (kp.xy, kp.octave, kp.angle, kp.desc))
    scales = np.asarray(cfg.scale_factors(), np.float32)
    n_real = sum(cfg.per_level_budget())
    n_bad = n_border = 0
    for l, lvl in enumerate(pyr):
        blur = np.asarray(blur_fn(lvl)).astype(np.float32)   # (2, h, w)
        h, w = blur.shape[1:]
        for v in range(2):
            sel = np.nonzero(octv[v, :n_real] == l)[0]
            xy = np.rint(xy0[v, sel] / scales[l]).astype(np.int32)
            gy, gx = (np.asarray(t) for t in taps_fn(
                jnp.asarray(xy), jnp.asarray(ang[v, sel]), h, w))
            vals = blur[v][gy, gx]                     # (n, 256, 2)
            bits = (vals[..., 0] < vals[..., 1]).astype(np.uint64)
            words = (bits.reshape(-1, 8, 32)
                     << np.arange(32, dtype=np.uint64)).sum(-1)
            n_bad += int((words.astype(np.uint32) != desc[v, sel]).any(-1)
                         .sum())
            n_border += int(((gy == 0) | (gy == h - 1) | (gx == 0)
                             | (gx == w - 1)).any((1, 2)).sum())
    expect(n_bad == 0, f"{n_bad} BRIEF descriptors differ")
    return (f"brief {2 * n_real} descriptors bit-exact "
            f"({n_border} with clipped taps)")


def check_stereo(pair, cam, cfg, cpu) -> str:
    """match_stereo on the GPU against the same jitted function on the CPU
    device: ok masks agree on >= 99.9% of keypoints, u_right within 1e-3 px
    where both are ok."""
    import jax
    import jax.numpy as jnp
    from lldslam_tpu.ops import image, orb, stereo

    stack = jnp.asarray(np.stack(pair)).astype(jnp.float32)
    pyr = tuple(image.build_pyramid(stack, cfg.n_levels, cfg.scale,
                                    quantize=True))
    kp = orb.extract_stack_pyr(pyr, cfg)
    args = (jax.tree.map(lambda a: a[0], kp), jax.tree.map(lambda a: a[1], kp),
            [p[0] for p in pyr], [p[1] for p in pyr])
    ur_g, _ = stereo.match_stereo(*args, cam, cfg)
    ur_c, _ = stereo.match_stereo(*jax.device_put(args, cpu), cam, cfg)
    ur_g, ur_c = np.asarray(ur_g), np.asarray(ur_c)
    ok_g, ok_c = ur_g >= 0, ur_c >= 0
    agree = float((ok_g == ok_c).mean())
    both = ok_g & ok_c
    du = float(np.abs(ur_g[both] - ur_c[both]).max(initial=0.0))
    expect(agree >= 0.999, f"stereo ok-mask agreement {agree:.5f}")
    expect(du <= 1e-3, f"stereo u_right differs by {du:.2e} px")
    return (f"stereo {int(ok_g.sum())} matches, mask agreement {agree:.5f}, "
            f"max |du| {du:.2e} px")


def ba_problem(rng, K: int, P: int, m: int, L: int = 0, ml: int = 0):
    """Synthetic local-BA problem: K keyframes 1 m apart, P points each seen
    by m distinct keyframes, L lines each seen by ml, landmarks 1-35 m
    ahead; 1 px measurement noise, perturbed poses / landmarks. Returns
    (cam, BAProblem or JointProblem)."""
    import jax.numpy as jnp
    from lldslam_tpu.geometry import lines as gl
    from lldslam_tpu.geometry import se3
    from lldslam_tpu.geometry.camera import StereoCamera
    from lldslam_tpu.optim import ba, lines_ba

    cam = StereoCamera(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                       bf=386.1448, width=1241, height=376)
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[:, 2, 3] = -np.arange(K, dtype=np.float32)
    pts = np.stack([rng.uniform(-15, 15, P), rng.uniform(-4, 2, P),
                    rng.uniform(K + 1.0, K + 20.0, P)], -1).astype(np.float32)

    def pairs(n, per):
        kk = np.argsort(rng.uniform(size=(n, K)), axis=1)[:, :per]
        return kk.reshape(-1).astype(np.int32), \
            np.repeat(np.arange(n, dtype=np.int32), per)

    def proj(T, X, off=0.0):
        Xc = np.einsum("oij,oj->oi", T[:, :3, :3], X) + T[:, :3, 3]
        Xc[:, 0] -= off
        return np.stack([cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx,
                         cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy], -1)

    k, p = pairs(P, m)
    uv = proj(poses[k], pts[p])
    ur = uv[:, 0] - cam.bf / (np.einsum("oj,oj->o", poses[k, 2, :3], pts[p])
                              + poses[k, 2, 3])
    uvr = np.concatenate([uv, ur[:, None]], -1) \
        + rng.normal(0, 1.0, (len(k), 3))
    xi = np.concatenate([rng.normal(0, 0.03, (K, 3)),
                         rng.normal(0, 0.003, (K, 3))], -1).astype(np.float32)
    xi[0] = 0
    noisy = np.asarray(se3.exp(jnp.asarray(xi))) @ poses
    base = ba.BAProblem(
        poses=jnp.asarray(noisy),
        points=jnp.asarray(pts + rng.normal(0, 0.1, pts.shape)
                           .astype(np.float32)),
        pose_fixed=jnp.asarray(np.arange(K) < 2),
        point_valid=jnp.ones(P, bool),
        obs=ba.BAObs(k=jnp.asarray(k), p=jnp.asarray(p),
                     uvr=jnp.asarray(uvr.astype(np.float32)),
                     inv_sigma2=jnp.ones(len(k), jnp.float32),
                     is_stereo=jnp.ones(len(k), bool),
                     valid=jnp.ones(len(k), bool)))
    if not L:
        return cam, base
    mid = np.stack([rng.uniform(-12, 12, L), rng.uniform(-4, 2, L),
                    rng.uniform(K + 2.0, K + 15.0, L)], -1)
    # directions orthogonal to `mid`: the line's point closest to the world
    # origin, which lines_ba's cheirality guard tests in every keyframe, is
    # then `mid` itself, metres in front of all of them. With random
    # directions that point lies behind some keyframes, observations switch
    # on and off during the solve, and the cost jumps; which jumps LM takes
    # then follows the order of float sums, and the GPU and CPU solves end
    # mm apart.
    d = rng.normal(size=(L, 3))
    d -= (d * mid).sum(-1, keepdims=True) * mid / (mid * mid).sum(
        -1, keepdims=True)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    A, B = mid - 1.5 * d, mid + 1.5 * d
    lk, li = pairs(L, ml)
    nz = lambda x: (x + rng.normal(0, 1.0, x.shape)).astype(np.float32)
    q, alpha = gl.minimal_from_x0dir(
        *gl.closest_point_form(
            jnp.asarray((mid + rng.normal(0, 0.05, mid.shape))
                        .astype(np.float32)),
            jnp.asarray(d.astype(np.float32))))
    lobs = lines_ba.LineBAObs(
        k=jnp.asarray(lk), l=jnp.asarray(li),
        x1l=jnp.asarray(nz(proj(poses[lk], A[li]))),
        x2l=jnp.asarray(nz(proj(poses[lk], B[li]))),
        x1r=jnp.asarray(nz(proj(poses[lk], A[li], cam.baseline))),
        x2r=jnp.asarray(nz(proj(poses[lk], B[li], cam.baseline))),
        octave=jnp.zeros(len(lk), jnp.int32), has_r=jnp.ones(len(lk), bool),
        valid=jnp.ones(len(lk), bool))
    return cam, lines_ba.JointProblem(base=base, q=q, alpha=alpha,
                                      line_valid=jnp.ones(L, bool), lobs=lobs)


def pose_diff(Ta, Tb):
    """(max translation difference m, max rotation difference rad)."""
    Ta, Tb = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    dt = np.abs(Ta[:, :3, 3] - Tb[:, :3, 3]).max()
    R = np.einsum("kji,kjl->kil", Ta[:, :3, :3], Tb[:, :3, :3])
    # sin(angle) from the skew part: stable for the tiny angles compared
    w = np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                  R[:, 1, 0] - R[:, 0, 1]], -1) / 2
    s = np.clip(np.linalg.norm(w, axis=-1), 0.0, 1.0)
    return float(dt), float(np.arcsin(s).max())


def compare_solves(name, solve, problem, cpu, chi2_of, poses_of) -> str:
    """Run `solve` on the GPU and on the CPU device; final chi2 within
    BA_CHI2_RTOL relative and poses within BA_POSE_TOL."""
    import jax
    g = solve(problem)
    c = solve(jax.device_put(problem, cpu))
    cg, cc = chi2_of(g), chi2_of(c)
    rel = abs(cg - cc) / max(abs(cc), 1e-12)
    dt, dr = pose_diff(poses_of(g), poses_of(c))
    expect(np.isfinite(cg) and rel <= BA_CHI2_RTOL,
           f"{name}: chi2 {cg:.6g} vs cpu {cc:.6g}")
    expect(dt <= BA_POSE_TOL and dr <= BA_POSE_TOL,
           f"{name}: poses differ by {dt:.2e} m / {dr:.2e} rad")
    return (f"{name} chi2 {cg:.6g} (rel {rel:.1e}), poses {dt:.1e} m "
            f"{dr:.1e} rad")


def check_ba(rng, cpu) -> list[str]:
    """Local BA (dense Schur and CG) and joint line BA at the tracker's
    local-BA widths (K=16 keyframes, 4096 points, 256 lines)."""
    from lldslam_tpu.optim import ba, lines_ba

    cam, prob = ba_problem(rng, K=16, P=4096, m=6)
    chi2 = lambda out: float(np.asarray(out[1]).sum())
    poses = lambda out: out[0].poses
    out = [compare_solves(
        f"ba dense" if dense else "ba cg",
        lambda pb, dense=dense: ba.ba_solve(cam, pb, iters=BA_ITERS,
                                            dense=dense, cg_iters=64),
        prob, cpu, chi2, poses) for dense in (True, False)]
    cam, joint = ba_problem(rng, K=16, P=4096, m=6, L=256, ml=6)
    out.append(compare_solves(
        "joint line ba",
        lambda pb: lines_ba.joint_ba_solve(cam, pb, iters=BA_ITERS),
        joint, cpu,
        lambda o: float(np.asarray(o[1]).sum() + np.asarray(o[2]).sum()),
        lambda o: o[0].base.poses))
    return out


def phase_kernels(cpu) -> str:
    from lldslam_tpu.ops.orb import OrbConfig

    rng = np.random.default_rng(0)
    cam_cfg, frames = _kitti_pair()
    cfg = OrbConfig(n_features=N_FEATURES)
    parts = [check_best2(rng), check_brief(frames[0], cfg),
             check_stereo(frames[0], cam_cfg.stereo_camera(), cfg, cpu)]
    parts += check_ba(rng, cpu)
    return "; ".join(parts)


# ---------------------------------------------------------------------------
# phase 2: points main path
# ---------------------------------------------------------------------------

def kitti_points_cfg():
    from lldslam_tpu.config import CameraConfig, SlamConfig, TrackingConfig
    from lldslam_tpu.ops.orb import OrbConfig
    cam_cfg = CameraConfig(**KITTI_CAM)
    return cam_cfg, SlamConfig(camera=cam_cfg,
                               orb=OrbConfig(n_features=N_FEATURES),
                               tracking=TrackingConfig(min_init_points=100))


def path_ate(T_wc_est, poses_cw):
    """(ATE RMSE m, path length m) against the generating T_cw poses."""
    from lldslam_tpu.io.trajectory import ate_rmse
    T_gt = np.linalg.inv(np.stack(poses_cw).astype(np.float64))
    c = T_gt[:, :3, 3]
    length = float(np.linalg.norm(np.diff(c, axis=0), axis=1).sum())
    return ate_rmse(np.asarray(T_wc_est), T_gt, align=False), length


def run_points(n_warm: int = 6, n_meas: int = 40, warmup: bool = True):
    """Track the points cell's frames; returns a dict of what it saw."""
    import jax
    from bench import _make_sequence
    from lldslam_tpu.system import System

    cam_cfg, cfg = kitti_points_cfg()
    frames, poses, _ = _make_sequence(cam_cfg.stereo_camera(), n_warm + n_meas,
                                      return_poses=True)
    sys_ = System(cfg, pipeline=True)
    t0 = time.perf_counter()
    if warmup:
        sys_.warmup()
    t_warmup = time.perf_counter() - t0
    for i in range(n_warm):
        sys_.track_stereo(*frames[i], timestamp=i * 0.1)
    t_cold = time.perf_counter() - t0
    staged = [sys_.tracker.stage_pair(l, r) for l, r in frames[n_warm:]]
    jax.block_until_ready(staged)
    t1 = time.perf_counter()
    for j, h in enumerate(staged):
        sys_.track_stereo(None, None, timestamp=(n_warm + j) * 0.1, pair_dev=h)
    sys_.flush()
    dt = time.perf_counter() - t1
    _, T_wc = sys_.tracker.trajectory()
    ate, length = path_ate(T_wc, poses)
    res = dict(states=[m.state for m in sys_.tracker.metrics],
               n_kf=int(sys_.map.n_kf),
               ba_s=float(sys_.tracker.mapper.stage_times.get("ba", 0.0)),
               ate=ate, length=length, n_traj=len(T_wc),
               warmup_s=t_warmup, cold_s=t_cold, fps=n_meas / dt)
    sys_.shutdown()
    return res


def phase_points() -> str:
    r = run_points()
    n = 46
    states = r["states"]
    expect(r["n_traj"] == n and len(states) == n,
           f"{r['n_traj']} poses / {len(states)} frames, {n} expected")
    bad = [i for i, s in enumerate(states) if s != "OK"]
    expect(not bad, f"frames not OK: {bad[:10]}")
    expect(r["n_kf"] >= 1 and r["ba_s"] > 0,
           f"{r['n_kf']} keyframes, local BA time {r['ba_s']}")
    expect(r["ate"] <= 0.01 * r["length"],
           f"ATE {r['ate']:.4f} m over {r['length']:.1f} m")
    expect(r["ate"] <= 1.5 * CPU_POINTS_ATE_M,
           f"ATE {r['ate']:.4f} m vs cpu {CPU_POINTS_ATE_M:.4f} m")
    return (f"46 frames OK, {r['n_kf']} KFs, local BA {r['ba_s']:.2f}s, "
            f"ATE {r['ate']:.4f} m over {r['length']:.1f} m (cpu "
            f"{CPU_POINTS_ATE_M:.4f} m); "
            f"warmup {r['warmup_s']:.1f}s, cold (warmup + 6 frames) "
            f"{r['cold_s']:.1f}s, observed {r['fps']:.2f} frames/s "
            f"(information only)")


# ---------------------------------------------------------------------------
# phase 3: stored-LBD lines + global BA
# ---------------------------------------------------------------------------

def global_cost(lc) -> float:
    """Robust (Huber) total cost of the map's global BA problem, points and
    >=4-observation lines, at the nominal kernel width."""
    import jax
    from lldslam_tpu.optim import ba, lines_ba
    problem, _ = lc.global_problem()
    lp = lc._gather_line_problem()
    if lp is None:
        cost = jax.jit(ba._total_cost, static_argnums=(0, 2))
        return float(cost(lc.store.cam, problem, True))
    _, q, alpha, line_valid, lobs = lp
    joint = lines_ba.JointProblem(base=problem, q=q, alpha=alpha,
                                  line_valid=line_valid, lobs=lobs)
    cost = jax.jit(lines_ba._joint_cost, static_argnums=(0, 2, 3))
    return float(cost(lc.store.cam, joint, float(lc.cfg.line.gamma), True,
                      1.0))


def phase_lines(tmp: Path, n_frames: int = 40) -> str:
    import jax
    from bench import _gen_stored_lines_ref_scale, _make_sequence
    from lldslam_tpu.config import (CameraConfig, LineConfig, SlamConfig,
                                    TrackingConfig)
    from lldslam_tpu.io.stored_lines import stage_stored_pair
    from lldslam_tpu.ops.orb import OrbConfig
    from lldslam_tpu.system import System

    cam_cfg = CameraConfig(**KITTI_CAM)
    cam = cam_cfg.stereo_camera()
    frames, poses, world = _make_sequence(cam, n_frames, seed=2,
                                          with_lines=True, return_poses=True)
    left, right = str(tmp / "lines_l"), str(tmp / "lines_r")
    _gen_stored_lines_ref_scale(cam, poses, world, left, right)
    cfg = SlamConfig(
        camera=cam_cfg, orb=OrbConfig(n_features=N_FEATURES),
        line=LineConfig(ld_type="LBDFloat", md_thr=0.6,
                        detections_path=left, descriptors_path=right),
        tracking=TrackingConfig(min_init_points=100))
    sys_ = System(cfg, pipeline=True)
    cap = sys_.tracker.store.n_ln_det
    n_warm = 4
    t0 = time.perf_counter()
    for i in range(n_warm):
        sys_.track_stereo(*frames[i], timestamp=i * 0.1)
    src = sys_.tracker._line_source
    staged = [(sys_.tracker.stage_pair(*frames[i]),
               stage_stored_pair(src[0], src[1], i))
              for i in range(n_warm, n_frames)]
    jax.block_until_ready([s[0] for s in staged])
    t1 = time.perf_counter()
    for j, (h, lv) in enumerate(staged):
        sys_.track_stereo(None, None, timestamp=(n_warm + j) * 0.1,
                          pair_dev=h, lines_dev=lv)
    sys_.flush()
    fps = (n_frames - n_warm) / (time.perf_counter() - t1)
    ms = sys_.tracker.metrics
    states = [m.state for m in ms]
    med = float(np.median([m.n_line_matches for m in ms]))
    n_ln = int(sys_.map.n_ln)
    bad = [i for i, s in enumerate(states) if s != "OK"]
    expect(len(states) == n_frames and not bad, f"frames not OK: {bad[:10]}")
    expect(med >= MIN_LINE_MATCHES, f"median line matches/frame {med}")
    expect(n_ln > 0, "no map lines")
    lc = sys_.tracker.loop_closer
    c0 = global_cost(lc)
    t2 = time.perf_counter()
    lc.global_ba(force_dist=False)
    t_gba = time.perf_counter() - t2
    c1 = global_cost(lc)
    s = sys_.map
    fin = (np.isfinite(s.kf_pose[:s.n_kf]).all()
           and np.isfinite(s.pt_pos[:s.n_pt][s.pt_valid[:s.n_pt]]).all()
           and np.isfinite(s.ln_x0[:s.n_ln][s.ln_valid[:s.n_ln]]).all())
    sys_.shutdown()
    expect(fin, "global BA wrote non-finite map state")
    expect(np.isfinite(c1) and c1 <= c0,
           f"global BA cost {c0:.6g} -> {c1:.6g}")
    return (f"{n_frames} frames OK, capacity {cap} lines, median line "
            f"matches/frame {med:.0f}, map lines {n_ln}, {s.n_kf} KFs; "
            f"global BA cost {c0:.6g} -> {c1:.6g} in {t_gba:.1f}s; observed "
            f"{fps:.2f} frames/s incl. {time.perf_counter() - t0:.0f}s total "
            f"(information only)")


# ---------------------------------------------------------------------------
# phase 4: multi-sequence driver
# ---------------------------------------------------------------------------

def phase_multi_seq(n_seq: int = 4, n_frames: int = 10) -> str:
    from bench import _make_sequence
    from lldslam_tpu.config import CameraConfig, SlamConfig, TrackingConfig
    from lldslam_tpu.ops.orb import OrbConfig
    from lldslam_tpu.parallel.multi_seq import PipelinedMultiSequenceDriver

    # the bench's multi-sequence cell (bench.py _bench_multi_seq)
    cam_cfg = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=120.0,
                           bf=200.0, fps=10.0, width=640, height=240)
    cfg = SlamConfig(camera=cam_cfg, orb=OrbConfig(n_features=600),
                     tracking=TrackingConfig(min_init_points=80))
    seqs = [_make_sequence(cam_cfg.stereo_camera(), n_frames, seed=10 + i)
            for i in range(n_seq)]
    drv = PipelinedMultiSequenceDriver(cfg, n_seq, enable_loops=False)
    t0 = time.perf_counter()
    for f in range(n_frames):
        drv.process([seqs[s][f] for s in range(n_seq)], [f * 0.1] * n_seq)
    drv.flush()
    dt = time.perf_counter() - t0
    states = [tr.state.name for tr in drv.trackers]
    lens = [len(tr.trajectory()[1]) for tr in drv.trackers]
    for tr in drv.trackers:
        if tr._tr_io is not None:
            tr._tr_io.shutdown(wait=False, cancel_futures=True)
        tr.mapper.close()
    drv._io.shutdown(wait=False, cancel_futures=True)
    expect(all(s == "OK" for s in states), f"states {states}")
    expect(lens == [n_frames] * n_seq, f"trajectory lengths {lens}")
    return (f"{n_seq} x {n_frames} frames, states {states} "
            f"({dt:.1f}s incl. compile)")


# ---------------------------------------------------------------------------
# phase 5: CLI entry
# ---------------------------------------------------------------------------

def phase_cli(tmp: Path) -> str:
    from lldslam_tpu import cli

    data = ROOT / "tests" / "data" / "mini_kitti"
    out = tmp / "CameraTrajectory.txt"
    rc = cli.main(["kitti", str(data / "settings.yaml"), str(data),
                   "--out", str(out)])
    n = len(np.loadtxt(data / "times.txt").reshape(-1))
    est = np.loadtxt(out)
    expect(rc == 0 and est.shape == (n, 12),
           f"rc {rc}, trajectory shape {est.shape}")
    expect(np.isfinite(est).all(), "non-finite trajectory")
    return f"trajectory {est.shape[0]} lines for {n} frames"


# ---------------------------------------------------------------------------
# --four-gpus: distributed global BA
# ---------------------------------------------------------------------------

def phase_dist_ba(devs) -> str:
    """dist_ba_solve / dist_joint_ba_solve over a 4-GPU mesh against the
    single-device solves on the KITTI-00-scale problems of
    tools/bench_distributed_ba.py (256 keyframes, 40k points, 2^19
    observations; 2048 lines), with 1 px observation noise."""
    import jax
    sys.path.insert(0, str(ROOT / "tools"))
    from bench_distributed_ba import (_camera, build_joint_problem,
                                      build_problem)
    from lldslam_tpu.optim import ba, lines_ba
    from lldslam_tpu.parallel import dist_schur

    cam = _camera()
    mesh = dist_schur.make_mesh(4, devices=devs[:4])
    iters, cg = 10, 256      # CG run near convergence on the 256-KF chain
    out = []

    def check(name, rel, dt, dr):
        expect(rel <= BA_CHI2_RTOL and dt <= DIST_POSE_TOL_M
               and dr <= BA_POSE_TOL,
               f"{name}: chi2 rel {rel:.2e}, poses {dt:.2e} m {dr:.2e} rad")

    problem = build_problem(noise_px=1.0)
    t0 = time.perf_counter()
    solved, chi2 = ba.ba_solve(cam, problem, iters=iters, dense=False,
                               cg_iters=cg)
    valid = np.asarray(problem.obs.valid)
    c1 = float(np.asarray(chi2)[valid].sum())
    t1 = time.perf_counter() - t0
    dp, _ = dist_schur.make_dist_problem(problem, 4)
    dp = dist_schur.place(dp, mesh)
    t0 = time.perf_counter()
    poses_n, _, chi2_n = dist_schur.dist_ba_solve(cam, dp, mesh, iters=iters,
                                                  cg_iters=cg)
    cn = float(np.asarray(chi2_n).sum())
    tn = time.perf_counter() - t0
    rel = abs(cn - c1) / max(c1, 1e-12)
    dt, dr = pose_diff(poses_n, solved.poses)
    check("dist BA", rel, dt, dr)
    out.append(f"points chi2 {cn:.6g} vs {c1:.6g} (rel {rel:.1e}), poses "
               f"{dt:.1e} m {dr:.1e} rad; first-call s 1 GPU {t1:.1f} / "
               f"4 GPUs {tn:.1f}")

    joint = build_joint_problem(noise_px=1.0)
    t0 = time.perf_counter()
    js, jc_p, jc_l = lines_ba.joint_ba_solve_cg(cam, joint, iters=iters,
                                                cg_iters=cg)
    j1 = float(np.asarray(jc_p)[valid].sum())
    t1 = time.perf_counter() - t0
    djp, _, _ = dist_schur.make_dist_joint_problem(joint, 4)
    djp = dist_schur.place_joint(djp, mesh)
    t0 = time.perf_counter()
    poses_j, _, _, _, jchi2 = dist_schur.dist_joint_ba_solve(
        cam, djp, mesh, iters=iters, cg_iters=cg)
    jn = float(np.asarray(jchi2).sum())
    tn = time.perf_counter() - t0
    rel = abs(jn - j1) / max(j1, 1e-12)
    dt, dr = pose_diff(poses_j, js.base.poses)
    check("dist joint BA", rel, dt, dr)
    out.append(f"joint point chi2 {jn:.6g} vs {j1:.6g} (rel {rel:.1e}), "
               f"poses {dt:.1e} m {dr:.1e} rad; first-call s 1 GPU "
               f"{t1:.1f} / 4 GPUs {tn:.1f}")
    return "; ".join(out)


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-GPU distributed global BA check")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import jax
    import lldslam_tpu  # noqa: F401  (precision + compile cache settings)

    devs = phase_device(4 if args.four_gpus else 1)
    cpu = jax.devices("cpu")[0]
    if args.four_gpus:
        phases = [("dist-ba", lambda: phase_dist_ba(devs))]
    else:
        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
        phases = [("kernels", lambda: phase_kernels(cpu)),
                  ("points", phase_points),
                  ("lines", lambda: phase_lines(tmp)),
                  ("multi-seq", phase_multi_seq),
                  ("cli", lambda: phase_cli(tmp))]
    failed = []
    for i, (name, fn) in enumerate(phases, start=1):
        t0 = time.perf_counter()
        try:
            msg = fn()
        except Exception as e:  # reported; the run then exits 1
            traceback.print_exc()
            failed.append(name)
            log(f"phase {i} {name}: FAIL {type(e).__name__}: {e}")
            continue
        log(f"phase {i} {name}: PASS {msg} [{time.perf_counter() - t0:.1f}s]")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    log(f"nvidia-smi: {gpu_name_and_power()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": 4 if args.four_gpus else len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
