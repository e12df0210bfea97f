"""Quantify per-cell top-k keypoint selection vs the reference quadtree.

The reference distributes FAST candidates with an adaptive quadtree
(`ORBextractor::DistributeOctTree`, /root/reference/src/ORBextractor.cc:539):
subdivide until #nodes >= budget, keep the best-response corner per node.
This framework uses fixed 30-px cells with per-cell top-k + global top-n
(ops/orb._select_level_keypoints) because the quadtree's data-dependent
list surgery has no efficient fixed-shape form on an accelerator. SURVEY.md §7
sanctioned that as a starting point; this harness measures what the
approximation costs.

Metrics on rendered corridor frame pairs (consecutive frames of the bench
world, ground-truth camera motion known => exact ground-truth reprojection
of every level-0 pixel):

- repeatability@2px: fraction of selected keypoints in frame A whose
  ground-truth position in frame B lies within 2 px of a keypoint selected
  in frame B (selection stability under viewpoint change — what actually
  feeds the matcher),
- coverage: occupancy fraction + entropy of 30-px cells (spatial
  uniformity — the quadtree's design goal).

Writes the table to stderr; the committed decision lives in
docs/QUADTREE.md.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if not os.environ.get("QT_DEVICE"):
    os.environ.setdefault("LLDSLAM_NO_COMPILE_CACHE", "1")
    import jax
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax
import jax.numpy as jnp


def distribute_octtree(xy: np.ndarray, resp: np.ndarray, w: int, h: int,
                       budget: int) -> np.ndarray:
    """Reference-faithful DistributeOctTree (ORBextractor.cc:539-714) over
    candidate (x, y) + responses: subdivide nodes (largest first once close
    to budget) until #nodes >= budget or every node holds one point; keep
    the best-response candidate per node. Returns selected indices."""
    nodes = []  # (x0, y0, x1, y1, idx array)
    n_ini = max(1, round(w / max(h, 1)))
    hx = w / n_ini
    for i in range(n_ini):
        sel = np.nonzero((xy[:, 0] >= i * hx) & (xy[:, 0] < (i + 1) * hx))[0]
        if len(sel):
            nodes.append((i * hx, 0.0, (i + 1) * hx, float(h), sel))

    def split(node):
        x0, y0, x1, y1, idx = node
        mx, my = 0.5 * (x0 + x1), 0.5 * (y0 + y1)
        out = []
        for (a0, b0, a1, b1) in ((x0, y0, mx, my), (mx, y0, x1, my),
                                 (x0, my, mx, y1), (mx, my, x1, y1)):
            m = ((xy[idx, 0] >= a0) & (xy[idx, 0] < a1)
                 & (xy[idx, 1] >= b0) & (xy[idx, 1] < b1))
            if m.any():
                out.append((a0, b0, a1, b1, idx[m]))
        return out

    while True:
        expandable = [i for i, n in enumerate(nodes) if len(n[4]) > 1]
        if not expandable or len(nodes) >= budget:
            break
        if len(nodes) + 3 * len(expandable) > budget:
            # final pass: split biggest nodes first until budget reached
            expandable.sort(key=lambda i: -len(nodes[i][4]))
        new_nodes = [n for i, n in enumerate(nodes) if i not in
                     set(expandable)]
        done = False
        for i in expandable:
            new_nodes.extend(split(nodes[i]))
            if len(new_nodes) + sum(
                    1 for j in expandable[expandable.index(i) + 1:]
                    for _ in (0,)) >= budget and \
                    len(new_nodes) >= budget:
                new_nodes.extend(nodes[j] for j in
                                 expandable[expandable.index(i) + 1:])
                done = True
                break
        nodes = new_nodes
        if done:
            break
    keep = []
    for _, _, _, _, idx in nodes:
        keep.append(idx[np.argmax(resp[idx])])
    keep = np.array(sorted(keep, key=lambda i: -resp[i])[:budget])
    return keep


def select_topk(score_np: np.ndarray, n_out: int, cfg) -> np.ndarray:
    """The framework's selection (ops/orb._select_level_keypoints)."""
    from lldslam_tpu.ops.orb import _select_level_keypoints
    xy, resp = jax.jit(
        _select_level_keypoints, static_argnames=("n_out", "cfg"))(
            jnp.asarray(score_np), n_out, cfg)
    xy, resp = np.asarray(xy), np.asarray(resp)
    return xy[resp > 0], resp[resp > 0]


def main():
    from bench import _make_sequence
    from lldslam_tpu.config import CameraConfig
    from lldslam_tpu.geometry import se3
    from lldslam_tpu.ops import fast, image
    from lldslam_tpu.ops.orb import OrbConfig, EDGE_MARGIN

    cam_cfg = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=120.0,
                           bf=200.0, fps=10.0, width=640, height=240)
    cam = cam_cfg.stereo_camera()
    cfg = OrbConfig(n_features=800, n_levels=4)
    n_pairs = 4
    frames = _make_sequence(cam, n_pairs + 1, seed=11)
    H, W = 240, 640
    budget = cfg.per_level_budget()[0]

    # ground-truth flow between consecutive frames: project each L0 pixel's
    # 3D hit (re-raycast depth is overkill; instead evaluate flow at the
    # keypoints by matching rendered world geometry via the known pose step)
    xi = np.array([0.0, 0.0, -1.0, 0.0, 0.003, 0.0], np.float32)
    dT = np.asarray(se3.exp(jnp.asarray(xi)))

    def depth_of(u, v, C, Rwc):
        """Ray-cast depth for pixels (corridor planes; bench world dims)."""
        half_w, cam_h, wall_top = 8.0, 1.65, -6.0
        d = (Rwc[:, 0][None] * ((u - cam.cx) / cam.fx)[:, None]
             + Rwc[:, 1][None] * ((v - cam.cy) / cam.fy)[:, None]
             + Rwc[:, 2][None])
        best = np.full(len(u), np.inf)
        for axis, off in ((1, cam_h), (0, -half_w), (0, half_w)):
            den = d[:, axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                tt = np.where(np.abs(den) > 1e-9,
                              (off - C[axis]) / den, np.inf)
            ok = tt > 0.25
            best = np.where(ok & (tt < best), tt, best)
        return best, d

    score_fn = jax.jit(lambda im: fast.nms3x3(
        fast.fast_score_map(im, cfg.min_th)))

    def select_both(img):
        sc = np.asarray(score_fn(jnp.asarray(img, jnp.float32)))
        ys, xs = np.mgrid[0:H, 0:W]
        inside = ((ys >= EDGE_MARGIN) & (ys < H - EDGE_MARGIN)
                  & (xs >= EDGE_MARGIN) & (xs < W - EDGE_MARGIN))
        sc = np.where(inside, sc, 0.0)
        xy_t, _ = select_topk(sc, budget, cfg)
        cand = np.nonzero(sc > 0)
        cxy = np.stack([cand[1], cand[0]], -1).astype(np.float32)
        cresp = sc[cand]
        keep = distribute_octtree(cxy, cresp, W, H, budget)
        return xy_t.astype(np.float32), cxy[keep]

    def gt_flow(xy, T_a):
        """Ground-truth reprojection of frame-a keypoints into frame a+1."""
        Twc = np.linalg.inv(T_a)
        Rwc, C = Twc[:3, :3], Twc[:3, 3]
        u, v = xy[:, 0], xy[:, 1]
        t, d = depth_of(u, v, C, Rwc)
        Xw = C[None] + t[:, None] * d
        T_b = dT @ T_a
        Xc = (T_b[:3, :3] @ Xw.T).T + T_b[:3, 3]
        ok = (Xc[:, 2] > 0.25) & np.isfinite(Xc).all(-1)
        u2 = cam.fx * Xc[:, 0] / np.maximum(Xc[:, 2], 1e-6) + cam.cx
        v2 = cam.fy * Xc[:, 1] / np.maximum(Xc[:, 2], 1e-6) + cam.cy
        ok &= (u2 >= 0) & (u2 < W) & (v2 >= 0) & (v2 < H)
        return np.stack([u2, v2], -1), ok

    def repeat_at(xy_a, xy_b, flow, ok, tol=2.0):
        if ok.sum() == 0 or len(xy_b) == 0:
            return 0.0
        d = np.linalg.norm(flow[ok][:, None] - xy_b[None], axis=-1)
        return float((d.min(axis=1) <= tol).mean())

    def coverage(xy):
        cells = (xy[:, 1].astype(int) // 30) * ((W + 29) // 30) \
            + xy[:, 0].astype(int) // 30
        n_cells = ((H + 29) // 30) * ((W + 29) // 30)
        counts = np.bincount(cells, minlength=n_cells).astype(np.float64)
        p = counts / max(counts.sum(), 1)
        ent = -np.sum(p[p > 0] * np.log(p[p > 0])) / np.log(n_cells)
        return float((counts > 0).mean()), float(ent)

    rows = {"topk": [], "quadtree": []}
    T = np.eye(4, dtype=np.float32)
    sel_prev = None
    for i in range(n_pairs + 1):
        img = frames[i][0]
        sel = select_both(img)
        if sel_prev is not None:
            for name, a, b in (("topk", sel_prev[0], sel[0]),
                               ("quadtree", sel_prev[1], sel[1])):
                flow, ok = gt_flow(a, T_prev)
                rows[name].append(dict(
                    n=len(a), rep=repeat_at(a, b, flow, ok),
                    cov=coverage(a)[0], ent=coverage(a)[1]))
        T_prev = T.copy()
        sel_prev = sel
        T = dT @ T

    print(f"{'method':<10} {'n_kp':>6} {'repeat@2px':>11} "
          f"{'cell occ':>9} {'entropy':>8}", file=sys.stderr)
    out = {}
    for name in ("topk", "quadtree"):
        r = rows[name]
        out[name] = dict(
            n=np.mean([x["n"] for x in r]),
            rep=np.mean([x["rep"] for x in r]),
            cov=np.mean([x["cov"] for x in r]),
            ent=np.mean([x["ent"] for x in r]))
        o = out[name]
        print(f"{name:<10} {o['n']:6.0f} {o['rep']:11.3f} "
              f"{o['cov']:9.3f} {o['ent']:8.3f}", file=sys.stderr)
    return out


if __name__ == "__main__":
    main()
