"""Loop closing: detection, Sim(3) verification, and map-wide correction.

Replaces the LoopClosing thread (reference src/LoopClosing.cc) with a
deterministic per-keyframe step invoked by the tracker:

1. DetectLoop (LoopClosing.cc:105-231): BoW minScore over covisible KFs,
   database candidates, 3-consecutive covisibility-consistency groups.
2. ComputeSim3 (LoopClosing.cc:233-402): descriptor match between the two
   KFs' point-carrying features, batched Horn Sim3 RANSAC + GN refinement
   (>= 20 inlier gate, LoopClosing.cc:328-331), then GUIDED matching — the
   loop side's local map points projected into the current KF with the
   corrected pose (SearchByProjection loop variant, ORBmatcher.cc:290;
   SearchBySim3 intent, ORBmatcher.cc:1102) — accepting only when the total
   matched features reach >= 40 (LoopClosing.cc:377-387).
3. CorrectLoop (LoopClosing.cc:404-587): essential-graph optimization over
   all keyframes (SPANNING-TREE edges + every persisted past loop edge +
   strong-covisibility edges + the new loop edge, Optimizer.cc:1391-1654),
   point AND line remap through their anchor keyframes, loop-point fusion:
   the guided matches replace/extend the current side's landmarks and
   SearchAndFuse projects the loop points into every corrected-group KF,
   merging duplicates (LoopClosing.cc:520-544, 589-620). Then global bundle
   adjustment (RunGlobalBundleAdjustment, LoopClosing.cc:647-751) on the
   matrix-free CG path.

Scale is fixed (stereo, LoopClosing.cc:276): Sim3 with s=1 everywhere, but
the pose-graph state stays Sim(3) to mirror the reference's machinery (and
support monocular later).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig
from ..ops import hamming
from ..optim import ba, pose_graph, sim3_solver
from ..slammap.map_store import MapStore
from .bow import Vocabulary
from .database import KeyFrameDatabase


@dataclass
class LoopEvent:
    query_kf: int
    matched_kf: int
    n_inliers: int


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("cam",))
def _sim3_attempt_packed(cam, X1p, X2p, uv1p, uv2p, s2_1, s2_2, vmask, key):
    """RANSAC + GN-refined Sim3 in ONE program with ONE packed readback:
    [n_inl, n_ref, R(9) bitcast, t(3) bitcast, s bitcast, inl2 bit-words].
    A two-program flow would sync int(n_inl) mid-way — one readback per
    perceptual-aliasing candidate, at near-KF rate on self-similar worlds
    (reference gate semantics unchanged: LoopClosing.cc:328-331)."""
    from ..pipeline.tracker import _pack_bits

    (R, t, sc), inl, n_inl = sim3_solver.ransac_sim3(
        cam, cam, X1p, X2p, uv1p, uv2p, s2_1, s2_2, vmask, key)
    (R2, t2, sc2), inl2, n_ref = sim3_solver.refine_sim3(
        cam, cam, (R, t, sc), X1p, X2p, uv1p, uv2p,
        1.0 / s2_1, 1.0 / s2_2, inl & vmask)
    bc = lambda a: jax.lax.bitcast_convert_type(
        jnp.asarray(a, jnp.float32).reshape(-1), jnp.int32)
    return jnp.concatenate([
        n_inl.astype(jnp.int32).reshape(1),
        n_ref.astype(jnp.int32).reshape(1),
        bc(R2), bc(t2), bc(sc2),
        _pack_bits(inl2),
    ])


class LoopCloser:
    def __init__(self, store: MapStore, voc: Vocabulary, cfg: SlamConfig,
                 covisibility_consistency_th: int = 3,
                 gba_obs_cap: int = 1 << 18):
        self.store = store
        self.voc = voc
        self.cfg = cfg
        self.db = KeyFrameDatabase(voc)
        self.consistent_groups: list[tuple[set, int]] = []
        self.covis_th = covisibility_consistency_th
        self.last_loop_kf = -10**9
        self.events: list[LoopEvent] = []
        self.gba_obs_cap = gba_obs_cap
        self._inv_sigma2 = np.power(
            1.0 / store.cfg.scale ** 2, np.arange(store.cfg.n_levels)
        ).astype(np.float32)
        self._key = jax.random.PRNGKey(0)
        self.stage_times: dict[str, float] = {}
        # jitted KF<->KF matcher: calling hamming.match_descriptors eagerly
        # dispatches ~20 single ops per candidate
        from functools import partial as _partial
        self._kf_match = jax.jit(_partial(
            hamming.match_descriptors, max_dist=hamming.TH_LOW, ratio=0.75))

    # ------------------------------------------------------------------

    def warmup(self):
        warmup_loop_programs(self.store.cam)

    # ------------------------------------------------------------------

    def _kf_bow(self, kf_id: int):
        s = self.store
        valid = s.kf_kp_valid[kf_id]
        return self.voc.bow_vector(s.kf_desc[kf_id], valid)

    def dispatch_bow(self, desc_dev, valid_dev):
        """Dispatch the batched vocabulary descent on the keyframe's
        device-resident descriptors (zero upload — the descriptors were
        computed on device and are not re-uploaded). Absorb with
        `finish_keyframe`."""
        import jax.numpy as jnp
        from .bow import _descend
        ch, nd, nw = self.voc.device_arrays()
        words = _descend(ch, nd, nw, desc_dev, self.voc.L)
        words = jnp.where(valid_dev, words, -1)
        return words

    def finish_keyframe(self, kf_id: int, words: "np.ndarray") -> bool:
        """Staged second half of process_keyframe: detection + (rare)
        Sim3/correction from pre-computed word ids."""
        self.stage_times["n_words_staged"] = self.stage_times.get(
            "n_words_staged", 0) + 1
        ids, vals = self.voc.vector_from_words(words)
        return self._finish(kf_id, ids, vals)

    def process_keyframe(self, kf_id: int) -> bool:
        """Run the loop pipeline for a new keyframe. Returns True when a loop
        was detected and the map corrected."""
        import time as _time
        t = _time.perf_counter
        t0 = t()
        self.stage_times["n_host_bow"] = self.stage_times.get(
            "n_host_bow", 0) + 1
        ids, vals = self._kf_bow(kf_id)
        t1 = t()
        self.stage_times["bow"] = self.stage_times.get("bow", 0.0) \
            + (t1 - t0)
        return self._finish(kf_id, ids, vals)

    def _finish(self, kf_id: int, ids, vals) -> bool:
        import time as _time
        t = _time.perf_counter
        t1 = t()
        candidate = self._detect(kf_id, ids, vals)
        t2 = t()
        corrected = False
        if candidate is not None:
            res = self._compute_sim3(kf_id, candidate)
            if res is not None:
                S_cm, n_inl = res
                self._correct(kf_id, candidate, S_cm)
                self.events.append(LoopEvent(kf_id, candidate, n_inl))
                self.last_loop_kf = kf_id
                self.consistent_groups = []
                corrected = True
        t3 = t()
        self.db.add(kf_id, ids, vals)
        st = self.stage_times
        for k, v in (("detect", t2 - t1), ("sim3+correct", t3 - t2)):
            st[k] = st.get(k, 0.0) + v
        st["n"] = st.get("n", 0) + 1
        return corrected

    # ------------------------------------------------------------------

    def _detect(self, kf_id: int, ids, vals) -> int | None:
        s = self.store
        if kf_id < self.last_loop_kf + 10 or s.n_kf < 12:
            return None
        covis, _ = s.covisible_kfs(kf_id, min_shared=15)
        connected = set(int(c) for c in covis)
        if not connected:
            return None
        min_score = min(
            (self.db.score_vs(ids, vals, c) for c in connected
             if c in self.db.kf_words), default=1.0)

        def groups_fn(kf: int):
            return [int(x) for x in s.covisible_kfs(int(kf), min_shared=15)[0]]

        cands = self.db.detect_loop_candidates_vec(
            ids, vals, max(min_score, 1e-3), connected | {kf_id}, groups_fn)
        self.stage_times["n_candidates"] = self.stage_times.get(
            "n_candidates", 0) + len(cands)
        if not cands:
            self.consistent_groups = []
            return None
        # covisibility-consistency over consecutive keyframes
        # (LoopClosing.cc:154-213)
        enough: list[int] = []
        new_groups: list[tuple[set, int]] = []
        for cand in cands:
            group = set(groups_fn(cand)) | {cand}
            matched = False
            for prev_group, count in self.consistent_groups:
                if group & prev_group:
                    new_groups.append((group, count + 1))
                    if count + 1 >= self.covis_th:
                        enough.append(cand)
                    matched = True
                    break
            if not matched:
                new_groups.append((group, 0))
        self.consistent_groups = new_groups
        return enough[0] if enough else None

    # ------------------------------------------------------------------

    def _compute_sim3(self, kf_c: int, kf_m: int):
        """Descriptor match + batched Horn RANSAC between keyframes.
        Returns (S_cm aligning m's camera frame into c's, inliers) or None."""
        s = self.store
        cam = s.cam
        has_c = s.kf_kp_valid[kf_c] & (s.kf_pt_ids[kf_c] >= 0)
        has_m = s.kf_kp_valid[kf_m] & (s.kf_pt_ids[kf_m] >= 0)
        idx, ok, _ = self._kf_match(
            jnp.asarray(s.kf_desc[kf_c]), jnp.asarray(has_c),
            jnp.asarray(s.kf_desc[kf_m]), jnp.asarray(has_m))
        idx, ok = np.asarray(idx), np.asarray(ok)
        sel_c = np.nonzero(ok)[0]
        if len(sel_c) < 20:
            return None
        sel_m = idx[sel_c]
        pc = s.pt_pos[s.kf_pt_ids[kf_c, sel_c]]
        pm = s.pt_pos[s.kf_pt_ids[kf_m, sel_m]]
        Tc, Tm = s.kf_pose[kf_c], s.kf_pose[kf_m]
        X1 = (Tc[:3, :3] @ pc.T).T + Tc[:3, 3]
        X2 = (Tm[:3, :3] @ pm.T).T + Tm[:3, 3]
        uv1 = s.kf_xy[kf_c, sel_c]
        uv2 = s.kf_xy[kf_m, sel_m]
        s2_1 = (1.0 / self._inv_sigma2)[s.kf_oct[kf_c, sel_c]]
        s2_2 = (1.0 / self._inv_sigma2)[s.kf_oct[kf_m, sel_m]]
        # pad to a fixed bucket so loop events reuse one compiled program
        cap = 512
        n = min(len(sel_c), cap)

        def pad(a, fill=0.0):
            out = np.full((cap,) + a.shape[1:], fill, a.dtype)
            out[:n] = a[:n]
            return out

        self._key, key = jax.random.split(self._key)
        X1p = jnp.asarray(pad(X1.astype(np.float32)))
        X2p = jnp.asarray(pad(X2.astype(np.float32)))
        uv1p = jnp.asarray(pad(uv1.astype(np.float32)))
        uv2p = jnp.asarray(pad(uv2.astype(np.float32)))
        vmask = jnp.asarray(np.arange(cap) < n)
        # RANSAC + GN refinement chained in ONE device round trip (both
        # accept gates checked on host after a single batched fetch
        # instead of separate int(n_inl)/int(n_ref) syncs: perceptual-
        # aliasing candidates reach here at KF rate on self-similar worlds)
        out = np.asarray(_sim3_attempt_packed(
            cam, X1p, X2p, uv1p, uv2p,
            jnp.asarray(pad(s2_1, 1.0)), jnp.asarray(pad(s2_2, 1.0)),
            vmask, key))
        n_inl, n_ref = int(out[0]), int(out[1])
        if n_inl < 20:
            return None
        if n_ref < 20:  # OptimizeSim3 gate (LoopClosing.cc:328-331)
            return None
        R = out[2:11].view(np.float32).reshape(3, 3)
        t = out[11:14].view(np.float32)
        sc = float(out[14:15].view(np.float32)[0])
        from ..pipeline.tracker import _unpack_bits_np
        inl2 = _unpack_bits_np(out[15:], cap)

        # --- guided matching with the corrected pose (LoopClosing.cc:
        # 336-387): project the loop side's local map points into the
        # current KF and demand >= 40 total matched features ---
        Tm = s.kf_pose[kf_m]
        T_corr = np.eye(4, dtype=np.float32)
        T_corr[:3, :3] = R @ Tm[:3, :3]
        T_corr[:3, 3] = sc * (R @ Tm[:3, 3]) + t
        loop_pids = self._loop_points(kf_m)
        kp2lp = self._project_match(kf_c, loop_pids, T_corr, th=2.5)
        matched_feats = set(np.nonzero(kp2lp >= 0)[0].tolist())
        # plus the features matched through the Sim3 inlier set
        matched_feats |= set(int(x) for x in sel_c[:n][np.asarray(inl2)[:n]])
        if len(matched_feats) < 40:  # LoopClosing.cc:387
            return None
        self._loop_guided = (kp2lp, loop_pids)
        return (R, t, sc), n_ref

    # ------------------------------------------------------------------

    def _loop_points(self, kf_m: int, top: int = 10) -> np.ndarray:
        """Loop-side local map points: kf_m + its covisible KFs' points
        (mvpLoopMapPoints, LoopClosing.cc:440-452)."""
        s = self.store
        covis, _ = s.covisible_kfs(kf_m, min_shared=15, top=top)
        kfs = np.concatenate([[kf_m], covis]).astype(np.int32)
        pids = np.unique(s.kf_pt_ids[kfs])
        pids = pids[pids >= 0]
        return pids[s.pt_valid[pids]]

    def _project_match(self, kf_c: int, pids: np.ndarray, T_cw: np.ndarray,
                       th: float = 2.5, cap: int = 8192) -> np.ndarray:
        """Project the given map points into keyframe kf_c's feature snapshot
        and match (the loop-Sim3 SearchByProjection, ORBmatcher.cc:290).
        Returns kp2pid (N,) global point ids per feature (-1 none)."""
        from ..frontend import matching

        s = self.store
        pids = pids[-cap:]
        P = len(pids)
        pad = cap - P
        view = matching.MapPointView(
            pos=jnp.asarray(np.concatenate(
                [s.pt_pos[pids], np.zeros((pad, 3), np.float32)])),
            desc=jnp.asarray(np.concatenate(
                [s.pt_desc[pids], np.zeros((pad, 8), np.uint32)])),
            normal=jnp.asarray(np.concatenate(
                [s.pt_normal[pids], np.zeros((pad, 3), np.float32)])),
            min_dist=jnp.asarray(np.concatenate(
                [s.pt_min_dist[pids], np.zeros(pad, np.float32)])),
            max_dist=jnp.asarray(np.concatenate(
                [s.pt_max_dist[pids], np.zeros(pad, np.float32)])),
            valid=jnp.asarray(np.concatenate(
                [np.ones(P, bool), np.zeros(pad, bool)])),
        )
        feats = matching.FrameFeatures(
            xy=jnp.asarray(s.kf_xy[kf_c]), ur=jnp.asarray(s.kf_ur[kf_c]),
            octave=jnp.asarray(s.kf_oct[kf_c]),
            angle=jnp.asarray(s.kf_angle[kf_c]),
            desc=jnp.asarray(s.kf_desc[kf_c]),
            valid=jnp.asarray(s.kf_kp_valid[kf_c]))
        _, kp2pt, _, _ = matching.search_by_projection(
            s.cam, jnp.asarray(T_cw.astype(np.float32)), view, feats,
            n_levels=s.cfg.n_levels, scale=s.cfg.scale, th=th)
        kp2pt = np.asarray(kp2pt)
        pid_arr = np.concatenate([pids, np.full(pad, -1, pids.dtype)])
        return np.where(kp2pt >= 0, pid_arr[np.maximum(kp2pt, 0)],
                        -1).astype(np.int32)

    # ------------------------------------------------------------------

    def _correct(self, kf_c: int, kf_m: int, S_cm):
        """Essential-graph optimization + point remap + global BA."""
        s = self.store
        K = s.n_kf
        R_cm, t_cm, s_cm = S_cm
        poses_old = s.kf_pose[:K].copy()

        # corrected current pose: S_cw = S_cm * S_mw (LoopClosing.cc:275-290)
        Tm = poses_old[kf_m]
        R_corr = R_cm @ Tm[:3, :3]
        t_corr = s_cm * (R_cm @ Tm[:3, 3]) + t_cm

        # vertices: current estimates, with the current KF re-anchored
        R0 = poses_old[:, :3, :3].copy()
        t0 = poses_old[:, :3, 3].copy()
        s0 = np.ones(K, np.float32)
        R0[kf_c] = R_corr
        t0[kf_c] = t_corr

        # edges: sequential chain + strong covisibility + loop edge, with
        # measurements from the pre-correction relative poses
        e_i, e_j, mR, mt, ms = [], [], [], [], []

        def add_edge(i, j, Ti, Tj):
            M = Ti @ np.linalg.inv(Tj)
            e_i.append(i); e_j.append(j)
            mR.append(M[:3, :3].copy()); mt.append(M[:3, 3].copy()); ms.append(1.0)

        # spanning-tree backbone (Optimizer.cc:1497-1522; tree maintained by
        # MapStore.set_parent_from_covisibility / reparent_children)
        tree_pairs = set()
        for k in range(1, K):
            p = int(s.kf_parent[k]) if s.kf_parent[k] >= 0 else k - 1
            add_edge(k, p, poses_old[k], poses_old[p])
            tree_pairs.add((min(k, p), max(k, p)))
        # every PAST loop edge persists in the essential graph
        # (KeyFrame::GetLoopEdges, Optimizer.cc:1524-1540)
        for i, j in s.loop_edges:
            if (min(i, j), max(i, j)) not in tree_pairs:
                add_edge(i, j, poses_old[i], poses_old[j])
                tree_pairs.add((min(i, j), max(i, j)))
        # strong covisibility (weight >= 100, Optimizer.cc:1546)
        for k in range(K):
            covis, counts = s.covisible_kfs(k, min_shared=100)
            for c, w in zip(covis, counts):
                c = int(c)
                if c < k and (c, k) not in tree_pairs:
                    add_edge(k, c, poses_old[k], poses_old[c])
                    tree_pairs.add((c, k))
        # the new loop edge c <- m with measurement S_cm
        e_i.append(kf_c); e_j.append(kf_m)
        mR.append(R_cm); mt.append(t_cm); ms.append(s_cm)
        s.loop_edges.append((kf_c, kf_m))

        E = len(e_i)
        ecap = ((E + 255) // 256) * 256
        kcap = ((K + 63) // 64) * 64

        def padk(a, shape_tail, fill=0.0, dtype=np.float32):
            out = np.full((kcap,) + shape_tail, fill, dtype)
            out[:K] = a
            return out

        def pade(a, shape_tail, fill=0.0, dtype=np.float32):
            arr = np.asarray(a, dtype)
            out = np.full((ecap,) + shape_tail, fill, dtype)
            out[:E] = arr
            return out

        Rpad = padk(R0, (3, 3))
        Rpad[K:] = np.eye(3, dtype=np.float32)
        mR_pad = pade(np.stack(mR), (3, 3))
        # identity (not zero) measurements on padding edges: log() of a
        # zero-matrix composition is NaN and NaN * 0-weight still poisons
        # the scattered Hessian
        mR_pad[E:] = np.eye(3, dtype=np.float32)
        fixed = np.zeros(kcap, bool)
        fixed[kf_m] = True  # gauge: loop keyframe (Optimizer.cc:1442)
        fixed[K:] = True
        g = pose_graph.PoseGraph(
            R=jnp.asarray(Rpad),
            t=jnp.asarray(padk(t0, (3,))),
            s=jnp.asarray(padk(s0, (), 1.0)),
            fixed=jnp.asarray(fixed),
            e_i=jnp.asarray(pade(e_i, (), 0, np.int32)),
            e_j=jnp.asarray(pade(e_j, (), 0, np.int32)),
            m_R=jnp.asarray(mR_pad),
            m_t=jnp.asarray(pade(np.stack(mt), (3,))),
            m_s=jnp.asarray(pade(ms, (), 1.0)),
            e_valid=jnp.asarray(np.arange(ecap) < E),
        )
        g_opt = pose_graph.optimize_pose_graph(g, iters=15, cg_iters=48)
        R_new = np.asarray(g_opt.R)[:K]
        t_new = np.asarray(g_opt.t)[:K]
        s_new = np.asarray(g_opt.s)[:K]

        # write back SE3 poses (Sim3 -> SE3: t/s, Optimizer.cc:1601-1612)
        T_new = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
        T_new[:, :3, :3] = R_new
        T_new[:, :3, 3] = t_new / s_new[:, None]

        # remap points through their anchor KF (LoopClosing.cc:467-518):
        # P' = S_new_anchor^-1 ( S_old_anchor (P) )
        pids = np.nonzero(s.pt_valid[: s.n_pt])[0]
        anchors = np.clip(s.pt_first_kf[pids], 0, K - 1)
        P = s.pt_pos[pids]
        To = poses_old[anchors]
        Xa = np.einsum("nij,nj->ni", To[:, :3, :3], P) + To[:, :3, 3]
        # inverse of corrected Sim3 (R,t,s): X_w = R^T (s^-1)(Xa - t)
        Rn = R_new[anchors]
        tn = t_new[anchors]
        sn = s_new[anchors]
        Xw = np.einsum("nji,nj->ni", Rn, (Xa - tn) / sn[:, None])
        s.pt_pos[pids] = Xw.astype(np.float32)

        # remap MAP LINES through their anchor KFs the same way
        # (the reference leaves lines to the next retriangulation;
        # transforming X0/dir keeps them consistent immediately)
        lids = np.nonzero(s.ln_valid[: s.n_ln])[0]
        if len(lids):
            lanch = np.clip(s.ln_first_kf[lids], 0, K - 1)
            To = poses_old[lanch]
            X0a = np.einsum("nij,nj->ni", To[:, :3, :3], s.ln_x0[lids]) \
                + To[:, :3, 3]
            da = np.einsum("nij,nj->ni", To[:, :3, :3], s.ln_dir[lids])
            Rn_l, tn_l, sn_l = R_new[lanch], t_new[lanch], s_new[lanch]
            X0w = np.einsum("nji,nj->ni", Rn_l, (X0a - tn_l) / sn_l[:, None])
            dw = np.einsum("nji,nj->ni", Rn_l, da)
            dw /= np.maximum(np.linalg.norm(dw, axis=-1, keepdims=True), 1e-9)
            # restore the X0-perp-dir invariant of the minimal form
            X0w = X0w - np.sum(X0w * dw, axis=-1, keepdims=True) * dw
            s.ln_x0[lids] = X0w.astype(np.float32)
            s.ln_dir[lids] = dw.astype(np.float32)

        s.kf_pose[:K] = T_new

        # --- loop fusion (LoopClosing.cc:520-544 current-KF binding +
        # SearchAndFuse :589-620 over the corrected group). Divergence: the
        # reference fuses BEFORE the essential graph (its fusion creates the
        # LoopConnections the graph optimizes); here the graph runs first and
        # fusion uses the already-consistent geometry — the new covisibility
        # edges take effect from the next event on. ---
        kp2lp, loop_pids = getattr(self, "_loop_guided", (None, None))
        covis, _ = s.covisible_kfs(kf_c, min_shared=15, top=10)
        group = np.concatenate([[kf_c], covis]).astype(np.int32)
        if kp2lp is not None:
            self._fuse_into_kf(kf_c, kp2lp)
            for kf in group[1:]:
                k2 = self._project_match(int(kf), loop_pids,
                                         s.kf_pose[int(kf)], th=2.0)
                self._fuse_into_kf(int(kf), k2)
            s.refresh_obs_counts()
            s._update_point_geometry(loop_pids)
            self._loop_guided = (None, None)

        # global BA (LoopClosing.cc:647-751 -> Optimizer.cc:312)
        self.global_ba()

    def _fuse_into_kf(self, kf: int, kp2pid: np.ndarray):
        """Bind matched loop points into one keyframe: a hit on a feature
        holding another point REPLACES that point with the loop point
        (MapPoint::Replace — the loop side survives, ORBmatcher::Fuse
        semantics in SearchAndFuse, LoopClosing.cc:609-617); a hit on a free
        feature adds an observation."""
        s = self.store
        K = s.n_kf
        row = s.kf_pt_ids[kf]
        present = set(int(x) for x in row[row >= 0])
        merged = False
        for f in np.nonzero(kp2pid >= 0)[0]:
            lp = int(kp2pid[f])
            if not s.pt_valid[lp]:
                continue
            q = int(row[f])
            if q == lp:
                continue
            if q < 0:
                if lp in present:
                    continue
                row[f] = lp
                present.add(lp)
                s.mark_obs_dirty()
            else:
                m = s.kf_pt_ids[:K] == q
                s.kf_pt_ids[:K][m] = lp
                s.pt_valid[q] = False
                present.discard(q)
                present.add(lp)
                merged = True
                s.mark_obs_dirty()
        if merged:
            # row-wise dedup after global replacement (one obs per (KF, pt))
            ids = s.kf_pt_ids[:K]
            for k in range(K):
                r = ids[k]
                vals = r[r >= 0]
                if len(vals) != len(np.unique(vals)):
                    seen: set[int] = set()
                    for i in np.nonzero(r >= 0)[0]:
                        v = int(r[i])
                        if v in seen:
                            r[i] = -1
                        else:
                            seen.add(v)
            s.mark_obs_dirty()

    # ------------------------------------------------------------------

    def global_problem(self):
        """The point half of the full-map BA problem, padded to static
        buckets: (problem, pids) with pids the map ids of the problem's
        points, or None when the map has fewer than two keyframes or no
        points."""
        s = self.store
        K = s.n_kf
        pids = np.nonzero(s.pt_valid[: s.n_pt])[0]
        if K < 2 or len(pids) == 0:
            return None
        pt_lut = np.full(s.max_pt, -1, np.int32)
        pt_lut[pids] = np.arange(len(pids), dtype=np.int32)
        kf_idx, feat_idx = np.nonzero(s.kf_pt_ids[:K] >= 0)
        p_idx = pt_lut[s.kf_pt_ids[kf_idx, feat_idx]]
        keep = p_idx >= 0
        kf_idx, feat_idx, p_idx = kf_idx[keep], feat_idx[keep], p_idx[keep]
        # one observation per (KF, point): duplicates (possible after fuse
        # merges) would double-count residuals
        _, first = np.unique(
            kf_idx.astype(np.int64) * s.max_pt + p_idx, return_index=True)
        first = np.sort(first)
        kf_idx, feat_idx, p_idx = kf_idx[first], feat_idx[first], p_idx[first]
        if len(kf_idx) > self.gba_obs_cap:
            self.stage_times["gba_obs_dropped"] = self.stage_times.get(
                "gba_obs_dropped", 0) + (len(kf_idx) - self.gba_obs_cap)
            sel = np.linspace(0, len(kf_idx) - 1, self.gba_obs_cap).astype(int)
            kf_idx, feat_idx, p_idx = kf_idx[sel], feat_idx[sel], p_idx[sel]
        uv = s.kf_xy[kf_idx, feat_idx]
        ur = s.kf_ur[kf_idx, feat_idx]
        uvr = np.concatenate([uv, ur[:, None]], -1).astype(np.float32)
        O = len(kf_idx)
        ocap = ((O + 4095) // 4096) * 4096
        kcap = ((K + 63) // 64) * 64
        pcap = ((len(pids) + 2047) // 2048) * 2048

        def pad(a, fill=0):
            out = np.full((ocap,) + a.shape[1:], fill, a.dtype)
            out[:O] = a
            return out

        poses = np.tile(np.eye(4, dtype=np.float32), (kcap, 1, 1))
        poses[:K] = s.kf_pose[:K]
        points = np.zeros((pcap, 3), np.float32)
        points[: len(pids)] = s.pt_pos[pids]
        fixed = np.zeros(kcap, bool)
        fixed[0] = True
        fixed[K:] = True
        pvalid = np.zeros(pcap, bool)
        pvalid[: len(pids)] = True
        problem = ba.BAProblem(
            poses=jnp.asarray(poses),
            points=jnp.asarray(points),
            pose_fixed=jnp.asarray(fixed),
            point_valid=jnp.asarray(pvalid),
            obs=ba.BAObs(
                k=jnp.asarray(pad(kf_idx.astype(np.int32))),
                p=jnp.asarray(pad(p_idx.astype(np.int32))),
                uvr=jnp.asarray(pad(uvr)),
                inv_sigma2=jnp.asarray(pad(
                    self._inv_sigma2[s.kf_oct[kf_idx, feat_idx]], 1.0)),
                is_stereo=jnp.asarray(pad(ur >= 0)),
                valid=jnp.asarray(np.arange(ocap) < O),
            ),
        )
        return problem, pids

    def global_ba(self, iters: int = 10, cg_iters: int = 64,
                  force_dist: bool | None = None):
        """Full-map BA (BundleAdjustment, Optimizer.cc:321-560; 10
        iterations, LoopClosing.cc:652). On a multi-device mesh the solve
        runs landmark-sharded with explicit collectives
        (parallel.dist_schur — SURVEY.md §5.7 scale-out design); on one
        device it uses the matrix-free CG path. `force_dist` overrides the
        device-count auto-selection (tests)."""
        gp = self.global_problem()
        if gp is None:
            return
        problem, pids = gp
        s = self.store
        K = s.n_kf
        use_dist = (len(jax.devices()) > 1 if force_dist is None
                    else force_dist)
        if use_dist:
            from ..parallel import dist_schur
            mesh = dist_schur.make_mesh()
            n_shards = int(np.prod(mesh.devices.shape))
            lp = self._gather_line_problem()
            if lp is None:
                dp, _ = dist_schur.make_dist_problem(problem, n_shards)
                dp = dist_schur.place(dp, mesh)
                poses_n, points_n, _ = dist_schur.dist_ba_solve(
                    s.cam, dp, mesh, iters=iters, cg_iters=cg_iters)
                s.kf_pose[:K] = np.asarray(poses_n)[:K]
                s.pt_pos[pids] = np.asarray(points_n)[: len(pids)]
                return
            # joint pose+point+line distributed solve: the same problem as
            # the single-device path (Optimizer.cc:473/:149), both landmark
            # classes sharded over the mesh
            from ..optim import lines_ba
            lids, q, alpha, line_valid, lobs = lp
            joint = lines_ba.JointProblem(
                base=problem, q=q, alpha=alpha, line_valid=line_valid,
                lobs=lobs)
            djp, _, _ = dist_schur.make_dist_joint_problem(joint, n_shards)
            djp = dist_schur.place_joint(djp, mesh)
            poses_n, points_n, q_n, a_n, _ = dist_schur.dist_joint_ba_solve(
                s.cam, djp, mesh, iters=iters, cg_iters=cg_iters,
                gamma=float(self.cfg.line.gamma))
            s.kf_pose[:K] = np.asarray(poses_n)[:K]
            s.pt_pos[pids] = np.asarray(points_n)[: len(pids)]
            self._write_back_lines(lids, q_n, a_n)
            return
        lp = self._gather_line_problem()
        if lp is None:
            solved, chi2 = ba.ba_solve(s.cam, problem, iters=iters,
                                       dense=False, cg_iters=cg_iters)
            s.kf_pose[:K] = np.asarray(solved.poses)[:K]
            s.pt_pos[pids] = np.asarray(solved.points)[: len(pids)]
            return
        # joint pose+point+line global problem (Optimizer.cc:321-560 with
        # AddLineMinimalGlobal :149/:473): 4x4 line blocks marginalized in
        # the same reduced camera system as the 3x3 point blocks
        from ..optim import lines_ba
        lids, q, alpha, line_valid, lobs = lp
        joint = lines_ba.JointProblem(
            base=problem, q=q, alpha=alpha, line_valid=line_valid, lobs=lobs)
        solved, _, _ = lines_ba.joint_ba_solve_cg(
            s.cam, joint, iters=iters, cg_iters=cg_iters,
            gamma=float(self.cfg.line.gamma))
        s.kf_pose[:K] = np.asarray(solved.base.poses)[:K]
        s.pt_pos[pids] = np.asarray(solved.base.points)[: len(pids)]
        self._write_back_lines(lids, solved.q, solved.alpha)

    def _gather_line_problem(self, min_obs: int = 4):
        """Assemble the >=4-obs line half of the global problem
        (>=4-obs gate: Optimizer.cc:473). Returns
        (lids, q, alpha, line_valid, lobs) padded to static buckets, or
        None when the map has no qualifying line observations."""
        s = self.store
        K = s.n_kf
        lids = np.nonzero(s.ln_valid[: s.n_ln] & (s.ln_nobs[: s.n_ln]
                                                  >= min_obs))[0]
        if len(lids) == 0:
            return None
        from ..geometry import lines as glines
        from ..optim import lines_ba

        kf_idx, det_idx = np.nonzero(s.kf_ln_ids[:K] >= 0)
        obs_l = s.kf_ln_ids[kf_idx, det_idx]
        keep = np.isin(obs_l, lids)
        kf_idx, det_idx, obs_l = kf_idx[keep], det_idx[keep], obs_l[keep]
        if len(kf_idx) == 0:
            return None
        ln_lut = np.full(s.max_ln, -1, np.int32)
        ln_lut[lids] = np.arange(len(lids), dtype=np.int32)
        LC = ((len(lids) + 511) // 512) * 512
        O = len(kf_idx)
        OC = ((O + 2047) // 2048) * 2048

        def pad(a, fill=0):
            out = np.full((OC,) + a.shape[1:], fill, a.dtype)
            out[:O] = a
            return out

        lobs = lines_ba.LineBAObs(
            k=jnp.asarray(pad(kf_idx.astype(np.int32))),
            l=jnp.asarray(pad(ln_lut[obs_l])),
            x1l=jnp.asarray(pad(s.kf_ln_p1[kf_idx, det_idx])),
            x2l=jnp.asarray(pad(s.kf_ln_p2[kf_idx, det_idx])),
            x1r=jnp.asarray(pad(s.kf_ln_p1r[kf_idx, det_idx])),
            x2r=jnp.asarray(pad(s.kf_ln_p2r[kf_idx, det_idx])),
            octave=jnp.asarray(pad(s.kf_ln_oct[kf_idx, det_idx])),
            has_r=jnp.asarray(pad(s.kf_ln_has_r[kf_idx, det_idx])),
            valid=jnp.asarray(np.arange(OC) < O),
        )
        x0 = np.zeros((LC, 3), np.float32)
        dr = np.tile(np.array([1, 0, 0], np.float32), (LC, 1))
        x0[: len(lids)] = s.ln_x0[lids]
        dr[: len(lids)] = s.ln_dir[lids]
        q, alpha = glines.minimal_from_x0dir(jnp.asarray(x0), jnp.asarray(dr))
        line_valid = np.zeros(LC, bool)
        line_valid[: len(lids)] = True
        return lids, q, alpha, jnp.asarray(line_valid), lobs

    def _write_back_lines(self, lids, q2, a2):
        """Decode solved minimal line states back into the map store,
        skipping non-finite solves."""
        from ..geometry import lines as glines
        s = self.store
        X0n, dn = glines.x0dir_from_minimal(q2, a2)
        X0n = np.asarray(X0n)[: len(lids)]
        dn = np.asarray(dn)[: len(lids)]
        fin = np.isfinite(X0n).all(-1) & np.isfinite(dn).all(-1)
        s.ln_x0[lids[fin]] = X0n[fin]
        s.ln_dir[lids[fin]] = dn[fin]

    def _global_line_refine(self):
        """Fixed-pose per-line GN (lines_ba.refine_lines_fixed_poses).
        No longer on any default path — both the single-device and the
        distributed global BA now solve lines JOINTLY with poses/points
        (joint_ba_solve_cg / dist_schur.dist_joint_ba_solve); kept as a
        cheap standalone refinement utility."""
        lp = self._gather_line_problem()
        if lp is None:
            return
        from ..optim import lines_ba
        s = self.store
        K = s.n_kf
        lids, q, alpha, line_valid, lobs = lp
        KC = ((K + 63) // 64) * 64
        poses = np.tile(np.eye(4, dtype=np.float32), (KC, 1, 1))
        poses[:K] = s.kf_pose[:K]
        base = ba.BAProblem(
            poses=jnp.asarray(poses),
            points=jnp.zeros((8, 3), jnp.float32),
            pose_fixed=jnp.ones(KC, bool),
            point_valid=jnp.zeros(8, bool),
            obs=ba.BAObs(
                k=jnp.zeros(8, jnp.int32), p=jnp.zeros(8, jnp.int32),
                uvr=jnp.zeros((8, 3), jnp.float32),
                inv_sigma2=jnp.ones(8, jnp.float32),
                is_stereo=jnp.zeros(8, bool),
                valid=jnp.zeros(8, bool)))
        joint = lines_ba.JointProblem(
            base=base, q=q, alpha=alpha, line_valid=line_valid, lobs=lobs)
        q2, a2 = lines_ba.refine_lines_fixed_poses(
            s.cam, joint, gamma=float(self.cfg.line.gamma))
        self._write_back_lines(lids, q2, a2)


def warmup_loop_programs(cam) -> None:
    """Pre-compile the rare-path device programs (Sim3 RANSAC + GN refine,
    Sim(3) pose graph, global-BA CG) on their first-bucket shapes. A loop
    closure fires once every few thousand frames; without this the first
    event pays the full compile latency (tens of seconds per program) in
    the middle of tracking. All three paths pad to static
    buckets, so one dummy call per bucket compiles the exact executable the
    real event reuses. Vocabulary-independent."""
    rng = np.random.default_rng(0)
    # --- Sim3 RANSAC + refine (cap 512, _compute_sim3) ---
    cap = 512
    X = jnp.asarray(rng.uniform(1.0, 5.0, (cap, 3)).astype(np.float32))
    uv = jnp.asarray(rng.uniform(50, 200, (cap, 2)).astype(np.float32))
    s2 = jnp.ones(cap, jnp.float32)
    vmask = jnp.asarray(np.arange(cap) < 64)
    key = jax.random.PRNGKey(7)
    (R, t, sc), inl, _ = sim3_solver.ransac_sim3(
        cam, cam, X, X, uv, uv, s2, s2, vmask, key)
    sim3_solver.refine_sim3(cam, cam, (R, t, sc), X, X, uv, uv,
                            s2, s2, inl & vmask)
    # --- Sim(3) pose graph (kcap 64, ecap 256, _correct) ---
    kcap, ecap = 64, 256
    eye3 = np.tile(np.eye(3, dtype=np.float32), (kcap, 1, 1))
    m_eye = np.tile(np.eye(3, dtype=np.float32), (ecap, 1, 1))
    e_i = np.arange(ecap, dtype=np.int32) % kcap
    e_j = (e_i + 1) % kcap
    fixed = np.zeros(kcap, bool)
    fixed[0] = True
    g = pose_graph.PoseGraph(
        R=jnp.asarray(eye3),
        t=jnp.asarray(rng.normal(0, 0.01, (kcap, 3)).astype(np.float32)),
        s=jnp.ones(kcap, jnp.float32),
        fixed=jnp.asarray(fixed),
        e_i=jnp.asarray(e_i), e_j=jnp.asarray(e_j),
        m_R=jnp.asarray(m_eye),
        m_t=jnp.zeros((ecap, 3), jnp.float32),
        m_s=jnp.ones(ecap, jnp.float32),
        e_valid=jnp.asarray(np.arange(ecap) < 16),
    )
    pose_graph.optimize_pose_graph(g, iters=15, cg_iters=48)
    # --- global BA, CG path (kcap 64, pcap 2048, ocap 4096) ---
    kb, pb, ob = 64, 2048, 4096
    poses = np.tile(np.eye(4, dtype=np.float32), (kb, 1, 1))
    pts = np.stack([rng.uniform(-5, 5, pb), rng.uniform(-3, 3, pb),
                    rng.uniform(8, 20, pb)], -1).astype(np.float32)
    k_o = rng.integers(0, 4, ob).astype(np.int32)
    p_o = rng.integers(0, pb, ob).astype(np.int32)
    z = pts[p_o, 2]
    uvr = np.stack([cam.fx * pts[p_o, 0] / z + cam.cx,
                    cam.fy * pts[p_o, 1] / z + cam.cy,
                    cam.fx * pts[p_o, 0] / z + cam.cx - cam.bf / z],
                   -1).astype(np.float32)
    fixedk = np.zeros(kb, bool)
    fixedk[0] = True
    fixedk[4:] = True
    problem = ba.BAProblem(
        poses=jnp.asarray(poses), points=jnp.asarray(pts),
        pose_fixed=jnp.asarray(fixedk),
        point_valid=jnp.ones(pb, bool),
        obs=ba.BAObs(
            k=jnp.asarray(k_o), p=jnp.asarray(p_o),
            uvr=jnp.asarray(uvr), inv_sigma2=jnp.ones(ob, jnp.float32),
            is_stereo=jnp.ones(ob, bool),
            valid=jnp.asarray(np.arange(ob) < ob // 2)))
    solved, _ = ba.ba_solve(cam, problem, iters=10, dense=False,
                            cg_iters=64)
    np.asarray(solved.poses)  # wait for the device to finish
