"""Deterministic local mapping: the keyframe-rate map update + local BA.

Replaces the LocalMapping thread (`LocalMapping::Run`,
reference src/LocalMapping.cc:48-113) with a staged, deterministic step:

    recent-point culling (MapPointCulling, LocalMapping.cc:171-206)
    -> epipolar triangulation + duplicate fusion (one device program,
       CreateNewMapPoints + SearchInNeighbors, LocalMapping.cc:208-554)
    -> local bundle adjustment (Optimizer::LocalBundleAdjustment,
       Optimizer.cc:936-1388) as batched GN + dense Schur on device
    -> outlier observation erasure (Optimizer.cc:1336-1358)
    -> keyframe culling (KeyFrameCulling, LocalMapping.cc:633-759).

The stages are exposed as dispatch/absorb pairs so the pipelined tracker can
overlap the device work with subsequent frame tracking — the deterministic
analogue of the reference's LocalMapping-thread/tracking-thread overlap:

    finalize(f):   keyframe created -> dispatch triangulate+fuse
    finalize(f+1): absorb tri/fuse -> dispatch BA (+ on-device view build)
    finalize(f+2): absorb BA -> keyframe culling

`process_keyframe` runs all stages back-to-back for the synchronous path.

The BA window mirrors the reference: the new KF + its covisible KFs are free,
every other KF observing a window point is a fixed anchor
(Optimizer.cc:988-1018). All problem arrays are padded to fixed capacities so
the solver compiles once per size bucket.

Divergence from the reference's stage ordering (documented): fusion is
dispatched TOGETHER with triangulation, so it projects this keyframe's
pre-triangulation points into the neighbors; points created by the
triangulation stage reach fusion at the NEXT keyframe. The reference fuses
after triangulating (LocalMapping.cc:58-80); batching both into one dispatch
removes a full host->device round trip from the keyframe path.
"""
from __future__ import annotations

from collections import deque
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig
from ..optim import ba
from ..slammap.map_store import MapStore
from . import mapper_fast
from .kf_cache import KfCache


class LocalMapper:
    def __init__(
        self,
        store: MapStore,
        cfg: SlamConfig,
        k_local: int = 16,
        k_fixed: int = 8,
        p_cap: int = 8192,
        o_cap: int = 24576,
        l_cap: int = 512,
        lo_cap: int = 2048,
        ba_interval: int = 1,
        cache: KfCache | None = None,
    ):
        self.store = store
        self.cfg = cfg
        self.cam = store.cam
        self.k_local = k_local
        self.k_fixed = k_fixed
        self.k_cap = k_local + k_fixed
        self.p_cap = p_cap
        self.o_cap = o_cap
        # size buckets: the BA grid costs O(K * P_cap) per iteration, and a
        # young map fills a fraction of the max capacity. Pad to the smallest
        # bucket that fits, growing monotonically (each bucket compiles its
        # program once; shrinking would flip-flop recompiles).
        self.p_buckets = [b for b in (1024, 2048, 4096, 8192) if b <= p_cap]
        if not self.p_buckets or self.p_buckets[-1] != p_cap:
            self.p_buckets.append(p_cap)
        self._p_bucket = self.p_buckets[0]
        self.l_cap = l_cap
        self.lo_cap = lo_cap
        self.ba_interval = ba_interval
        self.enable_lines = cfg.line.enabled
        self._recent: deque = deque(maxlen=3)  # (kf_id, created point ids)
        self._inv_sigma2 = np.power(
            1.0 / store.cfg.scale ** 2, np.arange(store.cfg.n_levels)
        ).astype(np.float32)
        self._lut_dev = jnp.asarray(self._inv_sigma2)
        self._kf_count = 0
        # invoked with the culled KF id (tracker wires KeyFrameDatabase.erase
        # here — the reference erases at KeyFrame.cc:567)
        self.on_kf_culled = None
        self.stage_times: dict[str, float] = {}
        # device-resident keyframe feature cache shared with the tracker
        self.cache = cache or KfCache(n_slots=32, n_kp=store.n_kp)
        self._stage_layout = mapper_fast.KfStageLayout(n_kp=store.n_kp)
        # pending staged work (pipelined mode): KF stages queue (<= 2 deep)
        # so back-to-back keyframes inside one finalize burst never force a
        # blocking absorb of a fetch dispatched milliseconds earlier
        self._pending_kfq: deque = deque()
        self._pending_ba: dict | None = None
        # (view, view_pids) future produced by the most recent dispatch_ba
        # — consumed by the tracker's _adopt_view when it resolves
        self.pending_view_fut = None
        # set by absorb_kf_stage when the KF's BoW words rode the flat
        # readback: (kf_id, words np.ndarray); consumed by the tracker
        self.absorbed_words: tuple | None = None
        # frames since the BA dispatch — absorb only after the device had
        # >= 2 frame-steps of time to finish the BA program, so the absorb
        # get pays flat transfer latency instead of compute wait
        self._ba_age = 0
        self._kf_age = 0
        # frame id of the last keyframe whose local BA actually ran (the
        # load-adaptive cadence gate in _prepare_ba); the tracker enables
        # the gate in pipelined mode only
        self._last_ba_frame = -(1 << 30)
        self.adaptive_ba_cadence = False
        # when set, the tracking view always pads to this capacity (the
        # batched multi-sequence driver needs one shape across sequences)
        self.fixed_tv_cap: int | None = None
        # IO worker: device_put / dispatch / device_get of the staged KF
        # programs run on this thread so their transfer latencies overlap
        # the tracker's frame dispatches instead of blocking them (kept
        # until a synchronous schedule is measured on the GPU, ROADMAP
        # Design). Determinism is untouched: the worker only moves
        # buffers; every store mutation stays on the caller's thread.
        from concurrent.futures import ThreadPoolExecutor
        # 2 workers: a stage's readback must not delay the next BA upload
        # behind it — absorb order stays host-side so task ordering across
        # workers is immaterial
        self._io = ThreadPoolExecutor(max_workers=2,
                                      thread_name_prefix="mapper_io")

    # ------------------------------------------------------------------

    def close(self):
        """Stop the IO worker (called when the tracker replaces this mapper
        on a full reset — an in-flight io_task may still read the shared
        cache, so cancel before the caller clears it)."""
        self._io.shutdown(wait=False, cancel_futures=True)

    def cache_frame(self, kf_id: int, feats) -> int:
        """Register a new keyframe's device feature arrays in the cache."""
        return self.cache.put(kf_id, feats)

    def ensure_cached(self, kf_ids) -> np.ndarray:
        """Slots for the given keyframes, uploading any evicted ones from
        the host store (one packed transfer per missing KF — rare: only old
        keyframes re-entering a window after a loop)."""
        slots = self.cache.slots_of(kf_ids)
        for i, kf in enumerate(kf_ids):
            if slots[i] < 0:
                self.stage_times["n_cache_miss"] = self.stage_times.get(
                    "n_cache_miss", 0) + 1
                buf = jax.device_put(mapper_fast.pack_kf_feats(
                    self.store, int(kf)))
                feats = mapper_fast.unpack_kf_feats(buf, self.store.n_kp)
                slots[i] = self.cache.put(int(kf), feats)
        return slots

    def warmup(self, voc=None):
        """Pre-compile the KF-stage and BA programs at every point-capacity
        bucket (the bucket grows as the map grows; each growth would
        otherwise pay a ~15-25 s remote compile mid-sequence). `voc` warms
        the fused kf-stage+BoW-descent variant the loop-closing path uses."""
        s = self.store
        N = s.n_kp
        lay = self._stage_layout
        buf = jax.device_put(np.zeros(lay.offsets["_total"], np.int32))
        out = mapper_fast.kf_stage_cached(
            self.cam, lay, self.cache.arrays, buf, self._lut_dev,
            s.cfg.n_levels, s.cfg.scale)
        jax.block_until_ready(out)
        jax.block_until_ready(mapper_fast.concat_flat(out[0], out[1]))
        if voc is not None:
            ch, nd, nw = voc.device_arrays()
            jax.block_until_ready(mapper_fast.kf_stage_words_flat(
                self.cam, lay, self.cache.arrays, buf, self._lut_dev,
                ch, nd, nw, s.cfg.n_levels, s.cfg.scale, voc.L)[0])
        voc_args = (voc.device_arrays() if voc is not None
                    else (jnp.zeros(1, jnp.int32),) * 3)
        voc_L = voc.L if voc is not None else 0
        n_st = lay.offsets["_total"]
        if self.enable_lines:
            self._warmup_lines(lay, n_st, voc_args, voc_L)
            return
        for P in self.p_buckets:
            for tv in self._tv_caps(P):
                bl = mapper_fast.BaLayout(
                    k_cap=self.k_cap, p_bkt=P, o_bkt=self._o_bkt(P),
                    tv_cap=tv, n_kp=N)
                bbuf = jax.device_put(
                    np.zeros(bl.offsets["_total"], np.int32))
                out = mapper_fast.ba_view_cached(
                    self.cam, bl, self.cache.arrays, bbuf, self._lut_dev)
                jax.block_until_ready(out)
                # fused stage+BA variant (pipelined keyframe path)
                cbuf = jax.device_put(
                    np.zeros(n_st + bl.offsets["_total"], np.int32))
                out = mapper_fast.fused_kf_ba_flat(
                    self.cam, lay, bl, self.cache.arrays, cbuf,
                    self._lut_dev, *voc_args, s.cfg.n_levels, s.cfg.scale,
                    voc_L)
                jax.block_until_ready(out[0])

    def _tv_caps(self, P: int):
        """Tracking-view capacities the BA program will actually run at —
        the pinned capacity when set (pipelined mode), else the dynamic
        buckets. Warming the wrong tv left a ~1.7 s joint-BA compile in the
        middle of the lines bench."""
        if self.fixed_tv_cap:
            return (self.fixed_tv_cap,)
        return (2048,) if P <= 2048 else (2048, 4096)

    def _warmup_lines(self, slay=None, n_st=0, voc_args=None, voc_L=0):
        """Packed joint point+line BA warmup per bucket (+ the fused
        stage+joint-BA variant when the stage layout is provided)."""
        for P in self.p_buckets:
            for tv in self._tv_caps(P):
                bl = mapper_fast.BaLayout(
                    k_cap=self.k_cap, p_bkt=P, o_bkt=self._o_bkt(P),
                    tv_cap=tv, n_kp=self.store.n_kp)
                jlay = mapper_fast.JointBaLayout(
                    base=bl, l_cap=self.l_cap, lo_cap=self.lo_cap)
                bbuf = jax.device_put(
                    np.zeros(jlay.offsets["_total"], np.int32))
                out = mapper_fast.joint_ba_view_cached(
                    self.cam, jlay, self.cache.arrays, bbuf, self._lut_dev,
                    float(self.cfg.line.gamma))
                jax.block_until_ready(out)
                if slay is not None:
                    cbuf = jax.device_put(np.zeros(
                        n_st + jlay.offsets["_total"], np.int32))
                    out = mapper_fast.fused_kf_joint_ba_flat(
                        self.cam, slay, jlay, self.cache.arrays, cbuf,
                        self._lut_dev, *voc_args,
                        self.store.cfg.n_levels, self.store.cfg.scale,
                        voc_L, float(self.cfg.line.gamma))
                    jax.block_until_ready(out[0])

    def note_created(self, kf_id: int, pt_ids: np.ndarray):
        self._recent.append((kf_id, np.asarray(pt_ids)))

    # ------------------------------------------------------------------
    # staged API (used by the pipelined tracker; process_keyframe chains
    # them for the synchronous path)
    # ------------------------------------------------------------------

    @property
    def busy(self) -> bool:
        return bool(self._pending_kfq) or self._pending_ba is not None

    @property
    def _pending_kf(self):
        return self._pending_kfq[0] if self._pending_kfq else None

    def step_pending(self):
        """Advance the staged pipeline by one absorb+dispatch (called once
        per finalized frame by the pipelined tracker). Returns the new
        device MapPointView when the BA stage was dispatched, else None.

        Absorbs are OPPORTUNISTIC: a stage is absorbed when its fetch has
        actually landed (fut.done()), or at an age cap as a forcing bound,
        so the main thread does not stall on a readback right after
        dispatch."""
        if self._pending_kfq:
            # absorb only when the fetch has LANDED — finalizes come
            # in window bursts, so an age counter degenerates to a blocking
            # wait; a not-yet-landed stage simply rides to the next burst
            # (the queue-overflow path in dispatch_kf_stage forces it)
            if self._pending_kfq[0]["flat_fut"].done():
                kf_id = self._pending_kfq[0]["kf_id"]
                rec = self.absorb_kf_stage()
                if not rec.get("fused"):
                    return self.dispatch_ba(kf_id)
            return None
        if self._pending_ba is not None:
            self._ba_age += 1
            if self._ba_age >= 2 and self._pending_ba["result_fut"].done():
                self.absorb_ba()
        return None

    def flush(self):
        """Absorb all pending staged work synchronously."""
        while self._pending_kfq:
            kf_id = self._pending_kfq[0]["kf_id"]
            rec = self.absorb_kf_stage()
            if not rec.get("fused"):
                self.dispatch_ba(kf_id)
        if self._pending_ba is not None:
            self.absorb_ba()

    def process_keyframe(self, kf_id: int):
        """The LocalMapping::Run loop body, synchronous
        (LocalMapping.cc:53-113 order). Returns the post-BA device
        MapPointView for the tracker (or None when BA was skipped)."""
        self.flush()
        self.dispatch_kf_stage(kf_id)
        self.absorb_kf_stage()
        view_fut = self.dispatch_ba(kf_id)
        if self._pending_ba is not None:
            self.absorb_ba()
        if view_fut is None:
            return None
        self.pending_view_fut = None   # consumed synchronously here
        return view_fut.result()

    # ------------------------------------------------------------------

    def dispatch_kf_stage(self, kf_id: int, voc=None, fuse_ba: bool = False):
        """Host-side culling + one packed upload + one device dispatch for
        triangulation & fusion. `voc` optionally passes the loop closer's
        Vocabulary: the KF's BoW tree descent then runs INSIDE the same
        program over the cached device descriptors and its word ids ride
        the SAME flat readback instead of a separate descent dispatch and
        a separate device_get."""
        import time as _time
        t0 = _time.perf_counter()
        while len(self._pending_kfq) >= 2:
            # queue overflow (3 keyframes inside ~one readback window —
            # rare): force-absorb the oldest stage
            prev = self._pending_kfq[0]["kf_id"]
            rec_prev = self.absorb_kf_stage()
            if not rec_prev.get("fused"):
                self.dispatch_ba(prev)
        s = self.store
        s.refresh_obs_counts()
        t_refresh = _time.perf_counter()
        self.stage_times["dk_refresh"] = self.stage_times.get(
            "dk_refresh", 0.0) + (t_refresh - t0)
        # newly created points of this KF enter the culling probation window
        row = s.kf_pt_ids[kf_id]
        new_ids = row[(row >= 0) & (s.pt_first_kf[row.clip(0)] == kf_id)]
        self.note_created(kf_id, new_ids)
        # probation culling over the recent window (LocalMapping.cc:171-206)
        # — ONE batched call (ages are per point, so the windows merge)
        recent = [ids for _, ids in self._recent if len(ids)]
        if recent:
            s.cull_points(np.concatenate(recent), current_kf=kf_id)
        t_cull = _time.perf_counter()
        self.stage_times["dk_cull"] = self.stage_times.get(
            "dk_cull", 0.0) + (t_cull - t0)
        lay = self._stage_layout
        covis, _ = s.covisible_kfs(kf_id, min_shared=15, top=10)
        t_c1 = _time.perf_counter()
        self.stage_times["dk_c1"] = self.stage_times.get(
            "dk_c1", 0.0) + (t_c1 - t_cull)
        nbs_tri = [int(nb) for nb in covis[:lay.b1 - 1]]
        n_tri = len(nbs_tri)
        nbs_tri = nbs_tri + [kf_id] * (lay.b1 - 1 - n_tri)
        nbs_fuse = [int(nb) for nb in covis[:lay.b2]]
        n_fuse = len(nbs_fuse)
        nbs_fuse = nbs_fuse + [kf_id] * (lay.b2 - n_fuse)
        t_c2 = _time.perf_counter()
        self.stage_times["dk_c2"] = self.stage_times.get(
            "dk_c2", 0.0) + (t_c2 - t_c1)
        slots = self.ensure_cached([kf_id] + nbs_tri + nbs_fuse)
        t_cov = _time.perf_counter()
        self.stage_times["dk_covis"] = self.stage_times.get(
            "dk_covis", 0.0) + (t_cov - t_cull)
        # fuse view: this KF's current points (SearchInNeighbors projects
        # the new KF's points into the neighbors, LocalMapping.cc:470-504)
        my = row[row >= 0]
        pids = np.unique(my)
        pids = pids[s.pt_valid[pids]][-lay.view_cap:]
        buf_np = mapper_fast.pack_kf_stage(
            lay, s, kf_id, slots[:lay.b1], nbs_tri,
            slots[lay.b1:], nbs_fuse, n_tri, n_fuse, pids)
        self.stage_times["dk_pack"] = self.stage_times.get(
            "dk_pack", 0.0) + (_time.perf_counter() - t_cov)
        # fused mode: this keyframe's windowed BA shares the stage upload
        # and readback (2 transfers per KF instead of 4; the BA sees the
        # keyframe-creation store state — see mapper_fast.fused_kf_ba_flat)
        ba_prep = self._prepare_ba(kf_id) if fuse_ba else None
        if ba_prep is not None:
            from concurrent.futures import Future
            view_fut: Future = Future()
            cat_np = np.concatenate([buf_np, ba_prep["buf"]])
            vp = ba_prep["vp"]
            voc_args = (voc.device_arrays() if voc is not None
                        else (jnp.zeros(1, jnp.int32),) * 3)
            voc_L = voc.L if voc is not None else 0

            def io_task():
                try:
                    buf = jax.device_put(cat_np)
                    if ba_prep["kind"] == "joint":
                        flat_d, tri_bufs, fuse_bufs, view = \
                            mapper_fast.fused_kf_joint_ba_flat(
                                self.cam, lay, ba_prep["lay"],
                                self.cache.arrays, buf, self._lut_dev,
                                *voc_args, s.cfg.n_levels, s.cfg.scale,
                                voc_L, float(self.cfg.line.gamma))
                    else:
                        flat_d, tri_bufs, fuse_bufs, view = \
                            mapper_fast.fused_kf_ba_flat(
                                self.cam, lay, ba_prep["lay"],
                                self.cache.arrays, buf, self._lut_dev,
                                *voc_args, s.cfg.n_levels, s.cfg.scale,
                                voc_L)
                except BaseException as e:
                    # resolve the view future even on dispatch failure —
                    # a forever-pending future would silently stop the
                    # tracker from ever adopting a post-BA view again (and
                    # deadlock the synchronous path's .result())
                    view_fut.set_exception(e)
                    raise
                view_fut.set_result((view, vp))
                flat = np.asarray(flat_d)
                return flat, tuple(tri_bufs.shape), tuple(fuse_bufs.shape)

            self.pending_view_fut = view_fut
            self._ba_age = 0
        else:
            def io_task():
                buf = jax.device_put(buf_np)
                if voc is not None:
                    ch, nd, nw = voc.device_arrays()
                    flat_d, tri_bufs, fuse_bufs = \
                        mapper_fast.kf_stage_words_flat(
                            self.cam, lay, self.cache.arrays, buf,
                            self._lut_dev, ch, nd, nw,
                            s.cfg.n_levels, s.cfg.scale, voc.L)
                    flat = np.asarray(flat_d)
                else:
                    tri_bufs, fuse_bufs = mapper_fast.kf_stage_cached(
                        self.cam, lay, self.cache.arrays, buf, self._lut_dev,
                        s.cfg.n_levels, s.cfg.scale)
                    flat = np.asarray(mapper_fast.concat_flat(tri_bufs,
                                                              fuse_bufs))
                return flat, tuple(tri_bufs.shape), tuple(fuse_bufs.shape)

        self._kf_age = 0
        self._pending_kfq.append(dict(
            kf_id=kf_id, flat_fut=self._io.submit(io_task),
            has_words=voc is not None, fused=fuse_ba, ba=ba_prep,
            nbs_tri=nbs_tri[:n_tri], nbs_fuse=nbs_fuse[:n_fuse],
            pid_arr=np.concatenate(
                [pids, np.full(lay.view_cap - len(pids), -1, np.int64)])))
        self.stage_times["dispatch_kf"] = self.stage_times.get(
            "dispatch_kf", 0.0) + (_time.perf_counter() - t0)

    def absorb_kf_stage(self):
        """Write back triangulation + fusion results (host bookkeeping)."""
        import time as _time
        t0 = _time.perf_counter()
        rec = self._pending_kfq.popleft()
        s = self.store
        kf_id = rec["kf_id"]
        lay = self._stage_layout
        # ONE flat readback for tri+fuse(+BoW words), prefetched by the IO
        # worker while the tracker kept dispatching frames
        flat, tri_shape, fuse_shape = rec["flat_fut"].result()
        n_tri = int(np.prod(tri_shape))
        n_fuse = int(np.prod(fuse_shape))
        tri_bufs = flat[:n_tri].reshape(tri_shape)
        fuse_flat = flat[n_tri:n_tri + n_fuse].reshape(fuse_shape)
        o = n_tri + n_fuse
        if rec["has_words"]:
            self.absorbed_words = (kf_id, flat[o:o + s.n_kp])
            o += s.n_kp
        else:
            self.absorbed_words = None
        # fused dispatch: the windowed BA result rides the same flat
        # readback (one RPC for the whole keyframe path)
        rec["ba_tail"] = flat[o:] if rec.get("ba") is not None else None
        created: list[int] = []
        claimed = np.zeros(s.n_kp, bool)
        from . import mapping_ops
        for bi, nb in enumerate(rec["nbs_tri"]):
            n_good, match, X = mapping_ops.unpack_triangulate_np(
                tri_bufs[bi], s.n_kp)
            sel = np.nonzero((match >= 0) & ~claimed)[0]
            if len(sel) == 0:
                continue
            sel = sel[: s.room_for_points(len(sel))]
            if len(sel) == 0:
                break
            ids = s.create_points(kf_id, sel, X[sel])
            s.kf_pt_ids[nb, match[sel]] = ids  # second observation
            s.mark_obs_dirty()
            claimed[sel] = True
            created.extend(ids.tolist())
        if created:
            self.note_created(kf_id, np.asarray(created, np.int32))
            s.refresh_obs_counts()
        t1 = _time.perf_counter()
        # fusion writeback (ORBmatcher::Fuse semantics)
        fuse_bufs = fuse_flat
        pid_arr = rec["pid_arr"]
        self._fuse_writeback(fuse_bufs, pid_arr, rec["nbs_fuse"],
                             lay.view_cap)
        st = self.stage_times
        st["triangulate"] = st.get("triangulate", 0.0) + (t1 - t0)
        st["fuse"] = st.get("fuse", 0.0) + (_time.perf_counter() - t1)
        st["n"] = st.get("n", 0) + 1
        if rec.get("ba") is not None:
            self._writeback_ba(rec["ba"], rec["ba_tail"])
        return rec

    def _fuse_writeback(self, fuse_bufs, pid_arr, nbs_fuse, cap):
        """Fusion writeback, vectorized per neighbor (instead of a per-hit
        Python loop with a full (K, n_kp) scan per merge)."""
        s = self.store
        merges: list[tuple[int, int]] = []
        for bi, nb in enumerate(nbs_fuse):
            kp2pt = fuse_bufs[bi][cap:]
            hit = np.nonzero(kp2pt >= 0)[0]
            if len(hit) == 0:
                continue
            p = pid_arr[kp2pt[hit]].astype(np.int64)
            good = (p >= 0) & s.pt_valid[np.maximum(p, 0)]
            hit, p = hit[good], p[good]
            row = s.kf_pt_ids[nb]
            q = row[hit]
            # MapPoint::IsInKeyFrame guard (MapPoint.cc:396): never give one
            # KF two features on the same point — duplicate (k, p) obs rows
            # make the dense BA scatter nondeterministic
            new_m = q < 0
            if new_m.any():
                cand_hit, cand_p = hit[new_m], p[new_m]
                ok = ~np.isin(cand_p, row[row >= 0])
                first = np.zeros(len(cand_p), bool)
                first[np.unique(cand_p, return_index=True)[1]] = True
                ok &= first
                if ok.any():
                    row[cand_hit[ok]] = cand_p[ok]
                    s.mark_obs_dirty()
            mer = (q >= 0) & (q != p) & s.pt_valid[np.maximum(q, 0)]
            for pp, qq in zip(p[mer], q[mer]):
                # merge: most-observed point survives (MapPoint::Replace)
                keep, drop = ((int(pp), int(qq))
                              if s.pt_nobs[pp] >= s.pt_nobs[qq]
                              else (int(qq), int(pp)))
                merges.append((keep, drop))
        merged = False
        if merges:
            # batched apply: resolve keep-chains in a dict, then one
            # vectorized remap pass over the live observation table
            target: dict[int, int] = {}
            for keep, drop in merges:
                while keep in target:
                    keep = target[keep]
                if keep != drop and drop not in target:
                    target[drop] = keep
            if target:
                def _resolve(x: int) -> int:
                    while x in target:
                        x = target[x]
                    return x
                drops = np.fromiter(target.keys(), np.int64, len(target))
                keeps = np.fromiter((_resolve(v) for v in target.values()),
                                    np.int64, len(target))
                order = np.argsort(drops)
                drops, keeps = drops[order], keeps[order]
                s.pt_valid[drops] = False
                K = s.n_kf
                ids = s.kf_pt_ids[:K]
                m = np.isin(ids, drops)
                ids[m] = keeps[np.searchsorted(drops, ids[m])]
                s.mark_obs_dirty()
                merged = True
        if merged:
            # a merge can leave some KF observing `keep` on two features;
            # keep the first slot per (KF, point) row-wise
            K = s.n_kf
            ids = s.kf_pt_ids[:K]
            srt = np.sort(np.where(ids >= 0, ids, np.iinfo(np.int32).max),
                          axis=1)
            has_dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0) \
                & (srt[:, 1:] != np.iinfo(np.int32).max)
            for k in np.nonzero(has_dup.any(axis=1))[0]:
                row = ids[k]
                seen: set[int] = set()
                for i in np.nonzero(row >= 0)[0]:
                    v = int(row[i])
                    if v in seen:
                        row[i] = -1
                    else:
                        seen.add(v)
            s.mark_obs_dirty()
        s.refresh_obs_counts()

    # ------------------------------------------------------------------

    def _o_bkt(self, p_bkt: int) -> int:
        return max(self.o_cap // self.p_cap, 1) * p_bkt

    def _ba_inflight(self) -> bool:
        """Is a windowed BA (legacy or fused into a KF stage) still riding
        the IO pool?"""
        if self._pending_ba is not None \
                and not self._pending_ba["result_fut"].done():
            return True
        return any(r.get("ba") is not None and not r["flat_fut"].done()
                   for r in self._pending_kfq)

    def _prepare_ba(self, kf_id: int):
        """Eligibility check + problem build + packed upload buffer for this
        keyframe's windowed BA. Returns None when BA is skipped (previous
        BA still in flight — the deterministic analogue of the reference's
        mbAbortBA interrupt, LocalMapping.cc:InterruptBA / Optimizer.cc:473
        pbStopFlag, which aborts local BA whenever a new KF arrives
        mid-optimization; blocking here would put the previous BA's
        readback on the keyframe's critical path). Culling of
        skipped keyframes happens here; for dispatched BAs it runs in the
        writeback."""
        import time as _time
        t0 = _time.perf_counter()
        if self._ba_inflight():
            self.stage_times["ba_skip_dropped"] = self.stage_times.get(
                "ba_skip_dropped", 0) + 1
            self.cull_keyframes(kf_id)
            return None
        if self._pending_ba is not None:
            # results already landed — absorb before overwriting
            self.absorb_ba()
        t1 = _time.perf_counter()
        self.stage_times["dba_wait"] = self.stage_times.get(
            "dba_wait", 0.0) + (t1 - t0)
        self._kf_count += 1
        s = self.store
        if s.n_kf < 2 or self._kf_count % self.ba_interval != 0:
            self.cull_keyframes(kf_id)
            return None
        # load-adaptive BA cadence (the completion side of the reference's
        # mbAbortBA semantics), PIPELINED mode only: local BA takes ~2-3
        # frame-times of device queue, so under burst keyframe cadence the
        # reference would be interrupted by the next KF before finishing
        # (LocalMapping.cc:InterruptBA) — run BA only when >= 2 min-gap
        # frames of motion separate it from the previous completed BA. At
        # relaxed cadence (KF gap > twice the damper) every keyframe gets
        # its BA, exactly like an uninterrupted reference mapper. The
        # synchronous path never skips: a sequential reference run has an
        # idle mapper at every keyframe.
        fid = int(s.kf_frame_id[kf_id])
        if self.adaptive_ba_cadence and s.n_kf > 4 \
                and fid - self._last_ba_frame < 6:
            self.stage_times["ba_cadence_skipped"] = self.stage_times.get(
                "ba_cadence_skipped", 0) + 1
            self.cull_keyframes(kf_id)
            return None
        self._last_ba_frame = fid
        meta = self._build_problem_np(kf_id)
        if meta is None:
            self.cull_keyframes(kf_id)
            return None
        # tracking view selection (UpdateLocalPoints, Tracking.cc:1677-1724)
        view_pids = self._select_view_pids(kf_id)
        meta["tv_cap"] = self.fixed_tv_cap or (
            2048 if len(view_pids) <= 2048 else 4096)
        if len(view_pids) > meta["tv_cap"]:
            self.stage_times["view_dropped"] = self.stage_times.get(
                "view_dropped", 0) + (len(view_pids) - meta["tv_cap"])
            view_pids = view_pids[-meta["tv_cap"]:]  # newest = visible
        pt_lut = np.full(s.max_pt, -1, np.int32)
        pt_lut[meta["pts"]] = np.arange(len(meta["pts"]), dtype=np.int32)
        view_p_idx = pt_lut[view_pids]
        slots = self.ensure_cached(meta["window"])
        lay = mapper_fast.BaLayout(
            k_cap=self.k_cap, p_bkt=meta["p_bkt"],
            o_bkt=self._o_bkt(meta["p_bkt"]), tv_cap=meta["tv_cap"],
            n_kp=s.n_kp)
        vp = np.concatenate([
            view_pids,
            np.full(meta["tv_cap"] - len(view_pids), -1, np.int64)])
        if self.enable_lines:
            lmeta = self._line_obs_np(meta["window"])
            jlay = mapper_fast.JointBaLayout(
                base=lay, l_cap=self.l_cap, lo_cap=self.lo_cap)
            buf_np = mapper_fast.pack_joint_ba(
                jlay, s, meta["window"], slots, meta["n_free"], meta["pts"],
                meta["okf"], meta["ofe"], meta["p_idx"], view_pids,
                view_p_idx, lmeta["lids"], lmeta["wk"], lmeta["wd"],
                lmeta["l_idx"])
            prep = dict(kind="joint", lay=jlay, buf=buf_np, meta=meta,
                        lmeta=lmeta, vp=vp, kf_id=kf_id)
        else:
            buf_np = mapper_fast.pack_ba(
                lay, s, meta["window"], slots, meta["n_free"], meta["pts"],
                meta["okf"], meta["ofe"], meta["p_idx"], view_pids,
                view_p_idx)
            prep = dict(kind="points", lay=lay, buf=buf_np, meta=meta,
                        vp=vp, kf_id=kf_id)
        self.stage_times["dba_build"] = self.stage_times.get(
            "dba_build", 0.0) + (_time.perf_counter() - t1)
        return prep

    def dispatch_ba(self, kf_id: int):
        """Build + dispatch the windowed BA with on-device view assembly
        (legacy standalone path: the pipelined tracker fuses BA into the
        keyframe stage dispatch instead — dispatch_kf_stage(fuse_ba=True)).
        Returns the (view, view_pids) future for the tracker, or None when
        BA is skipped this keyframe."""
        import time as _time
        t0 = _time.perf_counter()
        prep = self._prepare_ba(kf_id)
        if prep is None:
            return None
        from concurrent.futures import Future
        view_fut: Future = Future()
        buf_np, vp = prep["buf"], prep["vp"]

        if prep["kind"] == "joint":
            jlay = prep["lay"]

            def io_task():
                try:
                    buf = jax.device_put(buf_np)
                    result, view = mapper_fast.joint_ba_view_cached(
                        self.cam, jlay, self.cache.arrays, buf,
                        self._lut_dev, float(self.cfg.line.gamma))
                except BaseException as e:
                    view_fut.set_exception(e)   # see fused io_task
                    raise
                view_fut.set_result((view, vp))
                return np.asarray(result)
        else:
            lay = prep["lay"]

            def io_task():
                try:
                    buf = jax.device_put(buf_np)
                    result, view = mapper_fast.ba_view_cached(
                        self.cam, lay, self.cache.arrays, buf,
                        self._lut_dev)
                except BaseException as e:
                    view_fut.set_exception(e)
                    raise
                view_fut.set_result((view, vp))
                return np.asarray(result)

        self._pending_ba = dict(
            kind=prep["kind"], result_fut=self._io.submit(io_task),
            meta=prep["meta"], lmeta=prep.get("lmeta"), kf_id=kf_id)
        # the upload + program dispatch ride the IO thread; the
        # tracker adopts the post-BA view when the future resolves
        # (_adopt_view) and keeps tracking on the previous view meanwhile
        self.pending_view_fut = view_fut
        self._ba_age = 0
        self.stage_times["dispatch_ba"] = self.stage_times.get(
            "dispatch_ba", 0.0) + (_time.perf_counter() - t0)
        return view_fut

    def absorb_ba(self):
        """Fetch the standalone BA result and write it back."""
        rec, self._pending_ba = self._pending_ba, None
        self._writeback_ba(rec, rec["result_fut"].result())

    def _writeback_ba(self, rec, buf):
        """BA writeback + outlier erasure + keyframe culling."""
        import time as _time
        t0 = _time.perf_counter()
        s = self.store
        meta = rec["meta"]
        K, P = self.k_cap, meta["p_bkt"]
        if rec.get("kind") == "joint":
            o = 0
            poses = buf[o:o + 16 * K].view(np.float32).reshape(K, 4, 4)
            o += 16 * K
            points = buf[o:o + 3 * P].view(np.float32).reshape(P, 3)
            o += 3 * P
            LC = self.l_cap
            X0n = buf[o:o + 3 * LC].view(np.float32).reshape(LC, 3)
            o += 3 * LC
            dn = buf[o:o + 3 * LC].view(np.float32).reshape(LC, 3)
            o += 3 * LC
            O_cap = self._o_bkt(P)
            nw = mapper_fast.n_bit_words(O_cap)
            keep = mapper_fast.unpack_bits_np(buf[o:o + nw], O_cap); o += nw
            keep_l = mapper_fast.unpack_bits_np(
                buf[o:o + mapper_fast.n_bit_words(self.lo_cap)], self.lo_cap)
            lmeta = rec["lmeta"]
            lids = lmeta["lids"]
            if len(lids):
                X0w = X0n[: len(lids)]
                dw = dn[: len(lids)]
                fin = np.isfinite(X0w).all(-1) & np.isfinite(dw).all(-1)
                s.ln_x0[lids[fin]] = X0w[fin]
                s.ln_dir[lids[fin]] = dw[fin]
            Ol = lmeta["n_lobs"]
            badl = ~keep_l[:Ol]
            if badl.any():
                s.kf_ln_ids[meta["window"][lmeta["wk"][badl]],
                            lmeta["wd"][badl]] = -1
        else:
            o = 0
            poses = buf[o:o + 16 * K].view(np.float32).reshape(K, 4, 4)
            o += 16 * K
            points = buf[o:o + 3 * P].view(np.float32).reshape(P, 3)
            o += 3 * P
            O_cap = self._o_bkt(P)
            keep = mapper_fast.unpack_bits_np(
                buf[o:o + mapper_fast.n_bit_words(O_cap)], O_cap)
        window, n_free, pts = meta["window"], meta["n_free"], meta["pts"]
        s.kf_pose[window[:n_free]] = poses[:n_free]
        s.pt_pos[pts] = points[: len(pts)]
        # erase outlier observations (Optimizer.cc:1336-1358)
        O = meta["n_obs"]
        bad = ~keep[:O]
        if bad.any():
            s.kf_pt_ids[meta["kf_abs"][bad], meta["ofe"][bad]] = -1
            s.mark_obs_dirty()
            # points that lost every observation die
            dead_cand = np.unique(pts[np.unique(meta["p_idx"][:O][bad])])
            if len(dead_cand):
                s.refresh_obs_counts()
                s.remove_points(dead_cand[s.pt_nobs[dead_cand] == 0])
        self.cull_keyframes(rec["kf_id"])
        self.stage_times["ba"] = self.stage_times.get("ba", 0.0) \
            + (_time.perf_counter() - t0)

    def _select_view_pids(self, kf_id: int) -> np.ndarray:
        """Local-map point ids for the tracker's view (the points of the
        reference KF's covisibility neighborhood,
        UpdateLocalKeyFrames/UpdateLocalPoints, Tracking.cc:1726-1835).

        Returned sorted by ASCENDING covisibility weight (observation count
        within the neighborhood, newest id breaking ties), so the caller's
        fixed-capacity tail truncation `[-cap:]` drops the WEAKEST points —
        a policy that drops by id recency would, on a revisit, throw
        away exactly the old, well-observed landmarks the reference's local
        map keeps."""
        s = self.store
        covis, _ = s.covisible_kfs(kf_id, min_shared=15, top=19)
        local_kfs = np.concatenate([[kf_id], covis]).astype(np.int32)
        raw = s.kf_pt_ids[local_kfs]
        raw = raw[raw >= 0]
        counts = np.bincount(raw, minlength=s.max_pt)
        ids = np.unique(raw)
        ids = ids[s.pt_valid[ids]]
        order = np.argsort(counts[ids], kind="stable")
        return ids[order]

    # ------------------------------------------------------------------

    def cull_keyframes(self, kf_id: int):
        """Redundant-KF culling (KeyFrameCulling, LocalMapping.cc:633-759):
        a covisible KF dies when >= 90% of its tracked points are seen by
        at least 3 other keyframes. Culled KFs keep their pose (trajectory
        replay + pose-graph chains still reference it) but stop contributing
        observations."""
        s = self.store
        covis, _ = s.covisible_kfs(kf_id, min_shared=15)
        if len(covis) == 0:
            return
        K = s.n_kf
        # distinct-KF observer count per point (bincount ~10x np.add.at)
        ids = s.kf_pt_ids[:K]
        sel = ids >= 0
        obs_kf = np.bincount(ids[sel], minlength=s.max_pt).astype(np.int32)
        for k in covis:
            k = int(k)
            if k == 0 or k == kf_id or not s.kf_valid[k]:
                continue
            pts = s.kf_pt_ids[k]
            pts = pts[pts >= 0]
            if len(pts) == 0:
                continue
            redundant = (obs_kf[pts] >= 4).mean()  # 3 others + itself
            if redundant >= 0.9:
                obs_kf[pts] -= 1
                s.kf_pt_ids[k] = -1
                s.kf_ln_ids[k] = -1  # divergence from D7: detach line obs too
                s.kf_valid[k] = False
                s.reparent_children(k)
                s.mark_obs_dirty()
                if self.on_kf_culled is not None:
                    self.on_kf_culled(k)
        s.refresh_obs_counts()

    # ------------------------------------------------------------------

    def _window_and_obs(self, kf_id: int):
        """Shared window/observation-table assembly (numpy)."""
        s = self.store
        local, fixed, local_pts = s.local_window(kf_id, max_kf=self.k_local)
        if len(fixed) > self.k_fixed:
            # keep the fixed KFs anchoring the most window observations
            counts = (np.isin(s.kf_pt_ids[fixed], local_pts)
                      & (s.kf_pt_ids[fixed] >= 0)).sum(axis=1)
            fixed = fixed[np.argsort(-counts)[: self.k_fixed]]
        if len(fixed) == 0 and len(local) > 1:
            # gauge: freeze the oldest local KF (reference fixes KF 0 via the
            # id==0 check, Optimizer.cc:1015-1017)
            fixed = local[-1:]
            local = local[:-1]
        window = np.concatenate([local, fixed]).astype(np.int32)
        n_free = len(local)
        obs_ratio = max(self.o_cap // self.p_cap, 1)
        if len(local_pts) > self.p_buckets[-1]:
            self.stage_times["ba_pts_dropped"] = self.stage_times.get(
                "ba_pts_dropped", 0) + (len(local_pts) - self.p_buckets[-1])
            local_pts = local_pts[-self.p_buckets[-1]:]
        pts = local_pts.astype(np.int32)

        # observation table: every (window KF, feature) slot pointing into
        # pts. Fixed anchors FIRST: if the table ever exceeds the bucket, the
        # tail truncation drops free-window observations, never the anchors
        # tying the window to the global map.
        pt_lut = np.full(s.max_pt, -1, np.int32)
        pt_lut[pts] = np.arange(len(pts), dtype=np.int32)
        okf, ofe = [], []
        order = list(range(n_free, len(window))) + list(range(n_free))
        for wi in order:
            k = window[wi]
            ids_k = s.kf_pt_ids[k]
            sel = np.nonzero(pt_lut[ids_k.clip(0)] >= 0)[0]
            sel = sel[ids_k[sel] >= 0]
            # dedup: one observation per (KF, point) — fuse merges can leave
            # a KF with two features on the same point, and duplicate (k, p)
            # rows make the dense scatter in ba._densify_obs nondeterministic
            _, first = np.unique(pt_lut[ids_k[sel]], return_index=True)
            sel = sel[np.sort(first)]
            okf.append(np.full(len(sel), wi, np.int32))
            ofe.append(sel.astype(np.int32))
        okf = np.concatenate(okf)
        ofe = np.concatenate(ofe)
        # grow the bucket until both the point count and the observation
        # count fit (the obs cap scales with the bucket at the configured
        # o_cap/p_cap ratio; the constructor caps stay authoritative)
        while self._p_bucket < self.p_buckets[-1] and (
                len(pts) > self._p_bucket
                or len(okf) > obs_ratio * self._p_bucket):
            self._p_bucket = self.p_buckets[
                self.p_buckets.index(self._p_bucket) + 1]
        p_bkt = self._p_bucket
        o_bkt = obs_ratio * p_bkt
        if len(pts) > p_bkt:
            pts = pts[-p_bkt:]
            pt_lut[:] = -1
            pt_lut[pts] = np.arange(len(pts), dtype=np.int32)
            keep = pt_lut[s.kf_pt_ids[window[okf], ofe]] >= 0
            okf, ofe = okf[keep], ofe[keep]
        if len(okf) > o_bkt:
            self.stage_times["ba_obs_dropped"] = self.stage_times.get(
                "ba_obs_dropped", 0) + (len(okf) - o_bkt)
            okf, ofe = okf[: o_bkt], ofe[: o_bkt]
        kf_abs = window[okf]
        p_idx = pt_lut[s.kf_pt_ids[kf_abs, ofe]]
        return dict(window=window, n_free=n_free, pts=pts, p_bkt=p_bkt,
                    okf=okf, ofe=ofe, kf_abs=kf_abs, p_idx=p_idx,
                    n_obs=len(okf))

    def _build_problem_np(self, kf_id: int):
        meta = self._window_and_obs(kf_id)
        if meta["n_obs"] < 30 or len(meta["pts"]) == 0:
            return None
        return meta

    def _line_obs_np(self, window):
        """Line half of the BA window (numpy): lines seen by window KFs +
        observation index triples for the packed joint buffer."""
        s = self.store
        lids = np.unique(s.kf_ln_ids[window])
        lids = lids[lids >= 0]
        lids = lids[s.ln_valid[lids]][-self.l_cap:]
        L = len(lids)
        ln_lut = np.full(s.max_ln, -1, np.int32)
        ln_lut[lids] = np.arange(L, dtype=np.int32)
        mask = (s.kf_ln_ids[window] >= 0) \
            & (ln_lut[s.kf_ln_ids[window].clip(0)] >= 0)
        wk, wd = np.nonzero(mask)
        # dedup (KF, line) pairs — duplicate rows break the dense scatter
        # in lines_ba the same way duplicate point obs break ba
        _, first = np.unique(
            wk.astype(np.int64) * s.max_ln + s.kf_ln_ids[window[wk], wd],
            return_index=True)
        wk, wd = wk[np.sort(first)], wd[np.sort(first)]
        l_idx = ln_lut[s.kf_ln_ids[window[wk], wd]]
        O = min(len(wk), self.lo_cap)
        if len(wk) > O:
            self.stage_times["ln_obs_dropped"] = self.stage_times.get(
                "ln_obs_dropped", 0) + (len(wk) - O)
        wk, wd, l_idx = wk[:O], wd[:O], l_idx[:O]
        return dict(lids=lids, wk=wk, wd=wd, l_idx=l_idx, n_lobs=O)
