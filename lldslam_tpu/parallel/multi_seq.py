"""Batched multi-sequence evaluation: one device program tracks S sequences.

The BASELINE.json configs include "full combined KITTI+EuRoC 13-sequence
benchmark sweep, batched multi-sequence on one host" (the reference runs its
per-sequence CLI loop — Examples/Stereo/stereo_kitti.cc:96-142 — once per
sequence; here the per-frame compute of S sequences shares ONE XLA program).

Every per-frame kernel in this framework is fixed-shape, so the fused
tracking step and the frame build vmap over a leading sequence axis:
S stereo pairs in, S packed results out. `MultiSequenceDriver` owns S
per-sequence `StereoTracker`s (each with its own `MapStore`); per frame it

1. stages ONE (S, 2, H, W) uint8 upload,
2. runs the vmapped frame build + vmapped fused track step,
3. reads ONE packed (S, L) buffer back, and
4. finalizes each sequence through its own tracker's host bookkeeping
   (`StereoTracker._track_finalize`) — keyframes, local mapping, loop
   closing all stay per-sequence and run at keyframe rate.

Sequences whose tracker is NOT_INITIALIZED or LOST fall back to their own
synchronous step for that frame (initialization and relocalization are
per-sequence control flow); everything in state OK rides the batch.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SlamConfig
from ..frontend.frame import build_frame_pair
from ..geometry.camera import StereoCamera
from ..ops.orb import OrbConfig
from ..pipeline.tracker import StereoTracker, TrackMetrics, TrackState, \
    _track_step


@partial(jax.jit, static_argnames=("cam", "cfg"))
def batched_build_frame(pairs, cam: StereoCamera, cfg: OrbConfig):
    """(S, 2, H, W) stacked pairs -> vmapped FrameData batch."""
    return jax.vmap(lambda p: build_frame_pair(p, cam, cfg))(pairs)


@partial(jax.jit, static_argnames=("cam", "n_levels", "scale", "min_mm",
                                   "close_depth"))
def batched_track_step(cam, T_pred, last_feats, last_ptpos, last_haspt,
                       last_ismap, last_prov, cur, depth, view,
                       inv_sigma2_lut, n_levels, scale, min_mm, close_depth):
    """vmap of the fused per-frame tracking step over the sequence axis.
    All array arguments carry a leading S dim; returns the same packed
    outputs batched."""
    def one(T_pred, last_feats, last_ptpos, last_haspt, last_ismap,
            last_prov, cur, depth, view):
        return _track_step(cam, T_pred, last_feats, last_ptpos, last_haspt,
                           last_ismap, last_prov, cur, depth, view,
                           inv_sigma2_lut, n_levels, scale, min_mm,
                           close_depth)
    return jax.vmap(one)(T_pred, last_feats, last_ptpos, last_haspt,
                         last_ismap, last_prov, cur, depth, view)


class MultiSequenceDriver:
    """S per-sequence trackers stepped in lock-step with one device program
    per frame (view capacity pinned so all sequences share one shape)."""

    def __init__(self, cfg: SlamConfig, n_seq: int,
                 enable_loops: bool = False, view_cap: int = 2048):
        self.cfg = cfg
        self.n_seq = n_seq
        self.cam = cfg.camera.stereo_camera()
        self.trackers = []
        for _ in range(n_seq):
            tr = StereoTracker(cfg, enable_loops=enable_loops)
            tr.mapper.fixed_tv_cap = view_cap
            self.trackers.append(tr)

    def _batchable(self) -> list[int]:
        return [i for i, tr in enumerate(self.trackers)
                if tr.state == TrackState.OK and not tr.enable_lines]

    def process(self, pairs: list, timestamps: list[float]):
        """Track one frame of every sequence. pairs: list of S (imL, imR)
        uint8 arrays (None to skip a finished sequence). Returns list of
        (T_cw, TrackMetrics) per sequence."""
        import time as _time
        S = self.n_seq
        live = [i for i in range(S) if pairs[i] is not None]
        batch = [i for i in self._batchable() if i in live]
        solo = [i for i in live if i not in batch]
        results: list = [None] * S

        fds = {}
        if batch:
            stack = np.stack([np.stack(pairs[i]).astype(np.uint8)
                              for i in batch])
            pair_dev = jax.device_put(stack)
            fdb = batched_build_frame(pair_dev, self.cam,
                                      self.trackers[0].orb)
            t0 = _time.perf_counter()
            trs = [self.trackers[i] for i in batch]
            T_pred = jnp.asarray(np.stack([
                (tr.velocity @ tr.T_cw).astype(np.float32) for tr in trs]))
            stackf = lambda get: jax.tree.map(
                lambda *xs: jnp.stack(xs), *[get(tr) for tr in trs])
            last_feats = stackf(lambda tr: tr._last_feats)
            last_ptpos = stackf(lambda tr: tr._last_ptpos)
            last_haspt = stackf(lambda tr: tr._last_haspt)
            last_ismap = stackf(lambda tr: tr._last_ismap)
            last_prov = stackf(lambda tr: tr._last_prov)
            view = stackf(lambda tr: tr._view)
            tr0 = trs[0]
            out = batched_track_step(
                self.cam, T_pred, last_feats, last_ptpos, last_haspt,
                last_ismap, last_prov, fdb.feats, fdb.depth, view,
                tr0._inv_sigma2_lut,
                tr0.orb.n_levels, tr0.orb.scale,
                self.cfg.tracking.min_motion_matches,
                float(self.cfg.close_depth))
            t_disp = _time.perf_counter() - t0
            packed = np.asarray(out[0])
            for bi, i in enumerate(batch):
                tr = self.trackers[i]
                tr.frame_id += 1
                m = TrackMetrics(frame_id=tr.frame_id)
                m.t_dispatch = t_disp / len(batch)
                fd_i = jax.tree.map(lambda a: a[bi], fdb)
                t1 = _time.perf_counter()
                tr._track_finalize(fd_i, packed[bi], out[1][bi], out[2][bi],
                                   timestamps[i], m, tr.frame_id,
                                   dev_ismap=out[3][bi],
                                   dev_prov=out[4][0][bi],
                                   dev_final=out[5][bi])
                m.t_step = _time.perf_counter() - t1 - m.t_kf
                tr._finish_metrics(m)
                results[i] = (tr.T_cw.copy(), m)

        for i in solo:
            tr = self.trackers[i]
            results[i] = tr.process(pairs[i][0], pairs[i][1], timestamps[i])
        return results

    def trajectories(self):
        return [tr.trajectory() for tr in self.trackers]


# ---------------------------------------------------------------------------
# pipelined batched driver
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cam", "n_levels", "scale", "min_mm",
                                   "close_depth", "min_gap", "max_gap"))
def batched_chained_step(cam, T, vel, last_feats, last_ptpos, last_haspt,
                         cur, depth, view, inv_sigma2_lut, last_ismap,
                         last_prov, since, scal, ring, slot,
                         n_levels, scale, min_mm, close_depth,
                         min_gap, max_gap):
    """vmap of the PIPELINED chained step (incl. the on-device keyframe
    decision) over the sequence axis; the (S, W, L) ring accumulates every
    sequence's packed rows so ONE window fetch serves the whole batch."""
    from ..pipeline.tracker import _track_step_chained

    def one(T, vel, lf, lp, lh, cur, depth, view, lim, lpr, since, scal,
            ring_s):
        return _track_step_chained(
            cam, T, vel, lf, lp, lh, cur, depth, view, inv_sigma2_lut,
            lim, lpr, since, scal, ring_s, slot, n_levels, scale, min_mm,
            close_depth, min_gap, max_gap)

    return jax.vmap(one, in_axes=(0,) * 13)(
        T, vel, last_feats, last_ptpos, last_haspt, cur, depth, view,
        last_ismap, last_prov, since, scal, ring)


@partial(jax.jit, static_argnames=())
def _stack_rows(*rows):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *rows)


@jax.jit
def _set_row(stacked, i, row):
    return jax.tree.map(lambda s, r: s.at[i].set(r), stacked, row)


@jax.jit
def _batched_pack_frames(fdb):
    from ..frontend.frame import pack_frame
    return jax.vmap(pack_frame)(fdb)


class PipelinedMultiSequenceDriver(MultiSequenceDriver):
    """MultiSequenceDriver with the solo tracker's full pipelined schedule
    batched: stacked device chain state (pose/velocity/temporal/provisional
    /KF-decision per sequence), ONE vmapped chained program per frame, a
    shared (S, W, L) readback ring fetched once per window on an IO thread,
    and per-sequence host finalize through StereoTracker._finalize_rec
    (keyframes, staged mapping, provisional resolution — everything the
    solo path does). Sequences that fall out of state OK drop to their own
    (pipelined) tracker and rejoin the batch when healthy.

    The alternative, re-stacking state and reading results back EVERY
    frame, puts a readback per frame on the critical path (kept until the
    sweep is measured on the GPU, ROADMAP Design)."""

    def __init__(self, cfg: SlamConfig, n_seq: int,
                 enable_loops: bool = False, view_cap: int = 2048,
                 readback_window: int = 4):
        self.cfg = cfg
        self.n_seq = n_seq
        self.cam = cfg.camera.stereo_camera()
        self.W = readback_window
        self.trackers = []
        for _ in range(n_seq):
            tr = StereoTracker(cfg, enable_loops=enable_loops, pipeline=True)
            tr.mapper.fixed_tv_cap = view_cap
            self.trackers.append(tr)
        from concurrent.futures import ThreadPoolExecutor
        self._io = ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix="mseq_io")
        self._members: list[int] = []
        self._stk = None          # stacked chain state dict
        self._slot = 0
        self._pending: list[dict] = []       # per-frame window records
        self._inflight = None                # (recs, fut)

    # -- batch membership ------------------------------------------------

    def _flush_batch(self, keep=()):
        """Finalize all in-flight batched frames. Members NOT in `keep`
        leave the batch and must reseed their own device chain; kept
        members stay batch-eligible (re-stacked from the LAST DISPATCHED
        chain state below — their per-tracker _last_* fields are only
        maintained on weak/resync paths, so without the write-back a kept
        member would re-enter the next stack matching against a frames-old
        'last frame' while _last_kp2pt reflects the newest finalized frame,
        silently mis-resolving kp2last into wrong global point ids)."""
        if self._inflight is not None:
            self._absorb(block=True)
        while self._pending:
            recs, self._pending = self._pending, []
            batch = np.asarray(recs[-1]["ring_after"])
            self._finalize_window(recs, batch)
        stk, members = self._stk, self._members
        if stk is not None:
            for bi, i in enumerate(members):
                if i in keep and not self.trackers[i]._resync:
                    # a member that went weak DURING the flush re-tracked
                    # synchronously and restored its own chain state —
                    # never clobber that with the poisoned batch rows
                    tr = self.trackers[i]
                    tr._last_feats = jax.tree.map(lambda a: a[bi],
                                                  stk["last_feats"])
                    tr._last_ptpos = stk["last_ptpos"][bi]
                    tr._last_haspt = stk["last_haspt"][bi]
                    tr._last_ismap = stk["last_ismap"][bi]
                    tr._last_prov = stk["last_prov"][bi]
        self._slot = 0
        self._stk = None
        self.n_rebuilds = getattr(self, "n_rebuilds", 0) + 1
        for i in self._members:
            if i not in keep:
                self.trackers[i]._resync = True
        self._members = []

    def _build_stack(self, members):
        trs = [self.trackers[i] for i in members]
        for tr in trs:
            tr.flush()
            if tr._last_prov is None:
                tr._last_prov = jnp.full(tr.store.n_kp, -1, jnp.int32)
            if tr._last_ismap is None:
                tr._last_ismap = tr._last_haspt
        T = jnp.asarray(np.stack([tr.T_cw for tr in trs]))
        vel = jnp.asarray(np.stack([tr.velocity for tr in trs]))
        since = jnp.asarray(np.array(
            [max(0, tr.frame_id - tr.last_kf_frame) for tr in trs],
            np.int32))
        scal = jnp.asarray(np.stack(
            [np.float32([tr._ref_matches, tr._kappa]) for tr in trs]))
        stk = dict(
            T=T, vel=vel, since=since, scal=scal,
            last_feats=_stack_rows(*[tr._last_feats for tr in trs]),
            last_ptpos=jnp.stack([tr._last_ptpos for tr in trs]),
            last_haspt=jnp.stack([tr._last_haspt for tr in trs]),
            last_ismap=jnp.stack([tr._last_ismap for tr in trs]),
            last_prov=jnp.stack([tr._last_prov for tr in trs]),
            view=_stack_rows(*[tr._view for tr in trs]),
        )
        tr0 = trs[0]
        n_kp = tr0.store.n_kp
        L = (23 + 3 * n_kp + -(-n_kp // 32)
             + -(-len(tr0._view_pid) // 32))
        self._row_len = L
        # flat per-sequence ring (W*L,) to match the solo chained step's
        # flat-ring layout (no snapshot slots here: n_snap=0 — keyframe
        # snapshots fetch from the batched frame build instead)
        stk["ring"] = jnp.zeros((len(trs), self.W * L), jnp.int32)
        self._stk = stk
        self._slot = 0
        self._members = list(members)
        self._view_ids = [id(tr._view) for tr in trs]

    # -- per-frame -------------------------------------------------------

    def process(self, pairs: list, timestamps: list[float],
                pair_devs: list | None = None):
        """Track one frame of every sequence (batched + pipelined). Pass
        `pair_devs` (pre-staged (2, H, W) device arrays) to keep host
        ingest out of the loop, as the solo staged bench does."""
        import time as _time
        tt = self.step_times = getattr(self, "step_times", {})
        _t = _time.perf_counter()
        S = self.n_seq
        self._absorb(block=False)
        tt["absorb0"] = tt.get("absorb0", 0.0) + (_time.perf_counter() - _t)
        _t = _time.perf_counter()
        live = [i for i in range(S)
                if (pairs[i] is not None
                    or (pair_devs is not None and pair_devs[i] is not None))]
        batchable = [i for i in live
                     if self.trackers[i].state == TrackState.OK
                     and not self.trackers[i].enable_lines
                     and not self.trackers[i]._resync]
        if batchable != self._members:
            self._flush_batch(keep=set(batchable))
            # re-check health after the flush (finalizes may demote)
            batchable = [i for i in live
                         if self.trackers[i].state == TrackState.OK
                         and not self.trackers[i].enable_lines
                         and not self.trackers[i]._resync]
            if len(batchable) >= 2:
                self._build_stack(batchable)
        tt["rebuild"] = tt.get("rebuild", 0.0) + (_time.perf_counter() - _t)
        results: list = [None] * S
        in_batch = set(self._members)

        if self._members:
            self._step_batch(pairs, timestamps, pair_devs, results)

        _t = _time.perf_counter()
        for i in live:
            if i not in in_batch:
                tr = self.trackers[i]
                if pair_devs is not None and pair_devs[i] is not None:
                    results[i] = tr.process(None, None, timestamps[i],
                                            pair_dev=pair_devs[i])
                else:
                    results[i] = tr.process(pairs[i][0], pairs[i][1],
                                            timestamps[i])
        tt["solo"] = tt.get("solo", 0.0) + (_time.perf_counter() - _t)
        return results

    def _step_batch(self, pairs, timestamps, pair_devs, results):
        import time as _time
        tt = self.step_times = getattr(self, "step_times", {})

        def _mk(key, t0):
            now = _time.perf_counter()
            tt[key] = tt.get(key, 0.0) + (now - t0)
            return now

        t0 = _time.perf_counter()
        members = self._members
        trs = [self.trackers[i] for i in members]
        stk = self._stk
        if pair_devs is not None:
            stack_dev = jnp.stack([pair_devs[i] for i in members])
        else:
            stack_dev = jax.device_put(np.stack(
                [np.stack(pairs[i]).astype(np.uint8) for i in members]))
        t0 = _mk("stage", t0)
        fdb = batched_build_frame(stack_dev, self.cam, trs[0].orb)
        snap_b = _batched_pack_frames(fdb)
        t0 = _mk("build", t0)
        # adopt pending per-tracker updates (post-KF view / ref matches)
        for bi, tr in enumerate(trs):
            tr._adopt_view()
            if id(tr._view) != self._view_ids[bi]:
                stk["view"] = _set_row(stk["view"], bi, tr._view)
                self._view_ids[bi] = id(tr._view)
            if tr._refm_fut is not None and tr._refm_fut.done():
                stk["scal"] = stk["scal"].at[bi].set(tr._refm_fut.result())
                tr._refm_fut = None
        t0 = _mk("adopt", t0)
        cfgT = self.cfg.tracking
        out = batched_chained_step(
            self.cam, stk["T"], stk["vel"], stk["last_feats"],
            stk["last_ptpos"], stk["last_haspt"], fdb.feats, fdb.depth,
            stk["view"], trs[0]._inv_sigma2_lut, stk["last_ismap"],
            stk["last_prov"], stk["since"], stk["scal"], stk["ring"],
            self._slot, trs[0].orb.n_levels, trs[0].orb.scale,
            cfgT.min_motion_matches, float(self.cfg.close_depth),
            max(cfgT.min_frames_between_kf, 3),
            cfgT.max_frames_between_kf)
        prev = dict(last_feats=stk["last_feats"],
                    last_ptpos=stk["last_ptpos"],
                    last_haspt=stk["last_haspt"],
                    last_ismap=stk["last_ismap"],
                    last_prov=stk["last_prov"])
        (packed, stk["last_ptpos"], stk["last_haspt"], stk["last_ismap"],
         stk["last_prov"], stk["T"], stk["vel"], stk["ring"], stk["since"],
         stk["scal"], _) = out
        t0 = _mk("dispatch", t0)
        stk["last_feats"] = fdb.feats
        rec = dict(members=list(members), fdb=fdb, snap_b=snap_b, prev=prev,
                   ring_slot=self._slot, ring_after=stk["ring"],
                   ts=[timestamps[i] for i in members],
                   fids=[], view_pids=[tr._view_pid for tr in trs])
        for tr in trs:
            tr.frame_id += 1
            rec["fids"].append(tr.frame_id)
        self._slot += 1
        self._pending.append(rec)
        for bi, i in enumerate(members):
            results[i] = (None, None)  # finalized at window absorb
        if self._slot >= self.W:
            self._slot = 0
            recs, self._pending = self._pending, []
            if self._inflight is not None:
                self._absorb(block=True)
            fut = self._io.submit(np.asarray, recs[-1]["ring_after"])
            self._inflight = (recs, fut)
        _mk("tail", t0)

    # -- absorb ----------------------------------------------------------

    def _absorb(self, block: bool):
        if self._inflight is None:
            return
        recs, fut = self._inflight
        if not block and not fut.done():
            return
        batch = fut.result()
        self._inflight = None
        self._finalize_window(recs, batch)

    def _finalize_window(self, recs, batch):
        import time as _time
        _t0 = _time.perf_counter()
        from ..pipeline.tracker import TrackMetrics
        for rec in recs:
            for bi, i in enumerate(rec["members"]):
                tr = self.trackers[i]
                L = self._row_len
                row = batch[bi, rec["ring_slot"] * L:
                            (rec["ring_slot"] + 1) * L]
                m = TrackMetrics(frame_id=rec["fids"][bi])
                fdb, snap_b, prev = rec["fdb"], rec["snap_b"], rec["prev"]
                # fd/prev slices resolve LAZILY — they are only touched on
                # keyframe / weak-frame paths, and S x ~14 eager device
                # slices per frame would dominate the finalize loop
                srec = dict(
                    fd=(lambda bi=bi, fdb=fdb:
                        jax.tree.map(lambda a: a[bi], fdb)),
                    out=None, ts=rec["ts"][bi], m=m, fid=rec["fids"][bi],
                    view_pid=rec["view_pids"][bi],
                    view_cap=len(rec["view_pids"][bi]),
                    prev=(lambda bi=bi, prev=prev: (
                        jax.tree.map(lambda a: a[bi], prev["last_feats"]),
                        prev["last_ptpos"][bi], prev["last_haspt"][bi],
                        prev["last_ismap"][bi], prev["last_prov"][bi])),
                    ring_slot=rec["ring_slot"])
                if row[22] > 0 and tr._tr_io is not None:
                    from ..frontend.frame import unpack_frame_np
                    n_kp = tr.store.n_kp
                    srec["snap_fut"] = tr._tr_io.submit(
                        lambda d=snap_b[bi], n=n_kp: unpack_frame_np(
                            np.asarray(d), n))
                tr._finalize_rec(srec, packed_np=row)
        tt = self.step_times = getattr(self, "step_times", {})
        tt["finalize"] = tt.get("finalize", 0.0) \
            + (_time.perf_counter() - _t0)

    def flush(self):
        self._flush_batch()
        for tr in self.trackers:
            tr.flush()
