"""Pipelined (finalize-lag-1) tracker: equivalence with the synchronous
schedule on a synthetic stereo sequence."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lldslam_tpu.config import CameraConfig, SlamConfig, TrackingConfig
from lldslam_tpu.ops.orb import OrbConfig
from lldslam_tpu.system import System


def _cfg():
    cam_cfg = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=120.0,
                           bf=200.0, fps=10.0, width=640, height=240)
    return SlamConfig(camera=cam_cfg, orb=OrbConfig(n_features=600),
                      tracking=TrackingConfig(min_init_points=80))


def _frames(cfg, n):
    from bench import _make_sequence
    return _make_sequence(cfg.camera.stereo_camera(), n, n_per_m=25.0, seed=3)


@pytest.mark.slow
def test_pipelined_matches_sync():
    cfg = _cfg()
    frames = _frames(cfg, 18)

    sync = System(cfg, enable_loops=False)
    for i, (l, r) in enumerate(frames):
        sync.track_stereo(l, r, timestamp=i * 0.1)
    ts_s, T_s = sync.tracker.trajectory()

    pipe = System(cfg, enable_loops=False, pipeline=True)
    rets = []
    for i, (l, r) in enumerate(frames):
        rets.append(pipe.track_stereo(l, r, timestamp=i * 0.1))
    pipe.flush()
    ts_p, T_p = pipe.tracker.trajectory()

    assert len(ts_p) == len(ts_s) == len(frames)
    assert pipe.tracker.state.name == "OK"
    # identical camera path up to the pipelined map-update schedule (lag-N
    # finalize + staged mapper: triangulation/fusion and BA land a window
    # behind the keyframe — the deterministic analogue of the reference's
    # LocalMapping thread lag). With the default W=8 readback window the
    # map updates land up to ~8 frames late, so positions agree to ~0.35 m
    # on a ~17 m path (the KEYFRAME SCHEDULE itself is identical: the
    # on-device decision reproduces NeedNewKeyFrame at frame rate)
    kfs_s = [m.frame_id for m in sync.tracker.metrics if m.new_kf]
    kfs_p = [m.frame_id for m in pipe.tracker.metrics if m.new_kf]
    assert kfs_p == kfs_s, (kfs_p, kfs_s)
    dp = np.linalg.norm(T_p[:, :3, 3] - T_s[:, :3, 3], axis=-1)
    assert dp.max() < 0.35, dp.max()
    # every frame got finalized exactly once, in order
    fids = [m.frame_id for m in pipe.tracker.metrics]
    assert fids == sorted(fids)
    # frame 0 initializes synchronously; afterwards finalizes happen in
    # ring bursts of W frames — the non-None returns carry strictly
    # increasing frame ids and at least one burst fired before the flush
    assert rets[0][1] is not None and rets[0][1].frame_id == 0
    burst_ids = [r[1].frame_id for r in rets[1:] if r[1] is not None]
    assert burst_ids == sorted(burst_ids)
    assert len(burst_ids) >= 1
    W = pipe.tracker.readback_window
    assert any(r[1] is None for r in rets[1:]) or W == 1


@pytest.mark.slow
def test_pipelined_blackout_recovers():
    """A black frame mid-sequence must drop to LOST via the resync path and
    recover without crashing or corrupting the trajectory length."""
    cfg = _cfg()
    frames = _frames(cfg, 14)
    pipe = System(cfg, enable_loops=False, pipeline=True)
    blk = np.zeros_like(frames[0][0])
    seq = frames[:8] + [(blk, blk)] + frames[8:]
    for i, (l, r) in enumerate(seq):
        T, m = pipe.track_stereo(l, r, timestamp=i * 0.1)
        assert np.isfinite(T).all()
    pipe.flush()
    assert len(pipe.tracker.metrics) == len(seq)
    states = [m.state for m in pipe.tracker.metrics]
    assert "LOST" in states            # the blackout was detected
    assert states[-1] == "OK"          # and tracking recovered


@pytest.mark.slow
def test_pipelined_reset_right_after_init():
    """Lost with <= 5 KFs triggers the full auto-reset (Tracking.cc:482-488)
    while a pipelined frame is still in flight: the in-flight frame must
    reinitialize the fresh map through the _finalize_rec resync path, every
    frame must finalize exactly once, and the reset frame reads LOST."""
    cfg = _cfg()
    frames = _frames(cfg, 12)
    pipe = System(cfg, enable_loops=False, pipeline=True)
    blk = np.zeros_like(frames[0][0])
    # init on frame 0, blackout immediately (n_kf is certainly <= 5),
    # then good frames again
    seq = frames[:2] + [(blk, blk)] * 3 + frames[2:8]
    for i, (l, r) in enumerate(seq):
        T, m = pipe.track_stereo(l, r, timestamp=i * 0.1)
        assert np.isfinite(T).all()
    pipe.flush()
    ms = pipe.tracker.metrics
    # one metrics record per frame, in order
    assert len(ms) == len(seq)
    fids = [m.frame_id for m in ms]
    assert fids == sorted(fids)
    states = [m.state for m in ms]
    assert "LOST" in states[:6]        # the reset frame reads LOST
    # the fresh map reinitialized and tracking resumed
    assert states[-1] == "OK"
    assert pipe.tracker.store.n_kf >= 1
    # the map is the post-reset one: its first KF's frame id is after the
    # blackout (the pre-reset KFs are gone)
    assert pipe.tracker.store.kf_frame_id[0] >= 2
