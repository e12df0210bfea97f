"""System facade: the public API of the framework.

Replaces `ORB_SLAM2::System` (reference src/System.cc:35-477): construction
wires the pipeline (here a deterministic schedule, not threads), TrackStereo
feeds frames, trajectory savers export TUM/KITTI formats, and
checkpoint/restore snapshots the SoA map (the reference's acknowledged
SaveMap/LoadMap TODO, System.h:118-120).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .config import SlamConfig, load_config
from .io import trajectory as traj
from .pipeline.tracker import StereoTracker, TrackState


_VOC_CACHE: list = []


def _default_vocabulary():
    """Load (once per process) the shipped vocabulary, or None if absent."""
    if not _VOC_CACHE:
        p = Path(__file__).parent / "loop" / "vocab_synth.npz"
        if p.exists():
            from .loop.bow import Vocabulary
            _VOC_CACHE.append(Vocabulary.load_npz(p))
        else:
            _VOC_CACHE.append(None)
    return _VOC_CACHE[0]


class System:
    def __init__(self, cfg: SlamConfig | str | Path, sequence: str | None = None,
                 vocabulary=None, enable_loops: bool = True,
                 pipeline: bool = False):
        """vocabulary: loop/bow.Vocabulary, a path to an ORBvoc.txt-format
        file, or None (a vocabulary is trained from the first keyframe).

        pipeline=True enables the finalize-lag-1 pipelined tracker: frame
        i+1's device program is dispatched before frame i's results reach
        the host (the deterministic analogue of the reference's
        tracking/LocalMapping thread overlap). track_stereo then returns the
        PREVIOUS frame's finalized (pose, metrics) — (current pose estimate,
        None) for the very first frame — and flush() finalizes the last
        in-flight frame at sequence end."""
        if not isinstance(cfg, SlamConfig):
            cfg = load_config(cfg, sequence=sequence)
        self.cfg = cfg
        self.pipeline = pipeline
        if isinstance(vocabulary, (str, Path)):
            from .loop.bow import Vocabulary
            p = Path(vocabulary)
            vocabulary = (Vocabulary.load_npz(p) if p.suffix == ".npz"
                          else Vocabulary.load_text(p))
        elif vocabulary is None and enable_loops:
            # default: the shipped ~10^5-word vocabulary (trained offline by
            # tools/train_vocab.py — the counterpart of the reference's
            # ORBvoc.txt load, System.cc:70). Falls back to the
            # first-keyframe-trained mini vocab if the file is absent.
            vocabulary = _default_vocabulary()
        self.tracker = StereoTracker(cfg, vocabulary=vocabulary,
                                     enable_loops=enable_loops,
                                     pipeline=pipeline)

    def warmup(self) -> None:
        """Pre-compile the rare-path loop-closure programs (Sim3 RANSAC,
        Sim(3) pose graph, global BA) so the first real loop event doesn't
        stall tracking on compilation. Optional; costs one compile per
        program at startup (cached across processes by the persistent
        compile cache). Vocabulary-independent."""
        from .loop.closing import warmup_loop_programs
        warmup_loop_programs(self.tracker.cam)
        lc = self.tracker.loop_closer
        self.tracker.mapper.warmup(voc=None if lc is None else lc.voc)

    # -- frame input (System::TrackStereo/TrackRGBD, System.cc:121-194) --
    def track_stereo(self, img_l: np.ndarray, img_r: np.ndarray,
                     timestamp: float = 0.0, pair_dev=None, lines_dev=None):
        """Returns (T_cw (4,4), per-frame metrics). `pair_dev` optionally
        passes a device-staged stacked pair from `stage_stereo` — staging a
        few frames ahead overlaps the host->device transfer with tracking
        (the device analogue of the reference's image-read thread).
        `lines_dev` likewise pre-stages stored line detections."""
        return self.tracker.process(img_l, img_r, timestamp,
                                    pair_dev=pair_dev, lines_dev=lines_dev)

    def stage_stereo(self, img_l: np.ndarray, img_r: np.ndarray):
        """Stage one stereo pair in device memory (one stacked async upload);
        pass the handle back via track_stereo(pair_dev=...)."""
        return self.tracker.stage_pair(img_l, img_r)

    def track_rgbd(self, img: np.ndarray, depthmap: np.ndarray,
                   timestamp: float = 0.0, depth_factor: float = 1.0):
        """RGB-D input: depth map -> virtual stereo (Frame.cc:706-723)."""
        return self.tracker.process_rgbd(img, depthmap, timestamp,
                                         depth_factor)

    def track_monocular(self, img: np.ndarray, timestamp: float = 0.0):
        """Monocular input (System::TrackMonocular, System.cc:228-260):
        H/F bootstrap, scale-free map."""
        return self.tracker.process_mono(img, timestamp)

    def flush(self):
        """Finalize the in-flight pipelined frame (no-op in sync mode)."""
        return self.tracker.flush()

    @property
    def state(self) -> TrackState:
        return self.tracker.state

    @property
    def map(self):
        return self.tracker.store

    # -- trajectory export (System.cc:327-477) ---------------------------
    def save_trajectory_kitti(self, path: str | Path) -> None:
        _, T_wc = self.tracker.trajectory()
        traj.save_kitti(path, T_wc)

    def save_trajectory_tum(self, path: str | Path) -> None:
        ts, T_wc = self.tracker.trajectory()
        traj.save_tum(path, ts, T_wc)

    def save_keyframe_trajectory_tum(self, path: str | Path) -> None:
        s = self.map
        K = s.n_kf
        sel = np.nonzero(s.kf_valid[:K])[0]
        T_cw = s.kf_pose[sel]
        Rwc = np.transpose(T_cw[:, :3, :3], (0, 2, 1))
        twc = -np.einsum("kij,kj->ki", Rwc, T_cw[:, :3, 3])
        T_wc = np.tile(np.eye(4, dtype=np.float32), (len(sel), 1, 1))
        T_wc[:, :3, :3] = Rwc
        T_wc[:, :3, 3] = twc
        traj.save_tum(path, s.kf_timestamp[sel], T_wc)

    # -- mode switches + lifecycle (System.cc:121-161, 279-325) ------------
    def activate_localization_mode(self) -> None:
        """Track against the frozen map; no keyframes or map growth
        (System::ActivateLocalizationMode). Drains the pipelined chain
        first: in-flight frames were dispatched with the mapping-phase
        on-device KF decision, and the mode flips the decision gates (and
        provisional-identity seeding) for every subsequent dispatch."""
        if getattr(self.tracker, "pipeline", False):
            self.tracker.flush()
            self.tracker._resync = True
        self.tracker.localization_only = True

    def deactivate_localization_mode(self) -> None:
        if getattr(self.tracker, "pipeline", False):
            self.tracker.flush()
            self.tracker._resync = True
        self.tracker.localization_only = False

    def reset(self) -> None:
        """Full reset: clear map/trajectory and reinitialize
        (Tracking::Reset, Tracking.cc:2000-2046)."""
        self.tracker = StereoTracker(
            self.cfg, vocabulary=self.tracker.vocabulary,
            enable_loops=self.tracker.enable_loops,
            pipeline=self.pipeline)

    # -- map persistence (the reference's SaveMap/LoadMap TODO,
    #    System.h:118-120) -------------------------------------------------
    def save_map(self, path) -> None:
        from .io.checkpoint import save_map
        save_map(self.map, path)

    def load_map(self, path) -> None:
        from .io.checkpoint import load_map
        load_map(self.map, path)

    def shutdown(self) -> None:
        """Drain the pipeline and stop the IO worker threads (System::
        Shutdown, System.cc:301-325). The COMPUTE pipeline has no threads
        by design (SURVEY.md §2.3); pipelined mode runs small IO pools for
        ring fetches and staged mapper dispatches, which must not leak
        across many System lifetimes in one process."""
        tr = self.tracker
        try:
            if getattr(tr, "pipeline", False):
                tr.flush()
        except Exception:
            pass
        io = getattr(tr, "_tr_io", None)
        if io is not None:
            io.shutdown(wait=False, cancel_futures=True)
            tr._tr_io = None
        if getattr(tr, "mapper", None) is not None:
            tr.mapper.close()
