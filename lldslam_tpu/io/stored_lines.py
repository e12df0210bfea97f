"""Precomputed line detections on disk — the StoredLineExtractor contract.

The reference's benchmark configuration does not detect lines online: an
external tool writes per-frame detections + LBD descriptors and
`StoredLineExtractor` loads them by frame id (SURVEY.md §0.1;
`lineDetectionsPath`/`lineDescriptorsPath` with `$SSS` substitution,
KITTI04-12_LBD.yaml:73-75; `SetFrameId` + `ExtractLines` call sites,
stereo_kitti.cc:84-85, Frame.cc:116-117).

This module defines the rebuild's storage format (one `%06d.npz` per frame
per camera: p1, p2, octave, desc float32) plus a writer so our own detector
can precompute sequences offline. LBDMOD's binary format is undocumented
outside that library; conversion happens once through this format.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def save_frame_lines(dir_path: str | Path, frame_id: int, p1, p2, octave,
                     desc, valid=None) -> None:
    dir_path = Path(dir_path)
    dir_path.mkdir(parents=True, exist_ok=True)
    p1, p2 = np.asarray(p1), np.asarray(p2)
    octave, desc = np.asarray(octave), np.asarray(desc)
    if valid is not None:
        sel = np.asarray(valid)
        p1, p2, octave, desc = p1[sel], p2[sel], octave[sel], desc[sel]
    np.savez(dir_path / f"{frame_id:06d}.npz",
             p1=p1.astype(np.float32), p2=p2.astype(np.float32),
             octave=octave.astype(np.int32), desc=desc.astype(np.float32))


class StoredLineSource:
    """Per-frame line loader (`StoredLineExtractor` equivalent).

    `frame(i)` returns a frontend.line_extract.KeyLines padded to `cap`.
    """

    def __init__(self, dir_path: str | Path, cap: int = 256,
                 desc_dim: int = 40):
        self.dir = Path(dir_path)
        self.cap = cap
        self.desc_dim = desc_dim
        # capacity-overflow log (no silent caps): total lines dropped and
        # number of frames affected; read by benches/CLI stats
        self.cap_events = 0
        self.cap_dropped = 0

    def _frame_np(self, frame_id: int):
        path = self.dir / f"{frame_id:06d}.npz"
        cap, D = self.cap, self.desc_dim
        p1 = np.zeros((cap, 2), np.float32)
        p2 = np.zeros((cap, 2), np.float32)
        octave = np.zeros(cap, np.int32)
        desc = np.zeros((cap, D), np.float32)
        valid = np.zeros(cap, bool)
        if path.exists():
            z = np.load(path)
            n_file = len(z["p1"])
            n = min(n_file, cap)
            if n_file > cap:
                # keep the LONGEST lines (the reference's detector sorts
                # by response/length; long segments carry the most pose
                # constraint) and LOG the truncation
                ln = np.linalg.norm(np.asarray(z["p2"], np.float32)
                                    - np.asarray(z["p1"], np.float32),
                                    axis=-1)
                order = np.argsort(-ln, kind="stable")[:cap]
                order = np.sort(order)
                self.cap_events += 1
                self.cap_dropped += n_file - cap
                p1[:] = z["p1"][order]
                p2[:] = z["p2"][order]
                octave[:] = z["octave"][order]
                d = np.asarray(z["desc"])[order]
                desc[:, : min(D, d.shape[1])] = d[:, : min(D, d.shape[1])]
                valid[:] = True
                length = np.linalg.norm(p2 - p1, axis=-1).astype(np.float32)
                return p1, p2, octave, length, desc, valid
            p1[:n] = z["p1"][:n]
            p2[:n] = z["p2"][:n]
            octave[:n] = z["octave"][:n]
            d = z["desc"][:n]
            desc[:n, : min(D, d.shape[1])] = d[:, : min(D, d.shape[1])]
            valid[:n] = True
        length = (np.linalg.norm(p2 - p1, axis=-1) * valid).astype(np.float32)
        return p1, p2, octave, length, desc, valid

    def _pack_np(self, frame_id: int) -> np.ndarray:
        p1, p2, octave, length, desc, valid = self._frame_np(frame_id)
        bc = lambda a: np.ascontiguousarray(
            a, np.float32).reshape(-1).view(np.int32)
        return np.concatenate([bc(p1), bc(p2), octave.astype(np.int32),
                               bc(length), bc(desc),
                               valid.astype(np.int32)])

    def frame(self, frame_id: int):
        """KeyLines for one frame — ONE packed host->device transfer instead
        of one per array."""
        import jax
        buf = jax.device_put(self._pack_np(frame_id))
        return _unpack_keylines(buf, 0, self.cap, self.desc_dim)


def stage_stored_pair(left: "StoredLineSource", right: "StoredLineSource",
                      frame_id: int):
    """Stage BOTH views' stored detections as ONE packed upload, the line
    analogue of the stacked stereo-image staging (reference
    StoredLineExtractor reads per-view files, stereo_kitti.cc:61-85)."""
    import jax
    bl = left._pack_np(frame_id)
    br = right._pack_np(frame_id)
    buf = jax.device_put(np.concatenate([bl, br]))
    kl = _unpack_keylines(buf, 0, left.cap, left.desc_dim)
    kr = _unpack_keylines(buf, len(bl), right.cap, right.desc_dim)
    return kl, kr


def _unpack_keylines(buf, off: int, cap: int, D: int):
    import jax
    from functools import partial
    global _UNPACK_JIT
    if _UNPACK_JIT is None:
        @partial(jax.jit, static_argnames=("off", "cap", "D"))
        def run(buf, off: int, cap: int, D: int):
            from ..frontend.line_extract import KeyLines
            from ..pipeline.mapper_fast import _slice_f, _slice_i
            o = off
            p1 = _slice_f(buf, o, (cap, 2)); o += 2 * cap
            p2 = _slice_f(buf, o, (cap, 2)); o += 2 * cap
            octave = _slice_i(buf, o, (cap,)); o += cap
            length = _slice_f(buf, o, (cap,)); o += cap
            desc = _slice_f(buf, o, (cap, D)); o += D * cap
            valid = _slice_i(buf, o, (cap,)) > 0
            return KeyLines(p1=p1, p2=p2, octave=octave, length=length,
                            desc=desc, valid=valid)
        _UNPACK_JIT = run
    return _UNPACK_JIT(buf, off, cap, D)


_UNPACK_JIT = None


def precompute_sequence(seq, out_left: str | Path, out_right: str | Path,
                        cfg=None) -> int:
    """Run the native detector over a StereoSequence and store detections —
    the offline tool the reference assumes exists (README.md:80 download)."""
    import jax.numpy as jnp
    from ..frontend.line_extract import LineDetConfig, detect_lines

    cfg = cfg or LineDetConfig()
    for i in range(len(seq)):
        imL, imR, _ = seq.frame(i)
        for img, out in ((imL, out_left), (imR, out_right)):
            kl = detect_lines(jnp.asarray(img), cfg)
            save_frame_lines(out, i, np.asarray(kl.p1), np.asarray(kl.p2),
                             np.asarray(kl.octave), np.asarray(kl.desc),
                             np.asarray(kl.valid))
    return len(seq)
