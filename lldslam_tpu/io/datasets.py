"""Dataset loaders: KITTI odometry and EuRoC MAV stereo sequences.

Replaces the `LoadImages` helpers of the reference CLI drivers
(Examples/Stereo/stereo_kitti.cc:147-181, stereo_euroc.cc:101-151). Image
decoding stays on host (I/O only, per the design stance SURVEY.md §7); the
arrays handed out are float32 grayscale ready for device upload.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

import struct
import zlib


def _unfilter_row(ftype: int, raw: np.ndarray, up: np.ndarray, bpp: int):
    """Invert one PNG scanline filter (PNG spec §9.2) on uint8 bytes."""
    if ftype == 0:
        return raw
    if ftype == 2:
        return raw + up
    out = bytearray(raw.tobytes())
    prev = up.tobytes()
    n = len(out)
    if ftype == 1:
        for i in range(bpp, n):
            out[i] = (out[i] + out[i - bpp]) & 0xFF
    elif ftype == 3:
        for i in range(n):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + prev[i]) >> 1)) & 0xFF
    elif ftype == 4:
        for i in range(n):
            a = out[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    else:
        raise ValueError(f"bad PNG filter type {ftype}")
    return np.frombuffer(bytes(out), np.uint8)


def read_png_gray(path: str | Path) -> np.ndarray:
    """Decode a non-interlaced 8- or 16-bit grayscale PNG (the KITTI
    odometry format) with zlib and numpy only. Returns (H, W) uint8 or
    uint16."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat = 8, []
    w = h = depth = None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if color != 0 or depth not in (8, 16) or interlace:
                raise ValueError(f"{path}: only 8/16-bit non-interlaced "
                                 "grayscale PNGs are supported")
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if w is None:
        raise ValueError(f"{path}: missing IHDR")
    bpp = depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, stride + 1)
    rows = np.zeros((h, stride), np.uint8)
    up = np.zeros(stride, np.uint8)
    for y in range(h):
        up = rows[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], up, bpp)
    if depth == 16:
        return rows.view(">u2").reshape(h, w).astype(np.uint16)
    return rows


def load_gray(path: str | Path) -> np.ndarray:
    """Grayscale float32 image in [0, 255]. Grayscale PNGs decode with
    `read_png_gray`; other formats need PIL."""
    try:
        arr = read_png_gray(path).astype(np.float32)
    except ValueError:
        from PIL import Image
        img = Image.open(path)
        if img.mode not in ("L", "I;16"):
            img = img.convert("L")
        arr = np.asarray(img, dtype=np.float32)
    if arr.max() > 255.0:  # 16-bit source
        arr = arr / 256.0
    return arr


@dataclass
class StereoSequence:
    """Lazy stereo sequence: paths + timestamps."""

    left: list
    right: list
    timestamps: np.ndarray

    def __len__(self) -> int:
        return len(self.left)

    def frame(self, i: int):
        return load_gray(self.left[i]), load_gray(self.right[i]), float(self.timestamps[i])


class PrefetchedStereoSequence:
    """StereoSequence backed by the native C++ threaded PNG prefetcher
    (native/loader.cpp): frames decode ahead of the tracker off-thread."""

    def __init__(self, seq: StereoSequence, window: int = 8,
                 n_threads: int = 2):
        from ..native import NativeImageLoader
        self._left = NativeImageLoader(seq.left, window, n_threads)
        self._right = NativeImageLoader(seq.right, window, n_threads)
        self.timestamps = seq.timestamps

    def __len__(self):
        return len(self._left)

    def frame(self, i: int):
        return (self._left.frame(i), self._right.frame(i),
                float(self.timestamps[i]))


def prefetch(seq: StereoSequence, window: int = 8, n_threads: int = 2):
    """Wrap with the native prefetcher when buildable; identity otherwise."""
    try:
        return PrefetchedStereoSequence(seq, window, n_threads)
    except Exception:
        return seq


def load_kitti(seq_dir: str | Path) -> StereoSequence:
    """KITTI odometry layout: <seq>/times.txt, image_0/*.png, image_1/*.png
    (stereo_kitti.cc:147-181: %06d.png naming)."""
    seq_dir = Path(seq_dir)
    times = np.loadtxt(seq_dir / "times.txt", dtype=np.float64).reshape(-1)
    n = len(times)
    left = [seq_dir / "image_0" / f"{i:06d}.png" for i in range(n)]
    right = [seq_dir / "image_1" / f"{i:06d}.png" for i in range(n)]
    return StereoSequence(left=left, right=right, timestamps=times)


def load_euroc(seq_dir: str | Path, times_file: str | Path) -> StereoSequence:
    """EuRoC MAV layout: mav0/cam{0,1}/data/<ns>.png with a timestamp list
    file of nanosecond stamps (stereo_euroc.cc:101-151)."""
    seq_dir = Path(seq_dir)
    stamps = []
    for ln in Path(times_file).read_text().splitlines():
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            continue
        stamps.append(ln.split(",")[0].split()[0])
    left = [seq_dir / "mav0" / "cam0" / "data" / f"{s}.png" for s in stamps]
    right = [seq_dir / "mav0" / "cam1" / "data" / f"{s}.png" for s in stamps]
    times = np.array([int(s) * 1e-9 for s in stamps], np.float64)
    return StereoSequence(left=left, right=right, timestamps=times)
