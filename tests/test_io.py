"""Config parsing (config.py) and trajectory export (io/trajectory.py)."""
import numpy as np

from lldslam_tpu.config import load_config, parse_opencv_yaml
from lldslam_tpu.io import trajectory as traj

REF_YAML = """%YAML:1.0

# comment line
Camera.fx: 718.856
Camera.fy: 718.856
Camera.cx: 607.1928
Camera.cy: 185.2157
Camera.bf: 386.1448
Camera.fps: 10.0
Camera.RGB: 1
ThDepth: 35
ORBextractor.nFeatures: 2000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 12
ORBextractor.minThFAST: 7
ldType: "LBDFloat"
mdThr: 2.0
gamma: 0.5
minLineLen: 25
maxInCell: 5
lineDetectionsPath: "/data/lines/$SSS/dets"
LEFT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [458.654, 0.0, 367.215, 0.0, 457.296, 248.375, 0.0, 0.0, 1.0]
"""


def test_parse_opencv_yaml(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text(REF_YAML)
    d = parse_opencv_yaml(p)
    assert d["Camera.fx"] == 718.856
    assert d["ORBextractor.nFeatures"] == 2000
    assert d["ldType"] == "LBDFloat"
    rows, cols, vals = d["LEFT.K"]
    assert (rows, cols) == (3, 3) and vals[0] == 458.654


def test_load_config_sequence_substitution(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text(REF_YAML)
    cfg = load_config(p, sequence="04")
    assert cfg.camera.fx == 718.856
    assert cfg.orb.ini_th == 12
    assert cfg.line.enabled
    assert cfg.line.detections_path == "/data/lines/04/dets"
    # mThDepth = bf * ThDepth / fx (Tracking.cc:149)
    assert abs(cfg.close_depth - 386.1448 * 35 / 718.856) < 1e-6



def test_trajectory_replay_and_formats(tmp_path):
    rng = np.random.default_rng(0)
    # two KFs; frames relative to them
    kf_poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    kf_poses[1, :3, 3] = [0, 0, -1.0]
    rel = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    rel[1, :3, 3] = [0, 0, -0.5]
    refs = np.array([0, 0, 1])
    T_wc = traj.replay_trajectory(rel, refs, kf_poses)
    # frame1: T_cw = rel1 @ kf0 => camera at +0.5 in world z
    assert np.allclose(T_wc[1][:3, 3], [0, 0, 0.5], atol=1e-6)
    assert np.allclose(T_wc[2][:3, 3], [0, 0, 1.0], atol=1e-6)

    kitti = tmp_path / "traj.kitti"
    traj.save_kitti(kitti, T_wc)
    back = np.loadtxt(kitti).reshape(-1, 3, 4)
    assert np.allclose(back[:, :, 3], T_wc[:, :3, 3], atol=1e-6)

    tum = tmp_path / "traj.tum"
    traj.save_tum(tum, np.arange(3, dtype=np.float64), T_wc)
    rows = np.loadtxt(tum)
    assert rows.shape == (3, 8)
    assert np.allclose(rows[:, 1:4], T_wc[:, :3, 3], atol=1e-6)
    # identity rotation -> quaternion (0,0,0,1)
    assert np.allclose(rows[0, 4:], [0, 0, 0, 1], atol=1e-6)


def test_ate_rmse_alignment_invariance():
    rng = np.random.default_rng(1)
    n = 20
    T = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    T[:, :3, 3] = rng.normal(size=(n, 3))
    # rigidly transform the whole trajectory: aligned ATE must be ~0
    th = 0.7
    R = np.array([[np.cos(th), -np.sin(th), 0],
                  [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    T2 = T.copy()
    T2[:, :3, 3] = (R @ T[:, :3, 3].T).T + np.array([1.0, -2.0, 3.0])
    assert traj.ate_rmse(T2, T, align=True) < 1e-9
    assert traj.ate_rmse(T2, T, align=False) > 1.0


def _png(img, filters):
    """Hand-encode an 8-bit grayscale PNG, cycling the scanline filters."""
    import struct
    import zlib
    h, w = img.shape
    raw, prev = b"", np.zeros(w, np.int32)
    for y in range(h):
        f = filters[y % len(filters)]
        row, out = img[y].astype(np.int32), np.zeros(w, np.int32)
        for i in range(w):
            a = row[i - 1] if i else 0
            b, c = prev[i], (prev[i - 1] if i else 0)
            if f == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pr = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            else:
                pr = (0, a, b, (a + b) // 2)[f]
            out[i] = (row[i] - pr) & 255
        raw += bytes([f]) + bytes(out.astype(np.uint8))
        prev = row

    def chunk(k, d):
        return struct.pack(">I", len(d)) + k + d \
            + struct.pack(">I", zlib.crc32(k + d))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_png_reader_all_filters(tmp_path):
    """read_png_gray inverts every PNG scanline filter (none, sub, up,
    average, paeth) exactly."""
    from lldslam_tpu.io.datasets import load_gray, read_png_gray
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (11, 37)).astype(np.uint8)
    p = tmp_path / "f.png"
    p.write_bytes(_png(img, [0, 1, 2, 3, 4]))
    got = read_png_gray(p)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(load_gray(p), img.astype(np.float32))


def test_png_reader_on_mini_kitti():
    """The KITTI-layout test sequence decodes without PIL or the native
    loader, to the same pixels as PIL decodes."""
    from pathlib import Path
    from lldslam_tpu.io import datasets
    seq = datasets.load_kitti(Path(__file__).parent / "data" / "mini_kitti")
    img_l, img_r, ts = seq.frame(3)
    assert img_l.shape == img_r.shape == (96, 320)
    assert img_l.dtype == np.float32 and 0 <= img_l.min() <= img_l.max() <= 255
    from PIL import Image
    np.testing.assert_array_equal(
        img_l, np.asarray(Image.open(seq.left[3]), np.float32))
