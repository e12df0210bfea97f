"""Train the shipped place-recognition vocabulary (offline, one-off).

The reference loads a 10^6-leaf ORBvoc.txt trained on Bovisa/Malaga imagery
(System.cc:70; TemplatedVocabulary.h:1338). That file is not obtainable in
this environment (zero egress), so we train an ORB vocabulary of the same
structure (k=10, L=5 -> ~10^5 leaves) over >= 1M descriptors extracted by
OUR extractor from a diverse synthetic corpus — self-consistent with the
descriptors the pipeline produces at runtime.

Output: lldslam_tpu/loop/vocab_synth.npz (packed arrays, loaded by
loop.bow.Vocabulary.load_npz; System uses it as the default vocabulary).

Usage: python tools/train_vocab.py [n_frames] [k] [L]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("LLDSLAM_TRAIN_CPU"):
    # force CPU via jax.config (e.g. to train while the GPU runs a bench)
    os.environ.setdefault("LLDSLAM_NO_COMPILE_CACHE", "1")
    import jax
    jax.config.update("jax_platforms", "cpu")


def log(m):
    print(m, file=sys.stderr, flush=True)


def make_corpus(n_frames: int, seed: int = 0):
    """Diverse synthetic gray frames: rendered 3D corridor worlds (the
    runtime imagery distribution — bench._make_sequence over many seeds,
    with and without line structure), textured-blob scenes, and structured
    (gradient/stripe/checker) and noise backgrounds."""
    import jax.numpy as jnp
    from bench import _make_sequence
    from lldslam_tpu.geometry.camera import StereoCamera
    from lldslam_tpu.ops import image, orb

    rng = np.random.default_rng(seed)
    H, W = 376, 1241
    cfg = orb.OrbConfig(n_features=2000)
    cam = StereoCamera(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                       bf=386.1448, width=W, height=H)
    descs, docs = [], []
    t0 = time.time()
    # half the corpus: rendered 3D worlds — wide outdoor corridors AND
    # narrow/slow indoor (EuRoC-like) rooms, 8 frames per seed
    n_rendered = n_frames // 2
    world_frames = []
    s = 0
    while len(world_frames) < n_rendered:
        if s % 3 == 2:
            # indoor: 2.5 m half-width room, low camera, slow motion
            world_frames.extend(_make_sequence(
                cam, 8, seed=1000 + s, with_lines=(s % 2 == 0),
                half_w=2.5, cam_h=1.1, speed=0.3))
        else:
            world_frames.extend(_make_sequence(
                cam, 8, seed=1000 + s, with_lines=(s % 2 == 0)))
        s += 1

    def photometric(im, rng):
        """Gain/bias jitter + vignette + sensor noise + occluding blobs —
        the nuisance factors real place-recognition imagery carries."""
        im = im * rng.uniform(0.6, 1.4) + rng.uniform(-25, 25)
        if rng.uniform() < 0.5:
            yy, xx = np.mgrid[0:im.shape[0], 0:im.shape[1]].astype(np.float32)
            cx, cy = im.shape[1] / 2, im.shape[0] / 2
            r2 = ((xx - cx) / cx) ** 2 + ((yy - cy) / cy) ** 2
            im = im * (1.0 - rng.uniform(0.1, 0.4) * r2)
        for _ in range(rng.integers(0, 4)):
            h = int(rng.integers(20, 90))
            w = int(rng.integers(30, 200))
            y = int(rng.integers(0, im.shape[0] - h))
            x = int(rng.integers(0, im.shape[1] - w))
            im[y:y + h, x:x + w] = rng.uniform(5, 250)
        im = im + rng.normal(0, rng.uniform(1.0, 6.0), im.shape)
        return im

    for f in range(n_frames):
        if f < n_rendered:
            im = world_frames[f][f % 2].astype(np.float32)  # L or R view
            im = np.clip(photometric(im, rng), 0, 255)
            kp = orb.extract(jnp.asarray(im), cfg)
            valid = np.asarray(kp.valid)
            d = np.asarray(kp.desc)[valid]
            descs.append(d)
            docs.append(np.full(len(d), f, np.int32))
            if f % 32 == 0:
                log(f"  corpus frame {f}/{n_frames} "
                    f"({sum(len(x) for x in descs)} descs, "
                    f"{time.time()-t0:.0f}s)")
            continue
        kind = f % 4
        if kind == 0:  # textured random blobs on flat bg
            im = np.full((H, W), rng.uniform(10, 60), np.float32)
            n_b = 400
            PS = 25
            for _ in range(n_b):
                y = rng.integers(0, H - PS)
                x = rng.integers(0, W - PS)
                im[y:y + PS, x:x + PS] = rng.uniform(0, 255, (PS, PS))
        elif kind == 1:  # smooth gradients + stripes + speckle
            yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
            a, b = rng.uniform(-0.3, 0.3, 2)
            im = 100 + a * xx + b * yy
            im += 60 * np.sin(xx / rng.uniform(8, 40)) \
                * np.sin(yy / rng.uniform(8, 40))
            im += rng.normal(0, 25, (H, W))
        elif kind == 2:  # checkerboard patches at random scales
            im = rng.uniform(0, 40, (H, W)).astype(np.float32)
            for _ in range(60):
                s = int(rng.integers(4, 24))
                y = rng.integers(0, H - 8 * s)
                x = rng.integers(0, W - 8 * s)
                tile = np.indices((8, 8)).sum(0) % 2
                blk = np.kron(tile, np.ones((s, s))) * rng.uniform(120, 255)
                im[y:y + 8 * s, x:x + 8 * s] = blk
        else:  # pure noise at random contrast
            im = rng.uniform(0, rng.uniform(80, 255), (H, W))
        im = np.clip(im, 0, 255).astype(np.float32)
        kp = orb.extract(jnp.asarray(im), cfg)
        valid = np.asarray(kp.valid)
        d = np.asarray(kp.desc)[valid]
        descs.append(d)
        docs.append(np.full(len(d), f, np.int32))
        if f % 32 == 0:
            log(f"  corpus frame {f}/{n_frames} "
                f"({sum(len(x) for x in descs)} descs, {time.time()-t0:.0f}s)")
    return np.concatenate(descs), np.concatenate(docs)


def main():
    from lldslam_tpu.loop.bow import Vocabulary
    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 480
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    L = int(sys.argv[3]) if len(sys.argv) > 3 else 5
    log(f"generating corpus ({n_frames} frames)...")
    descs, docs = make_corpus(n_frames)
    log(f"corpus: {len(descs)} descriptors, {docs.max()+1} docs")
    t0 = time.time()
    voc = Vocabulary.train_device(descs, k=k, L=L, seed=0, doc_ids=docs)
    log(f"trained k={k} L={L}: {voc.n_words} words "
        f"({len(voc.node_word)} nodes) in {time.time()-t0:.0f}s")
    out = "lldslam_tpu/loop/vocab_synth.npz"
    voc.save_npz(out)
    log(f"saved {out}")
    # quick sanity: word distribution entropy over a held-out noise frame
    rng = np.random.default_rng(123)
    probe = np.round(rng.uniform(0, 255, (64, 8))).astype(np.uint32)
    w = voc.transform_words(descs[:5000])
    uniq = len(np.unique(w))
    log(f"sanity: 5000 training descs map to {uniq} distinct words")


if __name__ == "__main__":
    main()
