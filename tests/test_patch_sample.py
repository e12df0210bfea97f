"""Per-keypoint patch gathers of the frame build — the rotated-BRIEF taps of
ops/orb and the stereo SAD windows of ops/stereo — against numpy gathers,
border and upper-level keypoints included."""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from lldslam_tpu.ops import image, orb, stereo


def _np_brief(blur, xy, ang):
    """numpy rotated BRIEF (computeOrbDescriptor, ORBextractor.cc:108-147):
    rotated, rounded, clipped taps; bit i = I(a_i) < I(b_i). Returns
    (words, number of keypoints with a clipped tap)."""
    h, w = blur.shape
    pat = orb._PATTERN.astype(np.float32)          # (256, 2, 2)
    ca, sa = np.cos(ang)[:, None, None], np.sin(ang)[:, None, None]
    px, py = pat[None, :, :, 0], pat[None, :, :, 1]
    rx = np.round(px * ca - py * sa).astype(np.int32)
    ry = np.round(px * sa + py * ca).astype(np.int32)
    x, y = xy[:, None, None, 0] + rx, xy[:, None, None, 1] + ry
    gx, gy = np.clip(x, 0, w - 1), np.clip(y, 0, h - 1)
    v = blur[gy, gx]
    bits = (v[..., 0] < v[..., 1]).astype(np.uint64).reshape(-1, 8, 32)
    words = (bits << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    return words, int(((gx != x) | (gy != y)).any((1, 2)).sum())


def test_brief_full_width_matches_numpy_gather():
    """extract_stack_pyr at the KITTI width (1241x376 pair): every
    descriptor equals a numpy tap gather on the same blurred level at the
    same keypoint and angle. Keypoints near the detection margin rotate
    taps past the image edge, which exercises the clipping."""
    rng = np.random.default_rng(3)
    cfg = orb.OrbConfig(n_features=2000, n_levels=3)
    H, W = 376, 1241
    base = rng.uniform(0, 255, (H // 8 + 1, W // 8 + 1))
    img = np.kron(base, np.ones((8, 8)))[:H, :W]
    img = np.stack([img, np.roll(img, -9, axis=1)]) + rng.normal(0, 3, (2, H, W))
    pyr = tuple(image.build_pyramid(jnp.asarray(img, jnp.float32),
                                    cfg.n_levels, cfg.scale, quantize=True))
    kp = orb.extract_stack_pyr(pyr, cfg)
    xy0, octv = np.asarray(kp.xy), np.asarray(kp.octave)
    ang = np.asarray(kp.angle)
    desc = np.asarray(kp.desc)
    scales = np.asarray(cfg.scale_factors(), np.float32)
    n_real = sum(cfg.per_level_budget())
    blur_fn = jax.jit(lambda p: jnp.round(jax.vmap(image.gaussian_blur)(p))
                      .astype(p.dtype))
    n_border = 0
    for l, lvl in enumerate(pyr):
        blur = np.asarray(blur_fn(lvl)).astype(np.float32)
        for v in range(2):
            sel = np.nonzero(octv[v, :n_real] == l)[0]
            xy = np.rint(xy0[v, sel] / scales[l]).astype(np.int32)
            want, n_clip = _np_brief(blur[v], xy, ang[v, sel])
            n_border += n_clip
            np.testing.assert_array_equal(desc[v, sel], want,
                                          err_msg=f"level {l} view {v}")
    assert n_border > 0


def test_extract_stack_matches_vmap_extract():
    """extract_stack_pyr == vmap(extract_pyr)."""
    rng = np.random.default_rng(2)
    cfg = orb.OrbConfig(n_features=300, n_levels=3)
    img = rng.uniform(0, 255, (2, 120, 360)).astype(np.float32)
    pyr = tuple(image.build_pyramid(jnp.asarray(img), cfg.n_levels, cfg.scale))
    a = orb.extract_stack_pyr(pyr, cfg)
    b = jax.vmap(partial(orb.extract_pyr, cfg=cfg))(pyr)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_stereo_windows_match_numpy():
    """stereo.gather_windows: SAD patch (left) and disparity strip (right)
    at each keypoint's own octave, clipped into that level — keypoints on
    all four borders and on the top levels included."""
    rng = np.random.default_rng(5)
    cfg = orb.OrbConfig(n_features=500, n_levels=4)
    W_, L_ = 5, 5
    imgs = rng.uniform(0, 255, (2, 96, 320)).astype(np.float32)
    pyr = image.build_pyramid(jnp.asarray(imgs), cfg.n_levels, cfg.scale,
                              quantize=True)
    pl = [p[0] for p in pyr]
    pr = [p[1] for p in pyr]
    dims = [p.shape for p in pl]
    oct_, ul, vl, ur = [], [], [], []
    for l, (h, w) in enumerate(dims):
        for u, v, r in ((0, 0, 0), (w - 1, h - 1, w - 1), (2, h // 2, w - 3),
                        (w // 2, 1, 0), (w - 4, h - 2, 3)):
            oct_.append(l)
            ul.append(u)
            vl.append(v)
            ur.append(r)
        for _ in range(6):
            oct_.append(l)
            ul.append(rng.integers(0, w))
            vl.append(rng.integers(0, h))
            ur.append(rng.integers(0, w))
    oct_, ul, vl, ur = (np.asarray(x, np.int32) for x in (oct_, ul, vl, ur))
    patch, strip = jax.jit(partial(stereo.gather_windows, W=W_, L=L_))(
        jnp.asarray(ul), jnp.asarray(vl), jnp.asarray(ur),
        jnp.asarray(oct_), pl, pr)
    patch, strip = np.asarray(patch), np.asarray(strip)
    npl = [np.asarray(p, np.float32) for p in pl]
    npr = [np.asarray(p, np.float32) for p in pr]
    for i, l in enumerate(oct_):
        h, w = dims[l]
        ys = np.clip(vl[i] + np.arange(-W_, W_ + 1), 0, h - 1)
        xp = np.clip(ul[i] + np.arange(-W_, W_ + 1), 0, w - 1)
        xs = np.clip(ur[i] + np.arange(-W_ - L_, W_ + L_ + 1), 0, w - 1)
        np.testing.assert_array_equal(patch[i], npl[l][np.ix_(ys, xp)])
        np.testing.assert_array_equal(strip[i], npr[l][np.ix_(ys, xs)])
