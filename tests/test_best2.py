"""Masked Hamming best-2 (ops/hamming.masked_argmin over distance_matrix,
the projection matcher's reduction) against a numpy XOR+popcount brute force at the
tracking step's shape: 4096 map points x 2048 keypoints."""
import numpy as np
import jax.numpy as jnp
import pytest

from lldslam_tpu.ops import hamming


def _numpy_best2(a, b, mask):
    d = np.bitwise_count(a[:, None, :] ^ b[None, :, :]).sum(-1)
    d = np.where(mask, d, hamming.INF_DIST)
    rows = np.arange(len(d))
    bi = d.argmin(1)
    d2 = d.copy()
    d2[rows, bi] = hamming.INF_DIST
    si = d2.argmin(1)
    return bi, d[rows, bi], d2[rows, si], si


@pytest.mark.parametrize("density", [1.0, 0.02], ids=["dense", "sparse"])
def test_masked_best2_matches_numpy(density):
    rng = np.random.default_rng(0)
    M, N = 4096, 2048
    b = rng.integers(0, 2**32, (N, 8), dtype=np.uint64).astype(np.uint32)
    b[1::7] = b[::7][: len(b[1::7])]           # duplicate keypoints -> ties
    flips = rng.uniform(size=(M, 256)) < rng.uniform(0.02, 0.3, (M, 1))
    a = b[rng.integers(0, N, M)] ^ np.packbits(
        flips, axis=1, bitorder="little").view(np.uint32)
    mask = rng.uniform(size=(M, N)) < density
    mask[:4] = False                             # fully masked rows
    mask[4, :] = False
    mask[4, 9] = True                            # a single candidate
    got = [np.asarray(x) for x in hamming.masked_argmin(
        hamming.distance_matrix(jnp.asarray(a), jnp.asarray(b)),
        jnp.asarray(mask))]
    want = _numpy_best2(a, b, mask)
    for g, w, name in zip(got, want, ("best_idx", "best", "second",
                                      "second_idx")):
        assert g.dtype == np.int32, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got[1][:4] == hamming.INF_DIST).all()
    assert got[1][4] < hamming.INF_DIST and got[2][4] == hamming.INF_DIST
