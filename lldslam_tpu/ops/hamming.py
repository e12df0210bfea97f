"""Batched Hamming-distance machinery for 256-bit ORB descriptors.

Replaces `ORBmatcher::DescriptorDistance` (reference src/ORBmatcher.cc:1647,
a popcount loop) and the pairwise search loops of every matcher variant with
dense masked distance matrices: an all-pairs (N x M) distance matrix is one
matrix product plus fused elementwise work, cheaper on an accelerator than
pointer-chasing candidate lists.

Thresholds: TH_LOW=50, TH_HIGH=100, HISTO_LENGTH=30 rotation bins
(ORBmatcher.cc:36-38).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
INF_DIST = 10_000  # sentinel > any possible 256-bit distance


def unpack_bits(a: jnp.ndarray) -> jnp.ndarray:
    """(N, 8) uint32 packed descriptors -> (N, 256) bfloat16 {0, 1} bits."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (a[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    return bits.reshape(a.shape[0], 256).astype(jnp.bfloat16)


def distance_matrix(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(N, 8) uint32 x (M, 8) uint32 -> (N, M) int32 Hamming distances.

    Bit-matmul formulation: with bit matrices A, B in {0,1},
    popcount(a XOR b) = |a| + |b| - 2 A.B^T — one (N,256)x(256,M) bf16
    matrix product instead of an (N, M, 8) XOR+popcount pass.
    bf16 inputs are exact for 0/1; accumulation is forced to f32, so the
    result is exact (max value 256)."""
    A = unpack_bits(a)
    B = unpack_bits(b)
    ab = jax.lax.dot_general(
        A, B, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32)
    na = jnp.sum(A.astype(jnp.float32), axis=1)
    nb = jnp.sum(B.astype(jnp.float32), axis=1)
    return jnp.round(na[:, None] + nb[None, :] - 2.0 * ab).astype(jnp.int32)


def distance_pairs(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Rowwise distances for aligned pairs: (..., 8) x (..., 8) -> (...,)."""
    x = jax.lax.bitwise_xor(a, b)
    return jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.int32)


def masked_argmin(dist: jnp.ndarray, mask: jnp.ndarray):
    """Best and runner-up entry per row with invalid entries masked out.

    Returns (best_idx, best_dist, second_dist, second_idx), each (N,)
    int32; ties go to the lowest column and rows with no valid entry read
    INF_DIST. The second is the minimum over every column but best_idx,
    which is what the same-octave ratio gate of ORBmatcher.cc:117-127
    compares against.
    """
    d = jnp.where(mask, dist, INF_DIST)
    best_idx = jnp.argmin(d, axis=-1).astype(jnp.int32)
    best = jnp.take_along_axis(d, best_idx[:, None], axis=-1)[:, 0]
    d2 = d.at[jnp.arange(d.shape[0]), best_idx].set(INF_DIST)
    second = jnp.min(d2, axis=-1)
    second_idx = jnp.argmin(d2, axis=-1).astype(jnp.int32)
    return best_idx, best, second, second_idx


def mutual_filter(best_ab: jnp.ndarray, best_ba: jnp.ndarray) -> jnp.ndarray:
    """Cross-check: keep a->b matches where b's best is a. (N,) bool."""
    n = best_ab.shape[0]
    return best_ba[best_ab] == jnp.arange(n)


def rotation_consistency_mask(
    ang_a: jnp.ndarray, ang_b: jnp.ndarray, match_idx: jnp.ndarray,
    valid: jnp.ndarray, n_keep: int = 3,
) -> jnp.ndarray:
    """Rotation-consistency histogram: bin angle differences into HISTO_LENGTH
    bins, keep matches in the top-`n_keep` bins (ORBmatcher.cc:1447-1467,
    ComputeThreeMaxima ORBmatcher.cc:1601).

    ang_* in radians; match_idx maps a-index -> b-index. Returns (N,) bool.
    """
    diff = ang_a - ang_b[match_idx]
    deg = jnp.rad2deg(diff)
    deg = jnp.where(deg < 0, deg + 360.0, deg)
    factor = HISTO_LENGTH / 360.0
    b = jnp.round(deg * factor).astype(jnp.int32)
    b = jnp.where(b == HISTO_LENGTH, 0, b)
    counts = jnp.zeros(HISTO_LENGTH, jnp.int32).at[b].add(valid.astype(jnp.int32))
    _, top_bins = jax.lax.top_k(counts, n_keep)
    return valid & jnp.any(b[:, None] == top_bins[None, :], axis=-1)


def match_descriptors(
    desc_a: jnp.ndarray,
    valid_a: jnp.ndarray,
    desc_b: jnp.ndarray,
    valid_b: jnp.ndarray,
    max_dist: int = TH_LOW,
    ratio: float = 1.0,
    cand_mask: jnp.ndarray | None = None,
    mutual: bool = True,
):
    """Generic gated matcher: best match per `a` row among masked candidates,
    distance threshold, best/second ratio test, optional cross-check.

    Returns (idx (N,) int32 into b, ok (N,) bool, dist (N,) int32).
    """
    dist = distance_matrix(desc_a, desc_b)
    mask = valid_a[:, None] & valid_b[None, :]
    if cand_mask is not None:
        mask = mask & cand_mask
    idx, best, second, _ = masked_argmin(dist, mask)
    ok = (best <= max_dist) & (best.astype(jnp.float32) <= ratio * second.astype(jnp.float32))
    if mutual:
        idx_b = masked_argmin(dist.T, mask.T)[0]
        ok = ok & (idx_b[idx] == jnp.arange(idx.shape[0]))
    return idx, ok, best
