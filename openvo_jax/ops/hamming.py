"""Brute-force Hamming descriptor matching as one integer matmul.

JAX replacement for ``cv2.BFMatcher(NORM_HAMMING).knnMatch(d1, d2, k=2)``
(reference stereo_odometer.py:22,163; SURVEY.md N8).

The trick: with descriptors unpacked to 0/1 bit vectors a, b of length 256,

    hamming(a, b) = popcount(a XOR b) = sum(a) + sum(b) - 2 * dot(a, b)

so the full (N1, N2) distance matrix is one int8 matmul plus two
rank-1 broadcasts — no per-pair popcount loop. Top-2 per query is two masked
min-reductions.

Descriptors are carried packed as (N, 32) uint8 (same layout as OpenCV ORB
descriptors) and unpacked on the fly; the unpack is a cheap elementwise op that XLA
fuses into the matmul operand.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

BIG = np.int32(1 << 30)  # "infinite" distance for masked rows/cols


def unpack_bits(desc_u8):
    """(N, 32) uint8 packed descriptors -> (N, 256) int8 bits (LSB-first per
    byte, matching numpy.unpackbits(bitorder='little'))."""
    n = desc_u8.shape[0]
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (desc_u8[:, :, None] >> shifts[None, None, :]) & 1
    return bits.reshape(n, -1).astype(jnp.int8)


def pack_bits(bits):
    """(N, 256) 0/1 bits -> (N, 32) uint8, LSB-first per byte."""
    n, nb = bits.shape
    b = bits.reshape(n, nb // 8, 8).astype(jnp.uint8)
    shifts = jnp.arange(8, dtype=jnp.uint8)
    return jnp.sum(b << shifts[None, None, :], axis=-1).astype(jnp.uint8)


def hamming_distance_matrix(desc1, desc2, mask1=None, mask2=None):
    """Full (N1, N2) int32 Hamming distance matrix from packed descriptors.

    Invalid rows/cols (mask False) get distance BIG.
    """
    a = unpack_bits(desc1)  # (N1, 256) int8
    b = unpack_bits(desc2)  # (N2, 256) int8
    dot = jnp.dot(a, b.T, preferred_element_type=jnp.int32)
    sa = jnp.sum(a.astype(jnp.int32), axis=1, keepdims=True)
    sb = jnp.sum(b.astype(jnp.int32), axis=1, keepdims=True)
    d = sa + sb.T - 2 * dot
    if mask1 is not None:
        d = jnp.where(mask1[:, None], d, BIG)
    if mask2 is not None:
        d = jnp.where(mask2[None, :], d, BIG)
    return d


def knn2(desc1, desc2, mask1=None, mask2=None):
    """Top-2 nearest Hamming neighbors of every query descriptor.

    Returns (d1, i1, d2, i2): best/second-best distances (int32) and train
    indices (int32), each of shape (N1,). Masked-out queries get distance BIG.
    """
    d = hamming_distance_matrix(desc1, desc2, mask1, mask2)
    i1 = jnp.argmin(d, axis=1).astype(jnp.int32)
    d1 = jnp.take_along_axis(d, i1[:, None], axis=1)[:, 0]
    n2 = d.shape[1]
    onehot = jnp.arange(n2, dtype=jnp.int32)[None, :] == i1[:, None]
    d_masked = jnp.where(onehot, BIG, d)
    i2 = jnp.argmin(d_masked, axis=1).astype(jnp.int32)
    d2 = jnp.take_along_axis(d_masked, i2[:, None], axis=1)[:, 0]
    return d1, i1, d2, i2


def ratio_test_match(desc1, desc2, ratio, mask1=None, mask2=None):
    """kNN(k=2) + Lowe ratio test (reference stereo_odometer.py:163-164).

    A query i is a match iff d1 < ratio * d2 (strict, like the reference).
    Returns (train_idx (N1,) int32, match_mask (N1,) bool).
    """
    d1, i1, d2, _ = knn2(desc1, desc2, mask1, mask2)
    ok = d1.astype(jnp.float32) < ratio * d2.astype(jnp.float32)
    ok = ok & (d1 < BIG)
    if mask1 is not None:
        ok = ok & mask1
    return i1, ok
