"""Hamming matmul matcher vs cv2.BFMatcher oracle."""

import cv2
import numpy as np
import pytest

from openvo_jax.ops.hamming import (
    hamming_distance_matrix,
    knn2,
    pack_bits,
    ratio_test_match,
    unpack_bits,
)


def rand_desc(rng, n):
    return rng.integers(0, 256, size=(n, 32), dtype=np.uint8)


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    d = rand_desc(rng, 16)
    bits = np.asarray(unpack_bits(d))
    assert bits.shape == (16, 256)
    np.testing.assert_array_equal(np.asarray(pack_bits(bits)), d)


@pytest.mark.parametrize("seed", [0, 1])
def test_distance_matrix_exact(seed):
    rng = np.random.default_rng(seed)
    d1, d2 = rand_desc(rng, 40), rand_desc(rng, 50)
    ours = np.asarray(hamming_distance_matrix(d1, d2))
    ref = np.array(
        [[bin(int.from_bytes((a ^ b).tobytes(), "little")).count("1")
          for b in d2] for a in d1]
    )
    np.testing.assert_array_equal(ours, ref)


def test_knn2_vs_bfmatcher():
    rng = np.random.default_rng(2)
    d1, d2 = rand_desc(rng, 64), rand_desc(rng, 96)
    matcher = cv2.BFMatcher.create(cv2.NORM_HAMMING)
    ref = matcher.knnMatch(d1, d2, k=2)
    D1, I1, D2, _ = (np.asarray(x) for x in knn2(d1, d2))
    for i, (m0, m1) in enumerate(ref):
        assert D1[i] == int(m0.distance)
        assert D2[i] == int(m1.distance)
        # index may differ on exact ties; distance is the contract
        if D1[i] != D2[i]:
            assert I1[i] == m0.trainIdx


def test_ratio_test_counts_match_reference_filter():
    # Plant true correspondences: d2 rows are bit-flipped copies of d1 rows
    # (small Hamming distance), shuffled, plus random distractors. Random
    # descriptors alone never pass the 0.8 ratio (d ~ Binomial(256, 0.5)).
    rng = np.random.default_rng(3)
    d1 = rand_desc(rng, 128)
    perm = rng.permutation(128)
    flips = (rng.random((128, 32)) < 0.02) * rng.integers(
        0, 256, size=(128, 32), dtype=np.uint8
    )
    d2 = (d1 ^ flips.astype(np.uint8))[perm]
    d2[64:] = rand_desc(rng, 64)  # half become distractors
    matcher = cv2.BFMatcher.create(cv2.NORM_HAMMING)
    knn = matcher.knnMatch(d1, d2, k=2)
    ref_matches = [m[0] for m in knn if m[0].distance < 0.8 * m[1].distance]
    idx, ok = (np.asarray(x) for x in ratio_test_match(d1, d2, 0.8))
    assert int(ok.sum()) == len(ref_matches)
    ref_pairs = {(m.queryIdx, m.trainIdx) for m in ref_matches}
    got_pairs = {(int(q), int(idx[q])) for q in np.where(ok)[0]}
    # Ties can swap trainIdx; require >= 95% identical pairs.
    agree = len(ref_pairs & got_pairs) / max(len(ref_pairs), 1)
    assert agree >= 0.95


def test_masks_exclude_rows_and_cols():
    rng = np.random.default_rng(4)
    d1, d2 = rand_desc(rng, 32), rand_desc(rng, 32)
    m1 = np.zeros(32, bool)
    m1[:10] = True
    m2 = np.ones(32, bool)
    m2[5:] = False
    idx, ok = (np.asarray(x) for x in ratio_test_match(d1, d2, 0.99, m1, m2))
    assert not ok[10:].any()
    assert np.all(idx[ok] < 5)
