"""Pose stack: Kabsch vs cv2.estimateAffine3D(force_rotation=True), outlier
gate vs numpy oracle, rigid clique vs numpy oracle of the reference alg."""

import cv2
import numpy as np
import pytest

from openvo_jax.pose.kabsch import kabsch, residuals_relative, transform_points
from openvo_jax.pose.outlier import masked_median, outlier_filter
from openvo_jax.pose.rigid_clique import rigid_body_filter


def rigid_scene(rng, n=60, noise=0.0):
    src = rng.uniform(-5, 5, size=(n, 3))
    rvec = rng.normal(scale=0.2, size=3)
    R, _ = cv2.Rodrigues(rvec)
    t = rng.normal(scale=0.5, size=3)
    dst = src @ R.T + t + rng.normal(scale=noise, size=(n, 3))
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return src, dst, T


@pytest.mark.parametrize("seed", range(5))
def test_kabsch_exact_recovery(seed):
    rng = np.random.default_rng(seed)
    src, dst, T_true = rigid_scene(rng)
    mask = np.ones(len(src), bool)
    T = np.asarray(kabsch(src.astype(np.float32), dst.astype(np.float32), mask))
    np.testing.assert_allclose(T, T_true, atol=1e-4)


@pytest.mark.parametrize("seed", range(3))
def test_kabsch_vs_cv2_with_noise(seed):
    rng = np.random.default_rng(seed + 10)
    src, dst, _ = rigid_scene(rng, noise=0.02)
    ref, scale = cv2.estimateAffine3D(src, dst, force_rotation=True)
    mask = np.ones(len(src), bool)
    T = np.asarray(kabsch(src.astype(np.float32), dst.astype(np.float32), mask))
    # Rotation parts must agree tightly; translation within noise scale.
    np.testing.assert_allclose(T[:3, :3], ref[:3, :3], atol=1e-3)
    np.testing.assert_allclose(T[:3, 3], ref[:3, 3], atol=2e-2)


def test_kabsch_masked_ignores_padding():
    rng = np.random.default_rng(1)
    src, dst, T_true = rigid_scene(rng, n=30)
    pad = np.full((10, 3), np.inf)
    src_p = np.vstack([src, pad]).astype(np.float32)
    dst_p = np.vstack([dst, pad]).astype(np.float32)
    mask = np.r_[np.ones(30, bool), np.zeros(10, bool)]
    T = np.asarray(kabsch(src_p, dst_p, mask))
    np.testing.assert_allclose(T, T_true, atol=1e-4)


def test_kabsch_nan_propagates_and_underdetermined():
    rng = np.random.default_rng(2)
    src, dst, _ = rigid_scene(rng, n=12)
    src[3] = np.nan  # a valid-but-NaN point must poison the fit
    mask = np.ones(12, bool)
    T = np.asarray(kabsch(src.astype(np.float32), dst.astype(np.float32), mask))
    assert np.isnan(T).any()
    # < 3 valid points -> NaN
    mask2 = np.zeros(12, bool)
    mask2[:2] = True
    T2 = np.asarray(kabsch(dst.astype(np.float32), dst.astype(np.float32), mask2))
    assert np.isnan(T2).any()


def test_masked_median_matches_numpy():
    rng = np.random.default_rng(3)
    for n in (5, 6, 1):
        vals = rng.normal(size=16).astype(np.float32)
        mask = np.zeros(16, bool)
        mask[:n] = True
        ours = float(masked_median(vals, mask))
        np.testing.assert_allclose(ours, np.median(vals[:n]), rtol=1e-6)
    # NaN contaminates like np.median
    vals = np.array([1.0, np.nan, 3.0, 0.0], np.float32)
    mask = np.array([True, True, True, False])
    assert np.isnan(float(masked_median(vals, mask)))


def test_outlier_filter_rejects_planted_outliers():
    rng = np.random.default_rng(4)
    src, dst, T_true = rigid_scene(rng, n=40, noise=0.005)
    dst[5] += 3.0
    dst[17] -= 2.5
    mask = np.ones(40, bool)
    out = np.asarray(outlier_filter(src.astype(np.float32),
                                    dst.astype(np.float32), mask, 0.1))
    assert not out[5] and not out[17]
    assert out.sum() >= 30


def test_outlier_filter_matches_numpy_oracle():
    rng = np.random.default_rng(5)
    src, dst, _ = rigid_scene(rng, n=25, noise=0.05)
    mask = np.ones(25, bool)
    srcf, dstf = src.astype(np.float32), dst.astype(np.float32)
    T = np.asarray(kabsch(srcf, dstf, mask))
    hs = np.hstack([src, np.ones((25, 1))])
    hd = np.hstack([dst, np.ones((25, 1))])
    errs = np.linalg.norm(hd - hs @ T.T, axis=1) / np.linalg.norm(hd, axis=1)
    thr = 0.1 + np.median(errs)
    ref_mask = errs < thr
    ours = np.asarray(outlier_filter(srcf, dstf, mask, 0.1))
    assert (ours == ref_mask).mean() >= 0.95


def reference_clique_oracle(prev_pts, pts, threshold):
    """Fresh numpy transcription of the documented reference algorithm
    (greedy max-clique on the distance-consistency graph)."""
    n = len(pts)
    d_now = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    d_prev = np.linalg.norm(prev_pts[:, None] - prev_pts[None, :], axis=-1)
    consistency = (np.abs(d_now - d_prev) < threshold).astype(int)
    clique = np.zeros(n, int)
    num_consistent = consistency.sum(axis=0)
    seed = int(np.argmax(num_consistent))
    clique[seed] = 1
    compatible = consistency[seed].copy()
    for _ in range(n):
        candidates = compatible - clique
        if candidates.sum() == 0:
            break
        sel = int(np.argmax(num_consistent * candidates))
        clique[sel] = 1
        compatible = (consistency @ clique >= clique.sum()).astype(int)
    return clique


@pytest.mark.parametrize("seed", range(4))
def test_rigid_clique_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    src, dst, _ = rigid_scene(rng, n=30, noise=0.002)
    # plant 6 non-rigid points
    dst[:6] += rng.normal(scale=1.0, size=(6, 3))
    ref = reference_clique_oracle(src, dst, 0.05)
    ours = np.asarray(
        rigid_body_filter(src.astype(np.float32), dst.astype(np.float32),
                          np.ones(30, bool), 0.05)
    )
    np.testing.assert_array_equal(ours, ref)
    assert ours[:6].sum() == 0  # outliers rejected


def test_rigid_clique_padding_excluded():
    rng = np.random.default_rng(9)
    src, dst, _ = rigid_scene(rng, n=20, noise=0.001)
    srcp = np.vstack([src, np.zeros((8, 3))]).astype(np.float32)
    dstp = np.vstack([dst, np.zeros((8, 3))]).astype(np.float32)
    mask = np.r_[np.ones(20, bool), np.zeros(8, bool)]
    ours = np.asarray(rigid_body_filter(srcp, dstp, mask, 0.05))
    assert ours[20:].sum() == 0
    assert ours[:20].sum() >= 18


def test_residuals_and_transform_points():
    rng = np.random.default_rng(6)
    src, dst, T = rigid_scene(rng, n=10)
    out = np.asarray(transform_points(T.astype(np.float32),
                                      src.astype(np.float32)))
    np.testing.assert_allclose(out, dst, atol=1e-4)
    res = np.asarray(residuals_relative(T.astype(np.float32),
                                        src.astype(np.float32),
                                        dst.astype(np.float32),
                                        np.ones(10, bool)))
    assert np.all(res < 1e-4)
