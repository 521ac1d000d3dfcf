"""Monocular VO path: essential-matrix RANSAC + recoverPose vs cv2 oracle
and on a rendered mono sequence (BASELINE config 3)."""

import cv2
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from openvo_jax.io.synthetic import render_stereo_sequence
from openvo_jax.models.mono_odometer import MonoOdometer
from openvo_jax.pose.ransac import (
    ransac_essential,
    ransac_essential_5pt,
    ransac_rigid,
    recover_pose,
    sampson_error,
)


def synthetic_two_view(seed=0, n=200, noise=0.0, outliers=0):
    """Normalized correspondences from a random rigid two-view geometry."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -2, 4], [2, 2, 12], size=(n, 3))
    rvec = rng.normal(scale=0.05, size=3)
    R, _ = cv2.Rodrigues(rvec)
    t = np.array([0.5, 0.05, 0.1]) + rng.normal(scale=0.02, size=3)
    p2 = pts @ R.T + t
    x1 = pts[:, :2] / pts[:, 2:3] + rng.normal(scale=noise, size=(n, 2))
    x2 = p2[:, :2] / p2[:, 2:3] + rng.normal(scale=noise, size=(n, 2))
    if outliers:
        x2[:outliers] = rng.uniform(-0.5, 0.5, size=(outliers, 2))
    return (x1.astype(np.float32), x2.astype(np.float32), R, t)


@pytest.mark.parametrize("seed", [0, 1])
def test_essential_and_recover_pose_exact(seed):
    x1, x2, R_true, t_true = synthetic_two_view(seed)
    mask = np.ones(len(x1), bool)
    key = jax.random.PRNGKey(seed)
    E, inl, n_inl = ransac_essential(jnp.asarray(x1), jnp.asarray(x2),
                                     jnp.asarray(mask), key,
                                     iters=128, inlier_threshold=1e-6)
    assert int(n_inl) > 0.9 * len(x1)
    R, t, support = recover_pose(E, jnp.asarray(x1), jnp.asarray(x2), inl)
    R, t = np.asarray(R), np.asarray(t)
    # recoverPose convention: x2 ~ R x1 + t with ||t|| = 1
    np.testing.assert_allclose(R, R_true, atol=5e-3)
    t_dir = t_true / np.linalg.norm(t_true)
    assert np.linalg.norm(t - t_dir) < 5e-2 or np.linalg.norm(t + t_dir) < 5e-2


def test_essential_with_outliers_and_vs_cv2():
    x1, x2, R_true, t_true = synthetic_two_view(2, n=200, noise=1e-4,
                                                outliers=40)
    mask = np.ones(len(x1), bool)
    key = jax.random.PRNGKey(0)
    E, inl, n_inl = ransac_essential(jnp.asarray(x1), jnp.asarray(x2),
                                     jnp.asarray(mask), key,
                                     iters=256, inlier_threshold=1e-5)
    inl = np.asarray(inl)
    assert inl[:40].sum() <= 4          # planted outliers rejected
    assert inl[40:].mean() > 0.8        # true matches kept

    # cv2 oracle on the same data (identity K = normalized coords)
    E_cv, mask_cv = cv2.findEssentialMat(
        x1, x2, np.eye(3), method=cv2.RANSAC, prob=0.999, threshold=3e-3
    )
    _, R_cv, t_cv, _ = cv2.recoverPose(E_cv, x1, x2, np.eye(3),
                                       mask=mask_cv.copy())
    R, t, _ = recover_pose(E, jnp.asarray(x1), jnp.asarray(x2),
                           jnp.asarray(inl))
    np.testing.assert_allclose(np.asarray(R), R_cv, atol=2e-2)
    np.testing.assert_allclose(np.abs(np.asarray(t)), np.abs(t_cv.ravel()),
                               atol=5e-2)


def test_sampson_error_zero_for_exact_geometry():
    x1, x2, R, t = synthetic_two_view(3)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = tx @ R
    err = np.asarray(sampson_error(jnp.asarray(E, jnp.float32),
                                   jnp.asarray(x1), jnp.asarray(x2)))
    assert np.median(err) < 1e-8


def test_ransac_rigid_rejects_outliers():
    rng = np.random.default_rng(4)
    src = rng.uniform(-3, 3, size=(64, 3)).astype(np.float32)
    R, _ = cv2.Rodrigues(rng.normal(scale=0.1, size=3))
    t = rng.normal(scale=0.3, size=3)
    dst = (src @ R.T + t).astype(np.float32)
    dst[:10] += rng.uniform(1, 2, size=(10, 3)).astype(np.float32)
    T, inl, n = ransac_rigid(jnp.asarray(src), jnp.asarray(dst),
                             jnp.ones(64, bool), jax.random.PRNGKey(1),
                             iters=64, inlier_threshold=0.05)
    inl = np.asarray(inl)
    assert inl[:10].sum() == 0 and inl[10:].mean() > 0.9
    np.testing.assert_allclose(np.asarray(T)[:3, :3], R, atol=1e-3)


def _planar_two_view(seed=7, n=200):
    rng = np.random.default_rng(seed)
    # points on the z = 6 plane
    pts = np.c_[rng.uniform(-3, 3, size=(n, 2)), np.full(n, 6.0)]
    R_true = np.eye(3)
    t_true = np.array([0.4, 0.0, 0.1])
    p2 = pts @ R_true.T + t_true
    x1 = (pts[:, :2] / pts[:, 2:3]).astype(np.float32)
    x2 = (p2[:, :2] / p2[:, 2:3]).astype(np.float32)
    return x1, x2, R_true, t_true


def test_five_point_minimal_solver_contains_truth():
    """The Nister 5-point minimal solver's candidate set must contain the
    true essential matrix for an exact 5-correspondence sample."""
    from openvo_jax.pose.fivepoint import five_point_candidates

    x1, x2, R, t = synthetic_two_view(5, n=5)
    Es, valid = jax.jit(five_point_candidates)(jnp.asarray(x1),
                                               jnp.asarray(x2))
    Es, valid = np.asarray(Es), np.asarray(valid)
    assert valid.any()
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E_true = tx @ R
    E_true /= np.linalg.norm(E_true)
    errs = [min(np.linalg.norm(E - E_true), np.linalg.norm(E + E_true))
            for E, v in zip(Es, valid) if v]
    assert min(errs) < 5e-3, errs


def test_planar_scene_recovered_by_five_point():
    """All-planar scene (the 8-point DLT's degenerate case): 5-point +
    cheirality must recover the TRUE pose, matching cv2.findEssentialMat's Nister engine."""
    x1, x2, R_true, t_true = _planar_two_view()
    mask = np.ones(len(x1), bool)
    E, inl, n_inl = ransac_essential_5pt(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask),
        jax.random.PRNGKey(0), iters=64, inlier_threshold=1e-6)
    assert int(n_inl) > 0.9 * len(x1), int(n_inl)
    R, t, support = recover_pose(E, jnp.asarray(x1), jnp.asarray(x2), inl)
    R, t = np.asarray(R), np.asarray(t)
    assert np.isfinite(R).all() and np.isfinite(t).all()
    np.testing.assert_allclose(R, R_true, atol=0.02)
    t_dir = t_true / np.linalg.norm(t_true)
    assert min(np.linalg.norm(t - t_dir), np.linalg.norm(t + t_dir)) < 0.1
    assert int(support.sum()) > 0.8 * len(x1)


def test_five_point_matches_cv2_on_general_scene():
    """Parity vs cv2.findEssentialMat(method=RANSAC) — the same Nister
    5-point engine — on a general (non-planar) scene with outliers."""
    x1, x2, R_true, t_true = synthetic_two_view(11, n=200, noise=1e-4,
                                                outliers=30)
    mask = np.ones(len(x1), bool)
    E, inl, n_inl = ransac_essential_5pt(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask),
        jax.random.PRNGKey(1), iters=64, inlier_threshold=1e-5)
    inl = np.asarray(inl)
    assert inl[:30].sum() <= 3
    assert inl[30:].mean() > 0.8
    E_cv, mask_cv = cv2.findEssentialMat(
        x1, x2, np.eye(3), method=cv2.RANSAC, prob=0.999, threshold=3e-3)
    _, R_cv, t_cv, _ = cv2.recoverPose(E_cv, x1, x2, np.eye(3),
                                       mask=mask_cv.copy())
    R, t, _ = recover_pose(E, jnp.asarray(x1), jnp.asarray(x2),
                           jnp.asarray(inl))
    np.testing.assert_allclose(np.asarray(R), R_cv, atol=2e-2)
    np.testing.assert_allclose(np.abs(np.asarray(t)), np.abs(t_cv.ravel()),
                               atol=5e-2)


def test_mono_skip_cause_surface():
    """MonoOdometer reports failure causes like the stereo odometer."""
    seq = render_stereo_sequence(n_frames=2, img_size=(320, 240), f=280.0,
                                 baseline=0.5, seed=3, step=0.3)
    odo = MonoOdometer(seq["K"], nfeatures=300)
    img0 = np.clip(seq["left"][0], 0, 255).astype(np.uint8)
    assert odo.update(img0)          # first frame accepted
    assert odo.skip_cause == ""
    blank = np.full_like(img0, 127)
    assert odo.update(blank) is False
    assert odo.skip_cause in ("keypoints", "matches", "inliers", "support")
    assert odo.skipped_frames == 1


def test_mono_odometer_tracks_forward_motion():
    seq = render_stereo_sequence(n_frames=6, img_size=(320, 240), f=280.0,
                                 baseline=0.5, seed=0, step=0.3,
                                 yaw_rate=0.004)
    odo = MonoOdometer(seq["K"], nfeatures=300)
    for i in range(6):
        img = np.clip(seq["left"][i], 0, 255).astype(np.uint8)
        ok = odo.update(img, trans_scale=0.3)
        assert ok, f"frame {i} failed: {odo.last_stats}"
    pose = odo.current_pose()
    gt = seq["T_wc"][5]
    # Mono: direction + rotation should match; scale supplied externally.
    assert np.linalg.norm(pose[:3, 3] - gt[:3, 3]) < 0.45, (pose[:3, 3],
                                                            gt[:3, 3])
    np.testing.assert_allclose(pose[:3, :3], gt[:3, :3], atol=0.05)
