"""Native stereo rectification vs the cv2 oracle (setup-time math)."""

import cv2
import numpy as np
import pytest

from openvo_jax.geometry.rectify import (
    init_undistort_rectify_map,
    stereo_rectify,
    undistort_points,
)

W, H = 640, 480


def kitti_like_calib(seed=0, distorted=True):
    rng = np.random.default_rng(seed)
    f = 520.0 + rng.uniform(-20, 20)
    K1 = np.array([[f, 0, W / 2 + rng.uniform(-5, 5)],
                   [0, f, H / 2 + rng.uniform(-5, 5)],
                   [0, 0, 1.0]])
    K2 = np.array([[f + rng.uniform(-5, 5), 0, W / 2 + rng.uniform(-5, 5)],
                   [0, f + rng.uniform(-5, 5), H / 2 + rng.uniform(-5, 5)],
                   [0, 0, 1.0]])
    if distorted:
        d1 = np.array([-0.28, 0.07, 1e-4, -2e-4, -0.003])
        d2 = np.array([-0.30, 0.08, -1e-4, 1e-4, -0.004])
    else:
        d1 = d2 = np.zeros(5)
    rvec = rng.normal(scale=0.01, size=3)
    R, _ = cv2.Rodrigues(rvec)
    T = np.array([-0.54, rng.normal(scale=0.002), rng.normal(scale=0.002)])
    return K1, d1, K2, d2, R, T


@pytest.mark.parametrize("seed,distorted", [(0, True), (1, True), (2, False)])
def test_stereo_rectify_vs_cv2(seed, distorted):
    K1, d1, K2, d2, R, T = kitti_like_calib(seed, distorted)
    cvR1, cvR2, cvP1, cvP2, cvQ, cvroi1, cvroi2 = cv2.stereoRectify(
        K1, d1, K2, d2, (W, H), R, T.reshape(3, 1)
    )
    R1, R2, P1, P2, Q, roi1, roi2 = stereo_rectify(K1, d1, K2, d2, (W, H), R, T)
    np.testing.assert_allclose(R1, cvR1, atol=1e-8)
    np.testing.assert_allclose(R2, cvR2, atol=1e-8)
    np.testing.assert_allclose(P1, cvP1, atol=1e-5)
    np.testing.assert_allclose(P2, cvP2, atol=1e-5)
    np.testing.assert_allclose(Q, cvQ, atol=1e-5)
    assert np.allclose(roi1, cvroi1, atol=1) and np.allclose(roi2, cvroi2, atol=1)


@pytest.mark.parametrize("seed", [0, 3])
def test_undistort_points_vs_cv2(seed):
    K1, d1, *_ = kitti_like_calib(seed)
    rng = np.random.default_rng(seed)
    pts = rng.uniform([0, 0], [W, H], size=(50, 2))
    ours = undistort_points(pts, K1, d1)
    ref = cv2.undistortPoints(pts.reshape(-1, 1, 2), K1, d1).reshape(-1, 2)
    np.testing.assert_allclose(ours, ref, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_rectify_maps_vs_cv2(seed):
    K1, d1, K2, d2, R, T = kitti_like_calib(seed)
    cvR1, _, cvP1, _, _, _, _ = cv2.stereoRectify(K1, d1, K2, d2, (W, H), R, T.reshape(3, 1))
    mx_cv, my_cv = cv2.initUndistortRectifyMap(
        K1, d1, cvR1, cvP1, (W, H), cv2.CV_32FC1
    )
    mx, my = init_undistort_rectify_map(K1, d1, cvR1, cvP1, (W, H))
    np.testing.assert_allclose(mx, mx_cv, atol=2e-3)
    np.testing.assert_allclose(my, my_cv, atol=2e-3)
