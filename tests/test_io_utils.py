"""IO + utils: pickle-compat calibration loading (reference
stereo_camera.py:7-14 contract), npz format, synthetic ground truth,
pose overlay rendering, and odometer checkpoint/resume."""

import numpy as np
import pytest

from openvo_jax import StereoCamera, StereoOdometer
from openvo_jax.config import SGBMParams
from openvo_jax.io.calib import save_npz, save_pfiles
from openvo_jax.io.synthetic import (
    gt_disparity,
    make_rig,
    render_stereo_sequence,
)
from openvo_jax.utils.draw_pose import drawPoseOnImage

SGBM = {
    "minDisparity": 0, "numDisparities": 64, "blockSize": 5,
    "P1": 200, "P2": 800, "disp12MaxDiff": 1, "preFilterCap": 63,
    "uniquenessRatio": 10, "speckleWindowSize": 0, "speckleRange": 0,
}
IMG_SIZE = (256, 192)


def test_from_pfiles_roundtrip(tmp_path):
    K, dist, R, T = make_rig(IMG_SIZE)
    paths = save_pfiles(str(tmp_path / "cal"), K, dist, K, dist, R, T, SGBM)
    cam = StereoCamera.from_pfiles(paths["left"], paths["right"],
                                   paths["rect"], paths["sgbm"], IMG_SIZE)
    assert cam.sgbm.num_disparities == 64
    assert cam.cropped_shape[0] > 0 and cam.cropped_shape[1] > 0
    np.testing.assert_allclose(cam.Q[2, 3], K[0, 0], rtol=1e-6)


def test_from_npz_roundtrip(tmp_path):
    K, dist, R, T = make_rig(IMG_SIZE)
    path = save_npz(str(tmp_path / "cal.npz"), K, dist, K, dist, R, T, SGBM)
    cam = StereoCamera.from_npz(path, IMG_SIZE)
    assert isinstance(cam.sgbm, SGBMParams)
    assert cam.sgbm.block_size == 5


def test_synthetic_gt_disparity_consistent():
    seq = render_stereo_sequence(n_frames=1, img_size=IMG_SIZE, f=280.0,
                                 baseline=0.5, seed=1)
    gt = gt_disparity(seq["depth"][0], 280.0, 0.5)
    # Corridor geometry: disparity positive and bounded by near geometry.
    assert (gt > 0).mean() > 0.99
    assert gt.max() < 300


def test_draw_pose_overlay_writes_red_text():
    img = np.zeros((240, 320, 3), np.uint8)
    T = np.eye(4)
    T[:3, 3] = [1.0, 2.0, 3.0]
    out = drawPoseOnImage(T, img)
    assert out is img  # in place, like the reference
    red = (img[..., 2] == 255) & (img[..., 0] == 0)
    assert red.sum() > 200  # text was rasterized
    # text lines sit at the reference's y offsets (baselines at
    # H-180/-120/-60/-10; glyphs extend up to ~28 px above a baseline)
    ys = np.where(red.any(axis=1))[0]
    assert ys.min() >= 240 - 180 - 30


def test_draw_pose_picks_smaller_branch():
    # A rotation where the two Euler branches differ: function must not crash
    # and must render finite values.
    import cv2
    R, _ = cv2.Rodrigues(np.array([0.1, 1.2, -0.4]))
    T = np.eye(4)
    T[:3, :3] = R
    img = np.zeros((240, 320, 3), np.uint8)
    drawPoseOnImage(T, img)
    assert img.any()


def test_checkpoint_resume(tmp_path):
    seq = render_stereo_sequence(n_frames=4, img_size=IMG_SIZE, f=280.0,
                                 baseline=0.5, seed=0, step=0.3)
    cam = StereoCamera(seq["K"], seq["dist"], seq["K"], seq["dist"],
                       {"R": seq["R"], "T": seq["T"]}, SGBM, IMG_SIZE)
    odo = StereoOdometer(cam, nfeatures=256)

    def u(o, i):
        l = np.clip(seq["left"][i], 0, 255).astype(np.uint8)
        r = np.clip(seq["right"][i], 0, 255).astype(np.uint8)
        return o.update(l, r)

    assert u(odo, 0) and u(odo, 1)
    ckpt = str(tmp_path / "state.npz")
    odo.save_state(ckpt)
    pose_before = odo.current_pose()

    odo2 = StereoOdometer(cam, nfeatures=256)
    odo2.load_state(ckpt)
    np.testing.assert_allclose(odo2.current_pose(), pose_before)
    # Both continue identically.
    r1 = u(odo, 2)
    r2 = u(odo2, 2)
    assert r1 == r2
    np.testing.assert_allclose(odo2.current_pose(), odo.current_pose(),
                               atol=1e-6)
