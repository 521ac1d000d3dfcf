"""End-to-end integration: full StereoOdometer tracking loop on a synthetic
sequence, with the actual reference openVO (OpenCV-backed, imported from
/root/reference as a black-box oracle) providing the parity trajectory, plus
the skip/fallback state-machine tests from SURVEY.md section 4."""

import sys

import numpy as np
import pytest

from openvo_jax import OdometerConfig, StereoCamera, StereoOdometer
from openvo_jax.config import (
    SKIP_BIGDIST,
    SKIP_BIGROT,
    SKIP_NAN,
    SKIP_OUTLIER,
    SKIP_RIGIDITY,
)
from openvo_jax.io.synthetic import render_stereo_sequence
from openvo_jax.models.stereo_odometer import make_point_cloud_transform

IMG_SIZE = (320, 240)
F = 280.0
BASELINE = 0.5
STEP = 0.3
SGBM = {
    "minDisparity": 0, "numDisparities": 96, "blockSize": 5,
    "P1": 200, "P2": 800, "disp12MaxDiff": 1, "preFilterCap": 63,
    "uniquenessRatio": 10, "speckleWindowSize": 0, "speckleRange": 0,
}


def make_sequence(n=10, seed=0, step=STEP):
    return render_stereo_sequence(n_frames=n, img_size=IMG_SIZE, f=F,
                                  baseline=BASELINE, seed=seed, step=step,
                                  yaw_rate=0.006)


def make_camera():
    seq = make_sequence(1)
    return StereoCamera(seq["K"], seq["dist"], seq["K"], seq["dist"],
                        {"R": seq["R"], "T": seq["T"]}, SGBM, IMG_SIZE)


def run_trajectory(odo, seq):
    poses, oks = [], []
    n = len(seq["left"])
    for i in range(n):
        left = np.clip(seq["left"][i], 0, 255).astype(np.uint8)
        right = np.clip(seq["right"][i], 0, 255).astype(np.uint8)
        oks.append(odo.update(left, right))
        poses.append(odo.current_pose())
    return np.stack(poses), oks


def ate(poses, gt):
    """Mean translational error after aligning first frames (both start at
    identity here)."""
    return float(np.mean(np.linalg.norm(
        poses[:, :3, 3] - gt[: len(poses), :3, 3], axis=1)))


@pytest.fixture(scope="module")
def camera():
    return make_camera()


@pytest.fixture(scope="module")
def seq():
    return make_sequence(10)


def test_tracking_succeeds_and_matches_ground_truth(camera, seq):
    odo = StereoOdometer(camera)
    poses, oks = run_trajectory(odo, seq)
    assert oks[0] is True
    assert sum(oks) >= 9, f"tracking failures: {oks}"
    path_len = STEP * (len(poses) - 1)
    err = ate(poses, seq["T_wc"])
    assert err < 0.15 * path_len + 0.05, f"ATE {err:.3f} over path {path_len:.2f}"


def test_parity_with_reference_openvo(camera, seq):
    """Run the real reference library on identical frames; our trajectory
    must be in the same accuracy class (BASELINE.md: ATE within 5% of the
    reference's)."""
    sys.path.insert(0, "/root/reference/src")
    try:
        from openVO import StereoOdometer as RefOdometer
        from openVO.stereo_camera import StereoCamera as RefCamera
    finally:
        sys.path.pop(0)

    ref_cam = RefCamera(seq["K"], seq["dist"], seq["K"], seq["dist"],
                        {"R": seq["R"], "T": seq["T"].reshape(3, 1)},
                        SGBM, IMG_SIZE)
    ref_odo = RefOdometer(ref_cam)
    ref_poses = []
    for i in range(len(seq["left"])):
        left = np.clip(seq["left"][i], 0, 255).astype(np.uint8)
        right = np.clip(seq["right"][i], 0, 255).astype(np.uint8)
        ref_odo.update(left, right)
        ref_poses.append(ref_odo.current_pose())
    ref_poses = np.stack(ref_poses)

    odo = StereoOdometer(camera)
    poses, _ = run_trajectory(odo, seq)

    gt = seq["T_wc"]
    path_len = STEP * (len(poses) - 1)
    ref_ate = ate(ref_poses, gt)
    our_ate = ate(poses, gt)
    # Same accuracy class: within 5% of path length of each other.
    assert our_ate <= ref_ate + 0.05 * path_len, (
        f"ours {our_ate:.4f} vs reference {ref_ate:.4f} (path {path_len:.2f})"
    )


def test_skip_keypoints_on_blank_frames(camera):
    odo = StereoOdometer(camera)
    w, h = IMG_SIZE
    blank = np.full((h, w), 100, np.uint8)
    assert odo.update(blank, blank) is False
    assert odo.skip_cause == "keypoints"
    assert odo.skipped_frames == 1
    assert odo.update(blank, blank) is False
    assert odo.skipped_frames == 2


def test_skip_matches_then_recovery(camera):
    seqA = make_sequence(3, seed=0)
    seqB = make_sequence(1, seed=99)  # different texture -> no matches
    odo = StereoOdometer(camera)
    def u(s, i):
        l = np.clip(s["left"][i], 0, 255).astype(np.uint8)
        r = np.clip(s["right"][i], 0, 255).astype(np.uint8)
        return odo.update(l, r)

    assert u(seqA, 0) is True        # first frame
    assert u(seqA, 1) is True        # tracked
    ok_b = u(seqB, 0)                # unrelated scene
    assert ok_b is False
    assert odo.skip_cause in ("matches", "bigdist", "bigrot", "rigidity",
                              "outlier", "nan")
    assert odo.skipped_frames == 1
    # State must NOT have rolled: matching seqA frame 2 still works (against
    # the last accepted frame, seqA frame 1).
    assert u(seqA, 2) is True
    assert odo.skipped_frames == 0


def test_pose_is_right_handed_rigid(camera, seq):
    odo = StereoOdometer(camera)
    poses, _ = run_trajectory(odo, seq)
    for P in poses:
        R = P[:3, :3]
        assert np.allclose(R @ R.T, np.eye(3), atol=1e-4)
        assert np.linalg.det(R) > 0.9


# ---------------------------------------------------------------------------
# Skip-cause gating semantics (unit level, crafted point clouds)
# ---------------------------------------------------------------------------


def pts_pair(n=32, seed=0, t=(0.05, 0, 0)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    b = a + np.asarray(t, np.float32)
    return a, b, np.ones(n, bool)


def run_pct(cfg, a, b, mask, skipped=0, code_in=0):
    import jax.numpy as jnp
    fn = make_point_cloud_transform(cfg)
    T, ok, code = fn(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask),
                     jnp.asarray(skipped, jnp.int32),
                     jnp.asarray(code_in, jnp.int32))
    return np.asarray(T), bool(ok), int(code)


def test_gate_bigdist_and_relaxation():
    cfg = OdometerConfig()
    a, b, m = pts_pair(t=(1.5, 0, 0))
    T, ok, code = run_pct(cfg, a, b, m, skipped=0)
    assert not ok and code == SKIP_BIGDIST
    # gate scales with skipped+1 (reference :215-216)
    T, ok, code = run_pct(cfg, a, b, m, skipped=1)
    assert ok


def test_gate_bigrot_overwrites_bigdist():
    cfg = OdometerConfig()
    rng = np.random.default_rng(1)
    a = rng.uniform(-3, 3, size=(32, 3)).astype(np.float32)
    # large rotation + large translation -> both gates fire -> "bigrot" wins
    ang = 1.5
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    b = a @ R.T + np.float32([2.0, 0, 0])
    T, ok, code = run_pct(cfg, a, b, np.ones(32, bool))
    assert not ok and code == SKIP_BIGROT


def test_gate_nan():
    cfg = OdometerConfig()
    a, b, m = pts_pair()
    a[4] = np.nan  # NaN sampled point poisons the fit (default: no filters)
    T, ok, code = run_pct(cfg, a, b, m)
    assert not ok and code == SKIP_NAN


def test_gate_rigidity_and_success_keeps_cause():
    # min_matches=5 < 10: rigidity cause set, but the fit may still succeed
    # (reference quirk: skip_cause remains "rigidity" on a successful frame).
    cfg = OdometerConfig(rigidity_threshold=0.01, min_matches=5)
    rng = np.random.default_rng(2)
    a = rng.uniform(-3, 3, size=(16, 3)).astype(np.float32)
    b = a + np.float32([0.05, 0, 0])
    # corrupt most points so the clique keeps < 10 but >= 5
    b[8:] += rng.uniform(0.5, 1.0, size=(8, 3)).astype(np.float32)
    T, ok, code = run_pct(cfg, a, b, np.ones(16, bool))
    assert code == SKIP_RIGIDITY
    assert ok  # still succeeded with >= min_matches clique


def test_gate_outlier():
    cfg = OdometerConfig(outlier_threshold=0.01, min_matches=10)
    a, b, m = pts_pair(n=12, t=(0.05, 0, 0))
    # Massive spread of residuals: filter keeps < min_matches
    b[6:] += np.linspace(1, 3, 6)[:, None].astype(np.float32)
    T, ok, code = run_pct(cfg, a, b, m)
    assert not ok and code in (SKIP_OUTLIER, SKIP_NAN)


def test_color_input_path(camera):
    """BGR 3-channel input goes through the in-graph grayscale conversion
    (reference stereo_camera.py:44-47) and tracks identically to gray."""
    seqc = make_sequence(3)
    odo_g = StereoOdometer(camera)
    odo_c = StereoOdometer(camera)
    for i in range(3):
        l = np.clip(seqc["left"][i], 0, 255).astype(np.uint8)
        r = np.clip(seqc["right"][i], 0, 255).astype(np.uint8)
        lc = np.stack([l] * 3, axis=-1)
        rc = np.stack([r] * 3, axis=-1)
        ok_g = odo_g.update(l, r)
        ok_c = odo_c.update(lc, rc)
        assert ok_g == ok_c
    np.testing.assert_allclose(odo_c.current_pose(), odo_g.current_pose(),
                               atol=1e-3)


def test_reference_attribute_surface(camera):
    """Full reference frame-state attribute surface (reference
    stereo_odometer.py:17-25): current/prev img, disparity, 3d, kps, desc —
    plus the dead-but-public valid_distance_change (:43-48)."""
    seq3 = make_sequence(3)
    odo = StereoOdometer(camera)
    Hc, Wc = camera.cropped_shape
    for i in range(2):
        l = np.clip(seq3["left"][i], 0, 255).astype(np.uint8)
        r = np.clip(seq3["right"][i], 0, 255).astype(np.uint8)
        assert odo.update(l, r)
    assert odo.current_img.shape == (Hc, Wc)
    assert odo.prev_img.shape == (Hc, Wc)
    assert odo.current_disparity.shape == (Hc, Wc)
    assert odo.prev_disparity.shape == (Hc, Wc)
    assert odo.current_3d.shape == (Hc, Wc, 3)
    assert odo.prev_3d.shape == (Hc, Wc, 3)
    # frames rolled: prev_img is frame 0's crop, current_img is frame 1's
    assert not np.array_equal(odo.current_img, odo.prev_img)
    assert odo.current_img.std() > 1.0  # real image content, not zeros
    assert len(odo.current_kps) >= 10 and len(odo.prev_kps) >= 10
    assert odo.current_desc.shape[1] == 32
    # valid_distance_change: same scene depth -> small change -> True
    assert odo.valid_distance_change(0, 0) in (True, False)
    kp = odo.prev_kps[0]
    assert 0 <= kp[0] < Wc and 0 <= kp[1] < Hc


def test_undistort_rectify_uint8_dtype(camera):
    """uint8 in -> uint8 out, float in -> float32 out, like cv2.remap
    (reference stereo_camera.py:29-33)."""
    w, h = IMG_SIZE
    rng = np.random.default_rng(0)
    img8 = rng.integers(0, 255, size=(h, w), dtype=np.uint8)
    out8 = np.asarray(camera.undistort_rectify_left(img8))
    assert out8.dtype == np.uint8
    outf = np.asarray(camera.undistort_rectify_right(img8.astype(np.float32)))
    assert outf.dtype == np.float32
    # uint8 path is the rounded float path
    ref = np.asarray(camera.undistort_rectify_left(img8.astype(np.float32)))
    np.testing.assert_array_equal(out8, np.clip(np.round(ref), 0, 255))


def test_reference_helper_methods(camera):
    """The reference's public helper methods exist and behave (feature_mask,
    bilinear_interpolate_pixels, rigid_body_filter, point_cloud_transform)."""
    odo = StereoOdometer(camera, rigidity_threshold=0.05)
    disp = np.array([[3.0, 4.0], [100.0, 101.0]])
    m = odo.feature_mask(disp)
    np.testing.assert_array_equal(m, [[0, 255], [255, 0]])

    img = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
    v = odo.bilinear_interpolate_pixels(img, 0.5, 0.5)
    np.testing.assert_allclose(v, img.reshape(4, 3).mean(axis=0))

    rng = np.random.default_rng(0)
    a = rng.uniform(-2, 2, (20, 3)).astype(np.float32)
    b = a + np.float32([0.05, 0, 0])
    b[:4] += 1.0  # non-rigid outliers
    clique = odo.rigid_body_filter(a, b)
    assert clique[:4].sum() == 0 and clique[4:].sum() >= 14

    T = odo.point_cloud_transform(a[4:], b[4:])
    assert T is not None
    np.testing.assert_allclose(T[:3, 3], [0.05, 0, 0], atol=1e-3)
    # failure path returns None and sets skip_cause
    big = odo.point_cloud_transform(a[4:], a[4:] + np.float32([5, 0, 0]))
    assert big is None and odo.skip_cause == "bigdist"
