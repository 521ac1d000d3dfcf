"""SE(3) utility tests: rot2RPY both branches + gimbal lock, Rodrigues norm."""

import cv2
import numpy as np
import pytest

from openvo_jax.geometry import se3
from openvo_jax.utils.rot2rpy import rot2RPY


def rand_rotation(rng):
    rvec = rng.normal(size=3)
    R, _ = cv2.Rodrigues(rvec)
    return R


def make_T(R, t=(0.0, 0.0, 0.0)):
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


@pytest.mark.parametrize("seed", range(8))
def test_rot2rpy_reconstructs_rotation(seed):
    """Both Euler branches must reconstruct the original rotation matrix."""
    rng = np.random.default_rng(seed)
    R = rand_rotation(rng)
    roll, pitch, yaw = rot2RPY(make_T(R))
    for b in (0, 1):
        r, p, y = roll[b].item(), pitch[b].item(), yaw[b].item()
        Rx = cv2.Rodrigues(np.array([r, 0, 0]))[0]
        Ry = cv2.Rodrigues(np.array([0, p, 0]))[0]
        Rz = cv2.Rodrigues(np.array([0, 0, y]))[0]
        R_rec = Rz @ Ry @ Rx
        np.testing.assert_allclose(R_rec, R, atol=1e-4)


def test_rot2rpy_gimbal_lock():
    """cos_theta < 1e-4 branch: yaw = 0, pitch = -R20 * pi/2."""
    # pitch = +pi/2 -> R[2,0] = -1
    Ry = cv2.Rodrigues(np.array([0, np.pi / 2, 0]))[0]
    roll, pitch, yaw = rot2RPY(make_T(Ry))
    assert abs(yaw[0].item()) < 1e-6 and abs(yaw[1].item()) < 1e-6
    np.testing.assert_allclose(pitch.ravel(), [np.pi / 2, np.pi / 2], atol=1e-4)


def test_rot2rpy_shapes():
    roll, pitch, yaw = rot2RPY(np.eye(4))
    assert roll.shape == (2, 1) and pitch.shape == (2, 1) and yaw.shape == (2, 1)


@pytest.mark.parametrize("seed", range(8))
def test_rotation_magnitude_vs_rodrigues(seed):
    rng = np.random.default_rng(seed)
    R = rand_rotation(rng)
    rvec, _ = cv2.Rodrigues(R)
    ours = float(se3.rotation_magnitude(np.asarray(R, np.float64)))
    np.testing.assert_allclose(ours, np.linalg.norm(rvec), atol=1e-5)


def test_inverse_and_compose():
    rng = np.random.default_rng(0)
    T = make_T(rand_rotation(rng), rng.normal(size=3))
    Ti = np.asarray(se3.inverse(T.astype(np.float64)))
    np.testing.assert_allclose(Ti @ T, np.eye(4), atol=1e-5)  # f32


def test_rodrigues_vec_roundtrip():
    rng = np.random.default_rng(1)
    rvec = rng.normal(size=3)
    ours = np.asarray(se3.rodrigues_vec_to_R(rvec))
    ref, _ = cv2.Rodrigues(rvec)
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(se3.rodrigues_vec_to_R(np.zeros(3))), np.eye(3), atol=1e-7
    )
