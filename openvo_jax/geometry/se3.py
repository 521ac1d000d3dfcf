"""SE(3) utilities: composition, inversion, rotation magnitude, RPY extraction.

JAX replacements for the reference's pose math:
 - ``cv2.Rodrigues`` rotation-magnitude gate (reference stereo_odometer.py:212,216,219)
   becomes the closed form ``arccos((tr(R)-1)/2)``.
 - ``rot2RPY`` (reference utils/rot2RPY.py:3-38) is re-implemented branchlessly with
   ``jnp.where`` so it jit-compiles, returning both Euler branches exactly like the
   reference (including the gimbal-lock branch when sqrt(R00^2+R10^2) < 1e-4).

All functions are pure jnp and work under jit/vmap.
"""

from __future__ import annotations

import jax.numpy as jnp


def compose(T_ab, T_bc):
    """Left-compose 4x4 homogeneous transforms (matmul)."""
    return T_ab @ T_bc


def inverse(T):
    """Closed-form inverse of a rigid 4x4 transform: [R t]^-1 = [R^T, -R^T t]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3:]
    Rt = jnp.swapaxes(R, -1, -2)
    top = jnp.concatenate([Rt, -Rt @ t], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=T.dtype), T.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def rotation_magnitude(R):
    """|rvec| of ``cv2.Rodrigues(R)``: the rotation angle arccos((tr(R)-1)/2).

    Replaces the reference's ``np.linalg.norm(cv2.Rodrigues(T[:3,:3])[0])``
    (stereo_odometer.py:212,216). Clipping guards arccos against fp drift.
    """
    tr = jnp.trace(R, axis1=-2, axis2=-1)
    c = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    return jnp.arccos(c)


def rt_to_T(R, t):
    """Stack R (3x3) and t (3,) into a 4x4 homogeneous transform."""
    t = t.reshape(R.shape[:-2] + (3, 1))
    top = jnp.concatenate([R, t], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), R.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def rodrigues_vec_to_R(rvec):
    """Axis-angle vector -> rotation matrix (Rodrigues formula), jit-safe at theta=0."""
    theta = jnp.linalg.norm(rvec, axis=-1, keepdims=True)
    safe = jnp.where(theta > 1e-12, theta, 1.0)
    k = rvec / safe
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zero = jnp.zeros_like(kx)
    K = jnp.stack(
        [
            jnp.stack([zero, -kz, ky], axis=-1),
            jnp.stack([kz, zero, -kx], axis=-1),
            jnp.stack([-ky, kx, zero], axis=-1),
        ],
        axis=-2,
    )
    th = theta[..., None]
    eye = jnp.eye(3, dtype=rvec.dtype)
    R = eye + jnp.sin(th) * K + (1.0 - jnp.cos(th)) * (K @ K)
    return jnp.where(th > 1e-12, R, eye)


def rot2rpy(T):
    """Roll/pitch/yaw of the rotation in ``T``; returns BOTH Euler branches.

    Behavior-exact rebuild of reference utils/rot2RPY.py:3-38, branchless for jit:
      * normal branch: pitch = atan2(-R20, +/-cos_theta), roll/yaw divided by
        cos(pitch) per branch;
      * gimbal-lock branch (cos_theta = sqrt(R00^2+R10^2) < 1e-4): both branches
        collapse to pitch = -R20*pi/2, roll = R20*atan2(-R01, R11), yaw = 0.

    Returns (roll, pitch, yaw), each shape (2, 1) like the reference.
    """
    R = T[..., :3, :3]
    r00, r01 = R[..., 0, 0], R[..., 0, 1]
    r10, r11 = R[..., 1, 0], R[..., 1, 1]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    cos_theta = jnp.sqrt(r00**2 + r10**2)
    locked = cos_theta < 1e-4

    # Normal branch
    pitch0 = jnp.arctan2(-r20, cos_theta)
    pitch1 = jnp.arctan2(-r20, -cos_theta)
    roll0 = jnp.arctan2(r21 / jnp.cos(pitch0), r22 / jnp.cos(pitch0))
    roll1 = jnp.arctan2(r21 / jnp.cos(pitch1), r22 / jnp.cos(pitch1))
    yaw0 = jnp.arctan2(r10 / jnp.cos(pitch0), r00 / jnp.cos(pitch0))
    yaw1 = jnp.arctan2(r10 / jnp.cos(pitch1), r00 / jnp.cos(pitch1))

    # Gimbal-lock branch (identical for both representations)
    pitch_l = -r20 * (jnp.pi / 2.0)
    roll_l = r20 * jnp.arctan2(-r01, r11)
    yaw_l = jnp.zeros_like(pitch_l)

    roll = jnp.stack(
        [jnp.where(locked, roll_l, roll0), jnp.where(locked, roll_l, roll1)], axis=-1
    )[..., :, None]
    pitch = jnp.stack(
        [jnp.where(locked, pitch_l, pitch0), jnp.where(locked, pitch_l, pitch1)],
        axis=-1,
    )[..., :, None]
    yaw = jnp.stack(
        [jnp.where(locked, yaw_l, yaw0), jnp.where(locked, yaw_l, yaw1)], axis=-1
    )[..., :, None]
    return roll, pitch, yaw
