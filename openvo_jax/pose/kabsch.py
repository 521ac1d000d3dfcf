"""Masked rigid 3D-3D alignment (Kabsch / Umeyama with rotation forced).

JAX replacement for ``cv2.estimateAffine3D(src, dst,
force_rotation=True)`` as used at reference stereo_odometer.py:190,204
(SURVEY.md N9). The reference discards the returned scale and uses the rigid
[R|t]; we therefore fit the pure rigid transform (scale = 1): R from the SVD
of the masked cross-covariance, t = mean(dst) - R @ mean(src).

Operates on fixed-capacity padded point arrays with a validity mask so it
jit-compiles with static shapes and vmaps over RANSAC hypotheses.
"""

from __future__ import annotations

import jax.numpy as jnp


def transform_points(T, pts):
    """Apply 4x4 ``T`` to (N, 3) points."""
    return pts @ T[:3, :3].T + T[:3, 3]


def kabsch(src, dst, mask):
    """Best-fit rigid transform mapping ``src`` -> ``dst`` over masked rows.

    Args:
      src, dst: (N, 3) float arrays (padded; invalid rows arbitrary, even
        inf/NaN — they are zeroed out before entering the reduction).
      mask: (N,) bool validity.

    Returns:
      T: (4, 4) float32 rigid transform. If fewer than 3 valid points (or a
      degenerate covariance) the SVD may produce NaNs — propagated on purpose,
      because the reference has an explicit downstream NaN gate
      (stereo_odometer.py:207-209).
    """
    w = mask.astype(jnp.float32)[:, None]
    n = jnp.maximum(jnp.sum(w), 1.0)
    # Zero non-finite *padding*; NaNs in valid rows are kept so they poison
    # the fit into a NaN transform, which the reference's "nan" skip gate
    # (stereo_odometer.py:207-209) then catches.
    src_c = jnp.where(w > 0, src, 0.0)
    dst_c = jnp.where(w > 0, dst, 0.0)
    mu_s = jnp.sum(src_c, axis=0) / n
    mu_d = jnp.sum(dst_c, axis=0) / n
    X = (src_c - mu_s) * w
    Y = (dst_c - mu_d) * w
    H = X.T @ Y  # (3, 3) cross-covariance
    U, _, Vt = jnp.linalg.svd(H)
    d = jnp.sign(jnp.linalg.det(Vt.T @ U.T))
    D = jnp.diag(jnp.stack([jnp.ones_like(d), jnp.ones_like(d), d]))
    R = Vt.T @ D @ U.T
    t = mu_d - R @ mu_s
    T = jnp.eye(4, dtype=jnp.float32)
    T = T.at[:3, :3].set(R.astype(jnp.float32))
    T = T.at[:3, 3].set(t.astype(jnp.float32))
    # Mirror the reference's failure mode: with < 3 valid points the problem
    # is underdetermined; force NaNs so the downstream "nan" gate fires.
    bad = jnp.sum(mask) < 3
    return jnp.where(bad, jnp.full((4, 4), jnp.nan, jnp.float32), T)


def residuals_relative(T, src, dst, mask):
    """Reference outlier-pass residual: ||h_dst - T @ h_src|| / ||h_dst||
    over homogeneous 4-vectors (stereo_odometer.py:192-195)."""
    hs = jnp.concatenate([src, jnp.ones((src.shape[0], 1), src.dtype)], axis=1)
    hd = jnp.concatenate([dst, jnp.ones((dst.shape[0], 1), dst.dtype)], axis=1)
    pred = hs @ T.T
    err = jnp.linalg.norm(hd - pred, axis=1) / jnp.linalg.norm(hd, axis=1)
    return jnp.where(mask, err, jnp.inf)
