"""Disparity -> 3D reprojection via the Q matrix.

JAX replacement for ``cv2.reprojectImageTo3D`` (reference
stereo_camera.py:52). Semantics to preserve (SURVEY.md N5): the homogeneous
divide is plain IEEE float division, so invalid/zero disparities naturally
produce +/-inf coordinates (W == 0) or huge values, which the downstream
inf-aware bilinear sampler (reference stereo_odometer.py:50-79) filters out.
"""

from __future__ import annotations

import jax.numpy as jnp


def reproject_image_to_3d(disparity, Q):
    """Map a (H, W) float disparity image to (H, W, 3) 3D points.

    [X, Y, Z, W]^T = Q @ [x, y, d(x,y), 1]^T ; output = (X/W, Y/W, Z/W).

    Division is unguarded on purpose: W == 0 (e.g. d == 0 under a
    zero-disparity rectification where Q[3,3] == 0) yields inf, matching
    OpenCV + the reference's reliance on ``np.isinf`` checks.
    """
    H, W = disparity.shape
    Q = jnp.asarray(Q, dtype=jnp.float32)
    x = jnp.arange(W, dtype=jnp.float32)[None, :].repeat(H, axis=0)
    y = jnp.arange(H, dtype=jnp.float32)[:, None].repeat(W, axis=1)
    d = disparity.astype(jnp.float32)
    ones = jnp.ones_like(d)
    # (H, W, 4) homogeneous input; contract with Q on the last axis.
    v = jnp.stack([x, y, d, ones], axis=-1)
    out = jnp.einsum("ij,hwj->hwi", Q, v)
    w = out[..., 3]
    return out[..., :3] / w[..., None]
