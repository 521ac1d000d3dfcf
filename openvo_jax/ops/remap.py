"""Undistort/rectify remap: gather source pixels at map coordinates with
bilinear interpolation.

JAX replacement for ``cv2.remap(img, map1, map2, INTER_LINEAR)``
(reference stereo_camera.py:29-33; SURVEY.md N3). Border behavior matches
OpenCV's default BORDER_CONSTANT(0): any of the four neighbors falling outside
the source contributes value 0 with its bilinear weight.

The implementation is a single fused XLA program: one flattened gather of the
four neighbors plus a weighted sum. The whole remap fuses with the downstream grayscale/SGBM
pipeline stage under jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def remap_bilinear(src, map_x, map_y):
    """Sample ``src`` (H, W) or (H, W, C) at float coords (map_x, map_y).

    Returns an array shaped like (map_h, map_w[, C]) in float32.
    """
    squeeze = src.ndim == 2
    if squeeze:
        src = src[..., None]
    H, W, C = src.shape
    srcf = src.astype(jnp.float32)

    x = map_x.astype(jnp.float32)
    y = map_y.astype(jnp.float32)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    flat = srcf.reshape(H * W, C)

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = jnp.clip(yi, 0, H - 1) * W + jnp.clip(xi, 0, W - 1)
        vals = jnp.take(flat, idx.reshape(-1), axis=0).reshape(idx.shape + (C,))
        return jnp.where(valid[..., None], vals, 0.0)

    p00 = tap(y0i, x0i)
    p01 = tap(y0i, x0i + 1)
    p10 = tap(y0i + 1, x0i)
    p11 = tap(y0i + 1, x0i + 1)

    wx = fx[..., None]
    wy = fy[..., None]
    out = (
        p00 * (1 - wx) * (1 - wy)
        + p01 * wx * (1 - wy)
        + p10 * (1 - wx) * wy
        + p11 * wx * wy
    )
    return out[..., 0] if squeeze else out


def remap_u8(src, map_x, map_y):
    """remap_bilinear + round/clip back to uint8 (parity with cv2.remap on
    uint8 inputs, which rounds to nearest)."""
    out = remap_bilinear(src, map_x, map_y)
    return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)


def displacement_bounds(map_x, map_y):
    """Integer displacement bounds of a remap field: how far source samples
    stray from the identity. Computed once at setup time (maps are
    calibration constants). Returns (dx_min, dx_max, dy_min, dy_max)."""
    import numpy as np

    mx = np.asarray(map_x)
    my = np.asarray(map_y)
    h, w = mx.shape
    xs = np.arange(w, dtype=np.float32)[None, :]
    ys = np.arange(h, dtype=np.float32)[:, None]
    dx = np.floor(mx) - xs
    dy = np.floor(my) - ys
    dx = np.where(np.isfinite(dx), dx, 0)
    dy = np.where(np.isfinite(dy), dy, 0)
    return (int(dx.min()), int(dx.max()), int(dy.min()), int(dy.max()))


def remap_bilinear_bounded(src, map_x, map_y, bounds):
    """Bounded-displacement remap: rolls + selects instead of gather.

    Rectification maps displace pixels by a few dozen pixels at most; with
    the (setup-time) integer displacement bounds known, the 2-D gather
    becomes a sum over jointly-shifted copies selected per element:

        tap(y, x) = sum_{dy,dx} [floor(map)(y,x) - (y,x) == (dy,dx)]
                               * src[y+dy, x+dx]

    (the row and column selections must be joint — selecting rows first and
    then rolling columns would pick up the *shifted* column's row index).
    All four bilinear taps share each rolled copy. Pure roll/compare/
    accumulate — no gather. Border semantics match
    :func:`remap_bilinear` (BORDER_CONSTANT 0).
    """
    squeeze = src.ndim == 2
    H, W = src.shape[:2]
    # 2-D sources stay 2-D; channel broadcasting is applied only when real.
    ch = (lambda a: a) if squeeze else (lambda a: a[..., None])
    dx_min, dx_max, dy_min, dy_max = bounds
    srcf = src.astype(jnp.float32)

    x = map_x.astype(jnp.float32)
    y = map_y.astype(jnp.float32)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = ch(x - x0)
    fy = ch(y - y0)
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    cols = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    rows = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    u = x0i - cols  # in [dx_min, dx_max]
    v = y0i - rows  # in [dy_min, dy_max]

    z = jnp.zeros_like(srcf)
    p00 = p01 = p10 = p11 = z
    for dy in range(dy_min, dy_max + 2):
        rolled_y = jnp.roll(srcf, -dy, axis=0)
        sel_v0 = v == dy        # this copy is row y0 for these pixels
        sel_v1 = v == dy - 1    # ... and row y0+1 for these
        for dx in range(dx_min, dx_max + 2):
            r = jnp.roll(rolled_y, -dx, axis=1)
            sel_u0 = u == dx
            sel_u1 = u == dx - 1
            p00 = jnp.where(ch(sel_v0 & sel_u0), r, p00)
            p01 = jnp.where(ch(sel_v0 & sel_u1), r, p01)
            p10 = jnp.where(ch(sel_v1 & sel_u0), r, p10)
            p11 = jnp.where(ch(sel_v1 & sel_u1), r, p11)

    def ok(xi, yi):
        return ch((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H))

    p00 = jnp.where(ok(x0i, y0i), p00, 0.0)
    p01 = jnp.where(ok(x0i + 1, y0i), p01, 0.0)
    p10 = jnp.where(ok(x0i, y0i + 1), p10, 0.0)
    p11 = jnp.where(ok(x0i + 1, y0i + 1), p11, 0.0)

    return (
        p00 * (1 - fx) * (1 - fy)
        + p01 * fx * (1 - fy)
        + p10 * (1 - fx) * fy
        + p11 * fx * fy
    )


# Displacement ranges beyond which roll+select loses to the plain gather.
MAX_BOUNDED_DX = 32
MAX_BOUNDED_DY = 16
MAX_BOUNDED_AREA = 256  # (dx range+1) * (dy range+1) roll passes


def make_remap(map_x, map_y):
    """Choose the best remap implementation for these (constant) maps:
    bounded roll+select when displacements are small (the typical
    rectification case), generic gather otherwise."""
    bounds = displacement_bounds(map_x, map_y)
    dx_min, dx_max, dy_min, dy_max = bounds
    area = (dx_max - dx_min + 2) * (dy_max - dy_min + 2)
    if (dx_max - dx_min) <= MAX_BOUNDED_DX and \
            (dy_max - dy_min) <= MAX_BOUNDED_DY and area <= MAX_BOUNDED_AREA:
        return lambda src: remap_bilinear_bounded(src, map_x, map_y, bounds)
    return lambda src: remap_bilinear(src, map_x, map_y)
