"""Remap kernel + Q reprojection vs cv2 oracles."""

import cv2
import numpy as np
import pytest

from openvo_jax.geometry.reproject import reproject_image_to_3d
from openvo_jax.ops.remap import remap_bilinear, remap_u8


@pytest.mark.parametrize("seed", [0, 1])
def test_remap_float_vs_cv2(seed):
    rng = np.random.default_rng(seed)
    H, W = 120, 160
    src = rng.uniform(0, 255, size=(H, W)).astype(np.float32)
    # Smooth in-bounds-ish maps with some out-of-bounds samples.
    mx = (rng.uniform(-10, W + 10, size=(H, W))).astype(np.float32)
    my = (rng.uniform(-10, H + 10, size=(H, W))).astype(np.float32)
    ref = cv2.remap(src, mx, my, cv2.INTER_LINEAR)
    ours = np.asarray(remap_bilinear(src, mx, my))
    # cv2 quantizes map coords to 1/32 px internally; compare at matching
    # precision by excluding near-edge samples where quantization flips
    # the out-of-bounds decision.
    inb = (mx > 0.5) & (mx < W - 1.5) & (my > 0.5) & (my < H - 1.5)
    diff = np.abs(ours - ref)[inb]
    assert np.percentile(diff, 99) < 0.5
    assert diff.mean() < 0.1


def test_remap_color_and_u8():
    rng = np.random.default_rng(2)
    H, W = 64, 80
    src = rng.integers(0, 256, size=(H, W, 3)).astype(np.uint8)
    mx = rng.uniform(1, W - 2, size=(H, W)).astype(np.float32)
    my = rng.uniform(1, H - 2, size=(H, W)).astype(np.float32)
    ref = cv2.remap(src, mx, my, cv2.INTER_LINEAR)
    ours = np.asarray(remap_u8(src, mx, my))
    assert np.mean(np.abs(ours.astype(int) - ref.astype(int)) <= 1) > 0.99


def test_reproject_vs_cv2_including_inf():
    rng = np.random.default_rng(0)
    H, W = 60, 80
    disp = rng.uniform(1, 64, size=(H, W)).astype(np.float32)
    disp[10:20, 10:20] = 0.0    # -> W = 0 -> inf (zero-disparity rectification)
    disp[30:40, 30:40] = -1.0   # SGBM invalid marker
    f, B, cx, cy = 500.0, 0.54, 40.0, 30.0
    Q = np.array([
        [1, 0, 0, -cx],
        [0, 1, 0, -cy],
        [0, 0, 0, f],
        [0, 0, -1.0 / -B, 0.0],
    ])
    ref = cv2.reprojectImageTo3D(disp, Q)
    ours = np.asarray(reproject_image_to_3d(disp, Q))
    both_inf = np.isinf(ref) & np.isinf(ours)
    assert np.array_equal(np.isinf(ref), np.isinf(ours))
    finite = ~np.isinf(ref)
    np.testing.assert_allclose(ours[finite], ref[finite], rtol=1e-4, atol=1e-3)
    assert np.all(np.sign(ours[both_inf]) == np.sign(ref[both_inf]))
