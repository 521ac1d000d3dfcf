"""Inf-aware bilinear sampler vs a fresh numpy oracle implementing the
reference semantics (stereo_odometer.py:50-79)."""

import numpy as np
import pytest

from openvo_jax.ops.interpolate import bilinear_sample_3d


def oracle(img, x, y):
    """Direct transcription of the documented reference behavior: renormalize
    bilinear weights over in-bounds, non-inf neighbors; 0/0 -> NaN."""
    fx, fy = int(x), int(y)
    h, w = img.shape[:2]
    taps = []
    taps.append((img[fy, fx], (1 - (x - fx)) * (1 - (y - fy))))
    if fx + 1 < w:
        taps.append((img[fy, fx + 1], (x - fx) * (1 - (y - fy))))
    if fy + 1 < h:
        taps.append((img[fy + 1, fx], (1 - (x - fx)) * (y - fy)))
    if fx + 1 < w and fy + 1 < h:
        taps.append((img[fy + 1, fx + 1], (x - fx) * (y - fy)))
    num, den = 0.0, 0.0
    for v, wgt in taps:
        if not np.isinf(v).any():
            num = num + wgt * v
            den = den + wgt
    with np.errstate(invalid="ignore", divide="ignore"):
        return num / den if den != 0 else np.full(3, np.nan)


@pytest.mark.parametrize("seed", range(4))
def test_matches_oracle_with_infs(seed):
    rng = np.random.default_rng(seed)
    H, W = 24, 32
    img = rng.normal(size=(H, W, 3)).astype(np.float32)
    # Sprinkle inf blocks like invalid-disparity regions.
    infmask = rng.random((H, W)) < 0.3
    img[infmask] = np.inf
    xs = rng.uniform(0, W - 1.001, size=64).astype(np.float32)
    ys = rng.uniform(0, H - 1.001, size=64).astype(np.float32)
    # include exact corner-at-edge cases
    xs[0], ys[0] = W - 1.0, H - 1.0
    xs[1], ys[1] = 0.0, 0.0

    ours = np.asarray(bilinear_sample_3d(img, xs, ys))
    for i in range(len(xs)):
        ref = oracle(img, float(xs[i]), float(ys[i]))
        if np.isnan(ref).any():
            assert np.isnan(ours[i]).any()
        else:
            np.testing.assert_allclose(ours[i], ref, rtol=1e-5, atol=1e-5)
