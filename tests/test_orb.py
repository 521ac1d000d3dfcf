"""ORB detector/descriptor: behavioral validation + cv2 bit-compatibility.

Descriptors use OpenCV's exact rBRIEF pattern (recovered empirically; see
ops/orb_pattern.py), so on top of the behavioral checks (SURVEY.md section
4) we assert cross-implementation compatibility:
 - cv2.ORB.compute on OUR keypoints/angles reproduces our descriptors to
   within a few near-tie bits;
 - our descriptors ratio-match cv2's own detectAndCompute output on the
   same image, with matches landing on spatially co-located keypoints.
"""

import cv2
import numpy as np

from openvo_jax.config import ORBParams
from openvo_jax.io.synthetic import make_texture
from openvo_jax.ops.hamming import ratio_test_match
from openvo_jax.ops.orb import detect_and_compute, features_per_level


def scene(seed=0, h=240, w=320):
    tex = make_texture(np.random.default_rng(seed), 512)
    return tex[:h, :w].astype(np.float32)


def test_features_per_level_matches_opencv_budget():
    counts = features_per_level(500, 8, 1.2)
    assert sum(counts) == 500
    assert counts[0] > counts[1] > counts[-2]


def test_corner_overlap_with_cv2():
    """Detector-level oracle: with the
    cv2-matching two-stage retention (FAST top-2N then Harris top-N),
    >= 85% of cv2's keypoints have one of ours within 2 px (measured
    0.92), and the per-level feature counts match cv2 EXACTLY."""
    img = scene(0)
    img_u8 = np.clip(img, 0, 255).astype(np.uint8)
    orb = cv2.ORB_create(nfeatures=300)
    ref_kps = orb.detect(img_u8, None)
    ours = detect_and_compute(img, None, ORBParams(nfeatures=300,
                                                   max_keypoints=512,
                                                   cv2_ranking=True))
    v = np.asarray(ours["valid"])
    xy = np.asarray(ours["xy"])[v]
    assert len(xy) >= 200
    ref_xy = np.array([k.pt for k in ref_kps])
    d = np.linalg.norm(ref_xy[:, None, :] - xy[None, :, :], axis=-1)
    hit = (d.min(axis=1) <= 2.0).mean()
    assert hit >= 0.85, f"corner overlap {hit:.2f}"
    # Per-level budget comparison vs cv2's own per-level counts.
    our_oct = np.asarray(ours["octave"])[v]
    cv2_oct = np.array([k.octave for k in ref_kps])
    for lvl in range(8):
        n_ours = int((our_oct == lvl).sum())
        n_cv2 = int((cv2_oct == lvl).sum())
        assert n_ours == n_cv2, (lvl, n_ours, n_cv2)
    # The default (Harris-over-all) ranking still detects a strongly
    # overlapping corner set — it reorders retention, not detection.
    default = detect_and_compute(img, None, ORBParams(nfeatures=300,
                                                      max_keypoints=512))
    dxy = np.asarray(default["xy"])[np.asarray(default["valid"])]
    dd = np.linalg.norm(ref_xy[:, None, :] - dxy[None, :, :], axis=-1)
    assert (dd.min(axis=1) <= 3.0).mean() > 0.5


def test_descriptor_matching_under_rotation():
    img = scene(1)
    img_u8 = np.clip(img, 0, 255).astype(np.uint8)
    h, w = img.shape
    M = cv2.getRotationMatrix2D((w / 2, h / 2), 15.0, 1.0)
    rot = cv2.warpAffine(img_u8, M, (w, h)).astype(np.float32)

    p = ORBParams(nfeatures=300, max_keypoints=512)
    fa = detect_and_compute(img, None, p)
    fb = detect_and_compute(rot, None, p)
    idx, ok = (np.asarray(x) for x in ratio_test_match(
        fa["desc"], fb["desc"], 0.8, fa["valid"], fb["valid"]))
    n_matches = int(ok.sum())
    assert n_matches >= 40, f"only {n_matches} matches"

    # Geometric consistency: matched points should follow the rotation.
    xa = np.asarray(fa["xy"])[ok]
    xb = np.asarray(fb["xy"])[np.asarray(idx)[ok]]
    pred = np.c_[xa, np.ones(len(xa))] @ M.T
    err = np.linalg.norm(pred - xb, axis=1)
    inlier_ratio = (err < 3.0).mean()
    assert inlier_ratio > 0.6, f"rotation inlier ratio {inlier_ratio:.2f}"


def test_descriptor_bit_compat_with_cv2():
    """cv2.ORB.compute on OUR level-0 keypoints (same coords + angles) must
    produce near-identical bits — the pattern, rotation rounding and blur
    all match cv2."""
    img = scene(4)
    img_u8 = np.clip(img, 0, 255).astype(np.uint8)
    p = ORBParams(nfeatures=300, max_keypoints=512)
    out = detect_and_compute(img_u8.astype(np.float32), None, p)
    v = np.asarray(out["valid"]) & (np.asarray(out["octave"]) == 0)
    xy = np.asarray(out["xy"])[v]
    ang = np.degrees(np.asarray(out["angle"])[v]) % 360.0
    ours = np.asarray(out["desc"])[v]
    assert len(xy) >= 50

    kps = []
    for (x, y), a in zip(xy, ang):
        kp = cv2.KeyPoint(float(x), float(y), 31.0)
        kp.angle = float(a)
        kp.octave = 0
        kps.append(kp)
    orb = cv2.ORB_create(nfeatures=500)
    kept, ref = orb.compute(img_u8, kps)
    assert len(kept) == len(kps), "cv2 dropped keypoints"
    ham = np.unpackbits(ours ^ ref, axis=1).sum(axis=1)
    assert np.median(ham) <= 4, f"median Hamming {np.median(ham)}"
    assert (ham <= 12).mean() > 0.9, f"{(ham <= 12).mean():.2f} within 12 bits"


def test_cross_matching_with_cv2_descriptors():
    """Our descriptors vs cv2's own detectAndCompute on the same image:
    ratio-test matches must land on co-located keypoints (the mixed-pipeline
    interop capability of the reference, stereo_odometer.py:22,117)."""
    img = scene(5)
    img_u8 = np.clip(img, 0, 255).astype(np.uint8)
    orb = cv2.ORB_create(nfeatures=300)
    ref_kps, ref_desc = orb.detectAndCompute(img_u8, None)

    p = ORBParams(nfeatures=300, max_keypoints=512)
    out = detect_and_compute(img_u8.astype(np.float32), None, p)
    v = np.asarray(out["valid"])
    our_xy = np.asarray(out["xy"])[v]
    our_desc = np.asarray(out["desc"])[v]

    matcher = cv2.BFMatcher.create(cv2.NORM_HAMMING)
    matches = matcher.knnMatch(our_desc, ref_desc, k=2)
    good = [m for m, n in matches if m.distance < 0.8 * n.distance]
    assert len(good) >= 60, f"only {len(good)} ratio-test matches"
    ref_xy = np.array([k.pt for k in ref_kps])
    d = np.linalg.norm(
        our_xy[[m.queryIdx for m in good]]
        - ref_xy[[m.trainIdx for m in good]], axis=1)
    colocated = (d <= 3.0).mean()
    assert colocated > 0.6, f"co-located match fraction {colocated:.2f}"


def test_mask_is_honored():
    img = scene(2)
    h, w = img.shape
    mask = np.zeros((h, w), np.uint8)
    mask[:, : w // 2] = 255
    p = ORBParams(nfeatures=200, max_keypoints=256)
    out = detect_and_compute(img, mask, p)
    xy = np.asarray(out["xy"])[np.asarray(out["valid"])]
    assert len(xy) > 20
    assert (xy[:, 0] <= w // 2 + 1).all()


def test_fixed_capacity_contract():
    img = scene(3)
    p = ORBParams(nfeatures=100, max_keypoints=128)
    out = detect_and_compute(img, None, p)
    assert out["xy"].shape == (128, 2)
    assert out["desc"].shape == (128, 32)
    assert out["valid"].shape == (128,)
    v = np.asarray(out["valid"])
    assert v.sum() <= 128
    # Padding rows have zero descriptors.
    d = np.asarray(out["desc"])
    assert (d[~v] == 0).all()


def test_keypoints_respect_min_count_on_blank_image():
    img = np.full((240, 320), 128.0, np.float32)
    p = ORBParams(nfeatures=100, max_keypoints=128)
    out = detect_and_compute(img, None, p)
    assert int(np.asarray(out["valid"]).sum()) == 0


def test_topk_flat_matches_lax_topk_with_ties():
    """The two-stage top-k (per-row lax.top_k then a candidate top-k) must
    be an EXACT drop-in for flat lax.top_k, including tie-breaking by
    lowest index — corner scores are small integers, so ties are the
    common case."""
    import jax
    import jax.numpy as jnp

    from openvo_jax.ops.orb import _topk_flat

    rng = np.random.default_rng(7)
    for n, k in [(20000, 32), (120000, 64), (3000, 16)]:
        x = np.full(n, -np.inf, np.float32)
        hot = rng.random(n) < 0.05
        x[hot] = rng.integers(0, 30, hot.sum()).astype(np.float32)
        xj = jnp.asarray(x)
        v1, i1 = jax.jit(lambda v: jax.lax.top_k(v, k))(xj)
        v2, i2 = jax.jit(lambda v: _topk_flat(v, k))(xj)
        np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
