"""Monocular visual odometry: essential-matrix tracking.

Capability extension mandated by BASELINE.json config 3 ("findEssentialMat +
recoverPose on a mono image stream") — the reference library has no monocular
path (SURVEY.md section 6). Design: ORB features on the full
frame, Hamming ratio matching, fixed-iteration vmapped 8-point RANSAC for E,
cheirality-based pose recovery; the whole per-frame update is one jitted XLA
program, like the stereo odometer.

Monocular scale is unobservable: per-frame translation is unit-norm, scaled
by ``trans_scale`` (callers with external scale — speedometer, IMU — pass it
per update).

The hypothesis engine is Nister's 5-POINT minimal solver
(pose/fivepoint.py) — the same algorithm behind cv2.findEssentialMat's
RANSAC — with cheirality tie-breaking, so planar scenes resolve to the
correct pose (the calibrated twisted-pair ambiguity) instead of
degenerating like the 8-point DLT (round-2 behavior; the 8-point variant
remains available as pose/ransac.ransac_essential).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from openvo_jax.config import OdometerConfig
from openvo_jax.geometry.se3 import rt_to_T
from openvo_jax.ops.hamming import ratio_test_match
from openvo_jax.ops.orb import detect_and_compute
from openvo_jax.pose.ransac import ransac_essential_5pt, recover_pose


class MonoFrame(NamedTuple):
    kp_xy: jnp.ndarray
    desc: jnp.ndarray
    kp_valid: jnp.ndarray


class MonoState(NamedTuple):
    cur: MonoFrame
    has_cur: jnp.ndarray
    c_T_w: jnp.ndarray
    skipped: jnp.ndarray
    key: jnp.ndarray


def init_state(max_keypoints: int) -> MonoState:
    return MonoState(
        cur=MonoFrame(
            kp_xy=jnp.zeros((max_keypoints, 2), jnp.float32),
            desc=jnp.zeros((max_keypoints, 32), jnp.uint8),
            kp_valid=jnp.zeros((max_keypoints,), bool),
        ),
        has_cur=jnp.asarray(False),
        c_T_w=jnp.eye(4, dtype=jnp.float32),
        skipped=jnp.asarray(0, jnp.int32),
        key=jax.random.PRNGKey(0),
    )


def make_step(K, cfg: OdometerConfig, ransac_iters: int = 256,
              inlier_px: float = 1.0, min_inliers: int = 15):
    """(state, img, trans_scale) -> (state', ok, stats). ``K`` is the 3x3
    intrinsic matrix; images are (H, W) grayscale."""
    K = np.asarray(K, dtype=np.float64)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    # Sampson threshold in normalized coords ~ (px / f)^2.
    thresh = float((inlier_px / ((fx + fy) * 0.5)) ** 2)

    def normalize(xy):
        return jnp.stack([(xy[:, 0] - cx) / fx, (xy[:, 1] - cy) / fy], axis=1)

    def step(state: MonoState, img, trans_scale):
        feats = detect_and_compute(img.astype(jnp.float32), None, cfg.orb)
        frame = MonoFrame(feats["xy"], feats["desc"], feats["valid"])
        n_kps = jnp.sum(frame.kp_valid.astype(jnp.int32))
        first = ~state.has_cur

        train_idx, mok = ratio_test_match(
            state.cur.desc, frame.desc, cfg.match_threshold,
            state.cur.kp_valid, frame.kp_valid,
        )
        x1 = normalize(state.cur.kp_xy)
        x2 = normalize(jnp.take(frame.kp_xy, train_idx, axis=0))
        n_matches = jnp.sum(mok.astype(jnp.int32))

        key, sub = jax.random.split(state.key)
        # 5-point minimal hypotheses: each sample yields up to 10
        # candidate E's, so ~1/10th the sample count of the 8-point
        # variant explores the same model count.
        E, inl, n_inl = ransac_essential_5pt(x1, x2, mok, sub,
                                             iters=max(ransac_iters // 4,
                                                       16),
                                             inlier_threshold=thresh)
        R, t, support = recover_pose(E, x1, x2, inl)
        n_support = jnp.sum(support.astype(jnp.int32))

        few_kps = n_kps < cfg.min_matches
        few_matches = n_matches < cfg.min_matches
        few_inl = n_inl < min_inliers
        few_sup = n_support < min_inliers // 2
        ok = ~first & ~few_matches & ~few_inl & ~few_sup
        # Failure-cause surface (mirrors StereoOdometer.skip_cause).
        code = jnp.asarray(0, jnp.int32)
        code = jnp.where(few_sup, 4, code)
        code = jnp.where(few_inl, 3, code)
        code = jnp.where(few_matches, 2, code)
        code = jnp.where(few_kps, 1, code)
        code = jnp.where(first | ok, 0, code)
        # T maps prev-camera coords to new-camera coords (same convention as
        # the stereo odometer's per-frame transform).
        T = rt_to_T(R.astype(jnp.float32),
                    (t * trans_scale).astype(jnp.float32))
        c_T_w_new = jnp.where(ok, T @ state.c_T_w, state.c_T_w)

        accept = first | ok
        new_state = MonoState(
            cur=jax.tree_util.tree_map(
                lambda a, b: jnp.where(accept, a, b), frame, state.cur
            ),
            has_cur=state.has_cur | accept,
            c_T_w=c_T_w_new,
            skipped=jnp.where(accept, 0, state.skipped + 1).astype(jnp.int32),
            key=key,
        )
        stats = {"n_kps": n_kps, "n_matches": n_matches,
                 "n_inliers": n_inl, "n_support": n_support,
                 "skip_code": code}
        return new_state, accept, stats

    return step


MONO_SKIP_STRINGS = {0: "", 1: "keypoints", 2: "matches", 3: "inliers",
                     4: "support"}


class MonoOdometer:
    """Monocular frame-to-frame VO (API shaped like StereoOdometer)."""

    def __init__(self, K, nfeatures: int = 500, match_threshold: float = 0.8,
                 min_matches: int = 10, ransac_iters: int = 256,
                 inlier_px: float = 1.0, min_inliers: int = 15,
                 config: OdometerConfig | None = None):
        if config is None:
            config = OdometerConfig(nfeatures=nfeatures,
                                    match_threshold=match_threshold,
                                    min_matches=min_matches)
        self.config = config
        self._state = init_state(config.orb.max_keypoints)
        self._step = jax.jit(
            make_step(K, config, ransac_iters, inlier_px, min_inliers),
            donate_argnums=(0,),
        )
        self.skipped_frames = 0
        self.skip_cause = ""

    def update(self, img, trans_scale: float = 1.0) -> bool:
        self._state, ok, stats = self._step(
            self._state, jnp.asarray(np.asarray(img)),
            jnp.asarray(trans_scale, jnp.float32),
        )
        self.skipped_frames = int(self._state.skipped)
        self.last_stats = {k: np.asarray(v) for k, v in stats.items()}
        self.skip_cause = MONO_SKIP_STRINGS[int(stats["skip_code"])]
        return bool(ok)

    def current_pose(self):
        return np.linalg.inv(np.asarray(self._state.c_T_w, dtype=np.float64))
