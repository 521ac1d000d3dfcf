"""StereoOdometer: the frame-to-frame tracking loop as one jitted XLA program.

API-compatible rebuild of the reference ``StereoOdometer``
(stereo_odometer.py:14-226). The reference's data-dependent Python control
flow becomes masked/``jnp.where`` logic over a carried state pytree so that
the ENTIRE per-frame update — rectify, SGBM, reproject, ORB, match, filters,
Kabsch, motion gates, pose chain, skip/fallback state machine — compiles to a
single XLA program per frame.

Observable semantics preserved exactly (SURVEY.md section 3.2 and "quirks"):
 - skip causes {keypoints, matches, rigidity, outlier, nan, bigdist, bigrot}
   with the reference's assignment order (bigrot overwrites bigdist; rigidity
   may remain set on an ultimately-successful frame; skip_cause is sticky
   across successful frames);
 - motion gates scale with (skipped_frames + 1) (reference :215-216);
 - on failure the frame state is NOT rolled (reference :154 commented out) —
   new frames keep matching against the last accepted frame;
 - the fallback attempt matches against the prev-prev frame and composes onto
   the OLD c_T_w_prev, skipping the failed frame's motion (reference
   :139-150);
 - update() returns True for the very first frame without computing a pose
   (reference :124-126);
 - current_pose() inverts the stored world-in-camera transform (reference
   :225-226).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from openvo_jax.config import (
    SKIP_BIGDIST,
    SKIP_BIGROT,
    SKIP_CAUSE_STRINGS,
    SKIP_KEYPOINTS,
    SKIP_MATCHES,
    SKIP_NAN,
    SKIP_OUTLIER,
    SKIP_RIGIDITY,
    OdometerConfig,
)
from openvo_jax.geometry.se3 import rotation_magnitude
from openvo_jax.ops.hamming import ratio_test_match
from openvo_jax.ops.interpolate import bilinear_sample_3d
from openvo_jax.ops.orb import detect_and_compute
from openvo_jax.pose.kabsch import kabsch
from openvo_jax.pose.outlier import outlier_filter
from openvo_jax.pose.rigid_clique import rigid_body_filter


class FrameFeatures(NamedTuple):
    """Fixed-capacity per-frame data (the jit-friendly replacement for the
    reference's current_img/current_disparity/current_3d/current_kps/
    current_desc attribute quintuple, stereo_odometer.py:17-25)."""

    img: jnp.ndarray       # (Hc, Wc) cropped rectified gray frame
    xyz: jnp.ndarray       # (Hc, Wc, 3) reprojected 3D image
    disp: jnp.ndarray      # (Hc, Wc) disparity (float px)
    kp_xy: jnp.ndarray     # (K, 2) keypoint coords (x, y), level-0 frame
    desc: jnp.ndarray      # (K, 32) packed 256-bit descriptors
    kp_valid: jnp.ndarray  # (K,) bool


class OdomState(NamedTuple):
    cur: FrameFeatures
    prev: FrameFeatures
    has_cur: jnp.ndarray     # () bool
    has_prev: jnp.ndarray    # () bool
    c_T_w: jnp.ndarray       # (4, 4) world-in-camera
    c_T_w_prev: jnp.ndarray  # (4, 4)
    skipped: jnp.ndarray     # () int32
    skip_code: jnp.ndarray   # () int32


def _empty_features(shape, K):
    Hc, Wc = shape
    return FrameFeatures(
        img=jnp.zeros((Hc, Wc), jnp.float32),
        xyz=jnp.zeros((Hc, Wc, 3), jnp.float32),
        disp=jnp.zeros((Hc, Wc), jnp.float32),
        kp_xy=jnp.zeros((K, 2), jnp.float32),
        desc=jnp.zeros((K, 32), jnp.uint8),
        kp_valid=jnp.zeros((K,), bool),
    )


def init_state(cropped_shape, max_keypoints: int) -> OdomState:
    # cur and prev get distinct buffers: the step donates its input state,
    # and aliased leaves cannot be donated.
    return OdomState(
        cur=_empty_features(cropped_shape, max_keypoints),
        prev=_empty_features(cropped_shape, max_keypoints),
        has_cur=jnp.asarray(False),
        has_prev=jnp.asarray(False),
        c_T_w=jnp.eye(4, dtype=jnp.float32),
        c_T_w_prev=jnp.eye(4, dtype=jnp.float32),
        skipped=jnp.asarray(0, jnp.int32),
        skip_code=jnp.asarray(0, jnp.int32),
    )


def make_point_cloud_transform(cfg: OdometerConfig):
    """Standalone transform-gating stage (reference stereo_odometer.py:177-223)
    so the skip-cause semantics are unit-testable without a camera."""
    def point_cloud_transform(pts_a, pts_b, mask, skipped, skip_code):
        """Reference stereo_odometer.py:177-223 with identical gating order.
        Returns (T, ok, skip_code')."""
        if cfg.rigidity_threshold > 0:
            clique = rigid_body_filter(pts_a, pts_b, mask,
                                       cfg.rigidity_threshold)
            mask = mask & (clique > 0)
        n1 = jnp.sum(mask.astype(jnp.int32))
        rigidity_cause = n1 < 10
        skip_code = jnp.where(rigidity_cause, SKIP_RIGIDITY, skip_code)

        if cfg.outlier_threshold > 0:
            refined = outlier_filter(pts_a, pts_b, mask,
                                     cfg.outlier_threshold)
            mask = jnp.where(n1 >= 10, refined, mask)

        n2 = jnp.sum(mask.astype(jnp.int32))
        too_few = n2 < cfg.min_matches
        skip_code = jnp.where(too_few & ~rigidity_cause, SKIP_OUTLIER,
                              skip_code)

        T = kabsch(pts_a, pts_b, mask)
        is_nan = jnp.any(jnp.isnan(T))
        skip_code = jnp.where(~too_few & is_nan, SKIP_NAN, skip_code)

        lim = (skipped + 1).astype(jnp.float32)
        big_dist = jnp.linalg.norm(T[:3, 3]) > cfg.max_distance_change * lim
        big_rot = (
            rotation_magnitude(T[:3, :3]) > cfg.max_rotation_change * lim
        )
        gates_on = ~too_few & ~is_nan
        # Reference assignment order (:217-220): bigdist then bigrot —
        # bigrot wins if both fire.
        skip_code = jnp.where(gates_on & big_dist, SKIP_BIGDIST, skip_code)
        skip_code = jnp.where(gates_on & big_rot, SKIP_BIGROT, skip_code)
        ok = gates_on & ~big_dist & ~big_rot
        return T, ok, skip_code
    return point_cloud_transform


def _highest_precision(fn):
    """Trace ``fn`` under ``jax.default_matmul_precision("highest")``: its
    f32 matrix products (Q reprojection, ORB moments, Kabsch, the pose
    chain) run at full f32 precision on every device rather than in TF32
    on a GPU. Integer products (the Hamming matmul) stay exact."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


def make_pipeline_fns(camera, cfg: OdometerConfig, color: bool):
    """Factor the odometer's stages into reusable pure functions.

    Returns dict(extract, point_clouds, point_cloud_transform, attempt,
    step_feats) — consumed by make_step (sequential API), parallel/rig.py
    (vmap rig), parallel/stream.py and parallel/sharding.py (multi-device
    streaming). Each is traced at "highest" matmul precision
    (:func:`_highest_precision`).
    """
    compute3d = camera.compute_3d_fn(color, cfg.preprocessed_frames)

    def extract(img_left, img_right) -> FrameFeatures:
        with jax.named_scope("compute_3d"):
            xyz, disp, img = compute3d(img_left, img_right)
        # Disparity feature mask (reference stereo_odometer.py:38-41).
        fmask = (
            (disp >= cfg.min_valid_disparity)
            & (disp <= cfg.max_valid_disparity)
        ).astype(jnp.uint8)
        with jax.named_scope("orb"):
            feats = detect_and_compute(img, fmask, cfg.orb)
        return FrameFeatures(
            img=img,
            xyz=xyz,
            disp=disp,
            kp_xy=feats["xy"],
            desc=feats["desc"],
            kp_valid=feats["valid"],
        )

    def point_clouds(fa: FrameFeatures, fb: FrameFeatures):
        """Match fa -> fb and sample both 3D images at the matched subpixel
        keypoint locations (reference stereo_odometer.py:162-175)."""
        train_idx, mok = ratio_test_match(
            fa.desc, fb.desc, cfg.match_threshold, fa.kp_valid, fb.kp_valid
        )
        n = jnp.sum(mok.astype(jnp.int32))
        pts_a = bilinear_sample_3d(fa.xyz, fa.kp_xy[:, 0], fa.kp_xy[:, 1])
        xy_b = jnp.take(fb.kp_xy, train_idx, axis=0)
        pts_b = bilinear_sample_3d(fb.xyz, xy_b[:, 0], xy_b[:, 1])
        enough = n >= cfg.min_matches
        return pts_a, pts_b, mok, enough, n

    point_cloud_transform = make_point_cloud_transform(cfg)

    def attempt(fa, fb, skipped, skip_code_in):
        """One matching+fit attempt; mirrors the update() body's use of
        point_clouds + point_cloud_transform with 'matches' gating."""
        pts_a, pts_b, mok, enough, n = point_clouds(fa, fb)
        T, ok, code_t = point_cloud_transform(pts_a, pts_b, mok, skipped,
                                              skip_code_in)
        code_out = jnp.where(enough, code_t,
                             jnp.asarray(SKIP_MATCHES, jnp.int32))
        return T, ok & enough, code_out, n

    fns = {
        "extract": extract,
        "point_clouds": point_clouds,
        "point_cloud_transform": point_cloud_transform,
        "attempt": attempt,
        "step_feats": make_feats_step(cfg, attempt),
    }
    return {k: _highest_precision(f) for k, f in fns.items()}


def make_feats_step(cfg: OdometerConfig, attempt):
    """The state-machine half of the odometer step, taking precomputed
    FrameFeatures instead of raw images. Factored out of make_step so
    throughput pipelines (parallel/stream.py) can batch the state-free
    extraction and scan only this sequential part — the trajectory is
    identical to frame-at-a-time stepping by construction."""

    def step_feats(state: OdomState, feats: FrameFeatures):
        n_kps = jnp.sum(feats.kp_valid.astype(jnp.int32))
        few_kps = n_kps < cfg.min_matches
        first = ~state.has_cur

        # Attempt 1: against the last accepted frame.
        T1, ok1, code1, nm1 = attempt(state.cur, feats, state.skipped,
                                      state.skip_code)
        # Attempt 2 (fallback): against the prev-prev frame, starting from
        # attempt 1's skip-cause mutations (reference :139-150). Guarded by
        # lax.cond: in the common tracking-healthy case the whole fallback
        # matching/fit pipeline is skipped at runtime.
        use2 = ~ok1 & state.has_prev

        def run_attempt2(_):
            return attempt(state.prev, feats, state.skipped, code1)

        def skip_attempt2(_):
            return (jnp.eye(4, dtype=jnp.float32), jnp.asarray(False),
                    code1, jnp.asarray(0, jnp.int32))

        T2, ok2, code2, nm2 = jax.lax.cond(use2, run_attempt2,
                                           skip_attempt2, None)
        ok = ok1 | (use2 & ok2)
        code_final = jnp.where(use2, code2, code1)

        # Pose chain. Attempt 1 composes onto c_T_w; the fallback composes
        # onto the OLD c_T_w_prev (skipping the failed frame's motion).
        c_T_w_1 = T1 @ state.c_T_w
        c_T_w_2 = T2 @ state.c_T_w_prev
        c_T_w_new = jnp.where(ok1, c_T_w_1,
                              jnp.where(use2 & ok2, c_T_w_2, state.c_T_w))
        c_T_w_prev_new = jnp.where(ok, state.c_T_w, state.c_T_w_prev)

        # Tracking success for this call (first frame counts as success).
        success = ~few_kps & (first | ok)
        tracked = ~few_kps & ~first & ok

        # State roll (save_frame_update) only on success.
        def sel(a, b):
            return jax.tree_util.tree_map(
                lambda x, y: jnp.where(success, x, y), a, b
            )

        new_cur = sel(feats, state.cur)
        new_prev = sel(state.cur, state.prev)

        new_state = OdomState(
            cur=new_cur,
            prev=new_prev,
            has_cur=state.has_cur | success,
            has_prev=jnp.where(success, state.has_cur, state.has_prev),
            c_T_w=jnp.where(tracked, c_T_w_new, state.c_T_w),
            c_T_w_prev=jnp.where(tracked, c_T_w_prev_new, state.c_T_w_prev),
            skipped=jnp.where(
                success,
                jnp.where(first, state.skipped, 0),
                state.skipped + 1,
            ).astype(jnp.int32),
            skip_code=jnp.where(
                few_kps,
                jnp.asarray(SKIP_KEYPOINTS, jnp.int32),
                jnp.where(first, state.skip_code, code_final),
            ).astype(jnp.int32),
        )
        stats = {
            "n_kps": n_kps,
            "n_matches": jnp.where(use2, nm2, nm1),
            "ok1": ok1,
            "ok2": use2 & ok2,
            "skip_code": new_state.skip_code,
        }
        return new_state, success, stats

    return step_feats


def make_step(camera, cfg: OdometerConfig, color: bool):
    """Build the pure step function (state, imgL, imgR) -> (state', ok, stats).

    ``camera`` is a StereoCamera; its maps/Q/SGBM params are closed over and
    baked into the compiled program as constants.

    Precision: the whole step is traced inside one
    ``jax.default_matmul_precision("highest")`` (see
    :func:`make_pipeline_fns`), so its f32 matrix products — the per-pixel
    Q reprojection, the ORB orientation moments, the Kabsch fit and the
    pose chain — never run in TF32 on a GPU. The int8 Hamming product is
    integer and exact either way.
    """
    fns = make_pipeline_fns(camera, cfg, color)
    extract, step_feats = fns["extract"], fns["step_feats"]

    def step(state: OdomState, img_left, img_right):
        return step_feats(state, extract(img_left, img_right))

    return step


class StereoOdometer:
    """Drop-in replacement for the reference StereoOdometer (same defaults,
    reference stereo_odometer.py:14-15)."""

    MIN_VALID_DISPARITY = 4
    MAX_VALID_DISPARITY = 100
    MAX_DISTANCE_CHANGE = 1.0
    MAX_ROTATION_CHANGE = float(np.pi / 3)

    def __init__(self, stereo_camera, nfeatures: int = 500,
                 match_threshold: float = 0.8,
                 rigidity_threshold: float = 0.0,
                 outlier_threshold: float = 0.0,
                 preprocessed_frames: bool = False,
                 min_matches: int = 10,
                 config: OdometerConfig | None = None):
        self.stereo = stereo_camera
        if config is None:
            config = OdometerConfig(
                nfeatures=nfeatures,
                match_threshold=match_threshold,
                rigidity_threshold=rigidity_threshold,
                outlier_threshold=outlier_threshold,
                preprocessed_frames=preprocessed_frames,
                min_matches=min_matches,
            )
        self.config = config
        self._state = init_state(stereo_camera.cropped_shape,
                                 config.orb.max_keypoints)
        self.skipped_frames = 0
        self.skip_cause = ""
        self._pct_fn = None  # lazily-jitted point_cloud_transform helper

    # Compiled steps are shared across instances with the same (camera,
    # config, color): re-instantiating an odometer (common in tests and
    # multi-sequence runs) must not retrace/recompile the big XLA program.
    # The cache lives ON the camera instance, so entries (and the compiled
    # executables they pin) die with the camera — no unbounded class-level
    # growth, no id()-reuse staleness.
    def _get_step(self, color: bool):
        cache = getattr(self.stereo, "_step_cache", None)
        if cache is None:
            cache = {}
            self.stereo._step_cache = cache
        key = (self.config, color)
        if key not in cache:
            cache[key] = jax.jit(
                make_step(self.stereo, self.config, color),
                donate_argnums=(0,),
            )
        return cache[key]

    @property
    def state(self) -> OdomState:
        return self._state

    def update(self, img_left, img_right) -> bool:
        """Process one stereo pair; returns True iff tracking succeeded
        (reference stereo_odometer.py:115-160)."""
        img_left = jnp.asarray(np.asarray(img_left))
        img_right = jnp.asarray(np.asarray(img_right))
        color = img_left.ndim == 3
        step = self._get_step(color)
        self._state, ok, stats = step(self._state, img_left, img_right)
        ok = bool(ok)
        self.skipped_frames = int(self._state.skipped)
        self.skip_cause = SKIP_CAUSE_STRINGS[int(self._state.skip_code)]
        self.last_stats = {k: np.asarray(v) for k, v in stats.items()}
        return ok

    def current_pose(self):
        """camera-in-world pose = inv(c_T_w) (reference :225-226)."""
        return np.linalg.inv(np.asarray(self._state.c_T_w, dtype=np.float64))

    # -- reference public helper methods (NumPy in/out convenience wrappers
    # over the jitted implementations) -------------------------------------

    def feature_mask(self, disparity):
        """uint8 0/255 mask of pixels with reliable depth (reference
        stereo_odometer.py:38-41)."""
        d = np.asarray(disparity)
        mask = (d >= self.MIN_VALID_DISPARITY) & (d <= self.MAX_VALID_DISPARITY)
        return mask.astype(np.uint8) * 255

    def valid_distance_change(self, prev_kp_idx, current_kp_idx):
        """Distance-change plausibility test between a prev/current keypoint
        pair (reference stereo_odometer.py:43-48 — dead code there, guarded
        by ``if (False)`` at :165-166, but part of the public surface).
        Keypoints are (x, y) rows of prev_kps/current_kps."""
        p_x, p_y = self.prev_kps[prev_kp_idx]
        c_x, c_y = self.current_kps[current_kp_idx]
        d_prev = np.linalg.norm(self.prev_3d[int(p_y)][int(p_x)])
        d_cur = np.linalg.norm(self.current_3d[int(c_y)][int(c_x)])
        limit = self.MAX_DISTANCE_CHANGE * (self.skipped_frames + 1)
        return bool(d_prev - d_cur <= limit)

    def bilinear_interpolate_pixels(self, img, x, y):
        """Inf-aware renormalizing bilinear sample of an (H, W, 3) 3D image
        at one subpixel position (reference stereo_odometer.py:50-79)."""
        from openvo_jax.ops.interpolate import bilinear_sample_3d

        out = bilinear_sample_3d(
            jnp.asarray(np.asarray(img, np.float32)),
            jnp.asarray([float(x)], jnp.float32),
            jnp.asarray([float(y)], jnp.float32),
        )
        return np.asarray(out)[0]

    def rigid_body_filter(self, prev_pts, pts):
        """Greedy max-clique rigidity filter; 0/1 int array (reference
        stereo_odometer.py:82-105)."""
        prev_pts = np.asarray(prev_pts, np.float32)
        pts = np.asarray(pts, np.float32)
        mask = np.ones(len(pts), bool)
        out = rigid_body_filter(jnp.asarray(prev_pts), jnp.asarray(pts),
                                jnp.asarray(mask), self.config.rigidity_threshold)
        return np.asarray(out)

    def point_cloud_transform(self, current_pts, next_pts):
        """Rigid fit + filters + motion gates; returns the 4x4 transform or
        None, updating skip_cause exactly like reference
        stereo_odometer.py:177-223."""
        cur = np.asarray(current_pts, np.float32)
        nxt = np.asarray(next_pts, np.float32)
        if self._pct_fn is None:
            # jitted once per odometer; retraces only on a new point count
            self._pct_fn = jax.jit(make_point_cloud_transform(self.config))
        fn = self._pct_fn
        T, ok, code = fn(
            jnp.asarray(cur), jnp.asarray(nxt),
            jnp.ones((len(cur),), bool),
            jnp.asarray(self.skipped_frames, jnp.int32),
            jnp.asarray(0, jnp.int32),
        )
        code = int(code)
        if code:
            self.skip_cause = SKIP_CAUSE_STRINGS[code]
        if not bool(ok):
            return None
        return np.asarray(T)

    @property
    def c_T_w(self):
        return np.asarray(self._state.c_T_w)

    # -- reference attribute surface (stereo_odometer.py:17-25): the padded
    # frame-state arrays, exposed with validity applied -------------------

    @property
    def current_img(self):
        return np.asarray(self._state.cur.img)

    @property
    def current_3d(self):
        return np.asarray(self._state.cur.xyz)

    @property
    def current_disparity(self):
        return np.asarray(self._state.cur.disp)

    @property
    def prev_img(self):
        return np.asarray(self._state.prev.img)

    @property
    def prev_disparity(self):
        return np.asarray(self._state.prev.disp)

    @property
    def current_kps(self):
        v = np.asarray(self._state.cur.kp_valid)
        return np.asarray(self._state.cur.kp_xy)[v]

    @property
    def current_desc(self):
        v = np.asarray(self._state.cur.kp_valid)
        return np.asarray(self._state.cur.desc)[v]

    @property
    def prev_3d(self):
        return np.asarray(self._state.prev.xyz)

    @property
    def prev_kps(self):
        v = np.asarray(self._state.prev.kp_valid)
        return np.asarray(self._state.prev.kp_xy)[v]

    @property
    def prev_desc(self):
        v = np.asarray(self._state.prev.kp_valid)
        return np.asarray(self._state.prev.desc)[v]

    # -- checkpoint / resume (SURVEY.md section 5: the reference has no
    # runtime persistence; this build saves the full tracking state —
    # pose chain, skip counters, cached frame features — as npz) ----------

    def save_state(self, path):
        leaves, _ = jax.tree_util.tree_flatten(self._state)
        np.savez(path, n_leaves=len(leaves),
                 **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)})
        return path

    def load_state(self, path):
        z = np.load(path)
        n = int(z["n_leaves"])
        leaves = [jnp.asarray(z[f"leaf_{i}"]) for i in range(n)]
        _, treedef = jax.tree_util.tree_flatten(self._state)
        self._state = jax.tree_util.tree_unflatten(treedef, leaves)
        self.skipped_frames = int(self._state.skipped)
        self.skip_cause = SKIP_CAUSE_STRINGS[int(self._state.skip_code)]
