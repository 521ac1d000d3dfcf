"""StereoCamera: calibration holder + per-frame depth pipeline.

API-compatible rebuild of the reference ``StereoCamera``
(stereo_camera.py:7-55). Setup work (stereoRectify, undistort map
precomputation) runs once in NumPy (geometry/rectify.py); the per-frame path
gray -> remap -> SGBM -> reproject -> crop compiles to a single jitted XLA
program with the maps/Q baked in as constants.

Behavioral quirk preserved (SURVEY.md "quirks"): the valid-region crop slices
``img[roi[1]:roi[3], roi[0]:roi[2]]`` — i.e. it treats the ROI's (w, h) as
*end coordinates* — exactly like reference stereo_camera.py:35-41.
"""

from __future__ import annotations

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np

from openvo_jax.config import SGBMParams
from openvo_jax.geometry.rectify import init_undistort_rectify_map, stereo_rectify
from openvo_jax.geometry.reproject import reproject_image_to_3d
from openvo_jax.ops.image import bgr_to_gray
from openvo_jax.ops.remap import make_remap
from openvo_jax.ops.sgbm import sgbm_disparity


def _sgbm_params_from_dict(d) -> SGBMParams:
    """Accept the reference's pickle dict keys (stereo_camera.py:23-27)."""
    return SGBMParams(
        min_disparity=int(d["minDisparity"]),
        num_disparities=int(d["numDisparities"]),
        block_size=int(d["blockSize"]),
        p1=int(d["P1"]),
        p2=int(d["P2"]),
        disp12_max_diff=int(d["disp12MaxDiff"]),
        pre_filter_cap=int(d["preFilterCap"]),
        uniqueness_ratio=int(d["uniquenessRatio"]),
        speckle_window_size=int(d["speckleWindowSize"]),
        speckle_range=int(d["speckleRange"]),
    )


class StereoCamera:
    """Holds calibration; builds rectify maps once; computes per-frame 3D."""

    @classmethod
    def from_pfiles(cls, left_cam_file, right_cam_file, rect_file, sgbm_file,
                    img_size):
        """Pickle-compatible calibration loader (reference
        stereo_camera.py:7-14): four pickles holding {'K','dist'} x2,
        {'R','T'}, and the SGBM parameter dict."""
        with open(left_cam_file, "rb") as f:
            cam_left = pickle.load(f)
        with open(right_cam_file, "rb") as f:
            cam_right = pickle.load(f)
        with open(rect_file, "rb") as f:
            rect_params = pickle.load(f)
        with open(sgbm_file, "rb") as f:
            sgbm_params = pickle.load(f)
        return cls(cam_left["K"], cam_left["dist"], cam_right["K"],
                   cam_right["dist"], rect_params, sgbm_params, img_size)

    @classmethod
    def from_npz(cls, path, img_size):
        """Safer non-pickle calibration format (an addition beyond the reference)."""
        z = np.load(path, allow_pickle=False)
        sgbm_keys = ["minDisparity", "numDisparities", "blockSize", "P1", "P2",
                     "disp12MaxDiff", "preFilterCap", "uniquenessRatio",
                     "speckleWindowSize", "speckleRange"]
        sgbm = {k: int(z[f"sgbm_{k}"]) for k in sgbm_keys}
        return cls(z["K_left"], z["dist_left"], z["K_right"], z["dist_right"],
                   {"R": z["R"], "T": z["T"]}, sgbm, img_size)

    def __init__(self, K_left, dist_left, K_right, dist_right, rect_params,
                 sgbm_params, img_size):
        """Same signature as reference stereo_camera.py:16. ``img_size`` is
        (width, height); ``sgbm_params`` is the reference's dict or an
        SGBMParams."""
        self.img_size = (int(img_size[0]), int(img_size[1]))
        w, h = self.img_size

        R1, R2, P1, P2, Q, roi_l, roi_r = stereo_rectify(
            K_left, dist_left, K_right, dist_right, self.img_size,
            rect_params["R"], rect_params["T"],
        )
        self.R1, self.R2, self.P1, self.P2 = R1, R2, P1, P2
        self.Q = Q
        self.valid_region_left = roi_l
        self.valid_region_right = roi_r

        mlx, mly = init_undistort_rectify_map(K_left, dist_left, R1, P1,
                                              self.img_size)
        mrx, mry = init_undistort_rectify_map(K_right, dist_right, R2, P2,
                                              self.img_size)
        self.map_left = (jnp.asarray(mlx), jnp.asarray(mly))
        self.map_right = (jnp.asarray(mrx), jnp.asarray(mry))
        # Specialized remap closures (bounded roll+select when displacement
        # allows; see ops/remap.py).
        self._remap_left = make_remap(*self.map_left)
        self._remap_right = make_remap(*self.map_right)

        if isinstance(sgbm_params, SGBMParams):
            self.sgbm = sgbm_params
        else:
            self.sgbm = _sgbm_params_from_dict(sgbm_params)

        # Cropped-region static geometry, with the reference's [y:h, x:w]
        # slicing quirk.
        x, y, rw, rh = self.valid_region_left
        self.crop_slice = (slice(y, rh), slice(x, rw))
        self.cropped_shape = (max(rh - y, 0), max(rw - x, 0))

        self._q_dev = jnp.asarray(Q, dtype=jnp.float32)

    # -- per-frame ops ------------------------------------------------------

    def undistort_rectify_left(self, img):
        """Rectify one left frame. Like cv2.remap (reference
        stereo_camera.py:29-30), uint8 input yields uint8 output; float
        input stays float32."""
        return self._remap_dtype(self._remap_left, img)

    def undistort_rectify_right(self, img):
        """Rectify one right frame (reference stereo_camera.py:32-33);
        preserves uint8 input dtype like cv2.remap."""
        return self._remap_dtype(self._remap_right, img)

    @staticmethod
    def _remap_dtype(remap, img):
        img = jnp.asarray(img)
        out = remap(img)
        if img.dtype == jnp.uint8:
            return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)
        return out

    def crop_to_valid_region_left(self, img):
        x, y, w, h = self.valid_region_left
        return img[y:h, x:w]

    def crop_to_valid_region_right(self, img):
        x, y, w, h = self.valid_region_right
        return img[y:h, x:w]

    def compute_3d_fn(self, color: bool, preprocessed: bool):
        """Return the pure function (imgL, imgR) -> (img_3d, disparity,
        img_left), all cropped — the jittable core of reference
        stereo_camera.py:43-55."""
        remap_l, remap_r, q = self._remap_left, self._remap_right, self._q_dev
        sgbm_params = self.sgbm
        sl = self.crop_slice

        def fn(img_left, img_right):
            if color:
                img_left = bgr_to_gray(img_left)
                img_right = bgr_to_gray(img_right)
            img_left = img_left.astype(jnp.float32)
            img_right = img_right.astype(jnp.float32)
            if not preprocessed:
                img_left = remap_l(img_left)
                img_right = remap_r(img_right)
            disparity = sgbm_disparity(img_left, img_right, sgbm_params)
            img_3d = reproject_image_to_3d(disparity, q)
            # Invalid disparity (marker minDisparity-1) reprojects to a
            # FINITE garbage depth (W != 0), which the inf-aware bilinear
            # sampler (reference stereo_odometer.py:50-79) cannot exclude —
            # a latent accuracy bug in the reference, where invalid
            # neighbors poison matched 3D points near disparity holes.
            # Enforce the sampler's contract: invalid disparity -> inf 3D.
            valid = disparity >= (sgbm_params.min_disparity - 0.75)
            img_3d = jnp.where(valid[..., None], img_3d, jnp.inf)
            return (img_3d[sl[0], sl[1], :], disparity[sl[0], sl[1]],
                    img_left[sl[0], sl[1]])

        return fn

    @functools.lru_cache(maxsize=None)
    def _jitted_compute_3d(self, color: bool, preprocessed: bool):
        return jax.jit(self.compute_3d_fn(color, preprocessed))

    def compute_3d(self, img_left, img_right, preprocessed: bool = False):
        """Eager convenience API matching reference stereo_camera.py:43-55."""
        color = np.asarray(img_left).ndim == 3
        fn = self._jitted_compute_3d(color, preprocessed)
        return fn(jnp.asarray(img_left), jnp.asarray(img_right))

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other
