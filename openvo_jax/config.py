"""Configuration dataclasses for the JAX openVO rebuild.

The reference has no config system: tuning lives in constructor kwargs
(`stereo_odometer.py:14-15`), four class constants (`stereo_odometer.py:5-12`),
and an SGBM parameter dict (`stereo_camera.py:23-27`). Here all of it is
collected into frozen (hashable) dataclasses so they can be passed as static
arguments to jitted functions. Defaults are identical to the reference.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SGBMParams:
    """Semi-global block matching parameters.

    Mirrors the parameter surface of ``cv2.StereoSGBM_create`` as consumed at
    reference ``stereo_camera.py:23-27``.  ``num_paths`` replaces OpenCV's
    ``mode`` flag (MODE_SGBM aggregates 5 directions, MODE_HH 8).
    """

    min_disparity: int = 0
    num_disparities: int = 128
    block_size: int = 5
    p1: int = 0
    p2: int = 0
    disp12_max_diff: int = -1  # <0 disables the left-right consistency check
    pre_filter_cap: int = 0    # 0/neg -> OpenCV default of 63 is NOT applied; see sgbm.py
    uniqueness_ratio: int = 0
    speckle_window_size: int = 0
    speckle_range: int = 0
    num_paths: int = 5         # 4, 5 or 8 directions; 5 = OpenCV MODE_SGBM
                               # (the reference leaves mode at default,
                               #  stereo_camera.py:26-27)

    def __post_init__(self):
        if self.num_disparities % 16 != 0 or self.num_disparities <= 0:
            raise ValueError("num_disparities must be a positive multiple of 16")
        if self.block_size % 2 != 1 or self.block_size < 1:
            raise ValueError("block_size must be odd and >= 1")
        if self.num_paths not in (4, 5, 8):
            raise ValueError("num_paths must be 4, 5 or 8")

    @property
    def effective_p1(self) -> int:
        # OpenCV requires P2 > P1; common default P1=8*blockSize^2, P2=32*blockSize^2.
        return self.p1 if self.p1 > 0 else 8 * self.block_size * self.block_size

    @property
    def effective_p2(self) -> int:
        p2 = self.p2 if self.p2 > 0 else 32 * self.block_size * self.block_size
        return max(p2, self.effective_p1 + 1)


@dataclasses.dataclass(frozen=True)
class ORBParams:
    """ORB detector/descriptor parameters (defaults match ``cv2.ORB_create``,
    reference call site ``stereo_odometer.py:22``)."""

    nfeatures: int = 500
    scale_factor: float = 1.2
    nlevels: int = 8
    edge_threshold: int = 31
    fast_threshold: int = 20
    patch_size: int = 31
    harris_k: float = 0.04
    # Keypoint retention order. False (default): rank ALL FAST corners by
    # Harris response — measurably better VO accuracy than OpenCV's order
    # (ATE 0.31 vs 0.50 over a 2.7 m synthetic path; a deliberate,
    # documented deviation). True: reproduce cv2.ORB's exact two-stage
    # selection (FAST top-2N, then Harris top-N) — >= 0.92 corner overlap
    # @2 px and EXACT per-level counts vs cv2 (tests/test_orb.py).
    cv2_ranking: bool = False
    # Fixed per-frame keypoint capacity (padded arrays for jit). Must be >= nfeatures.
    max_keypoints: int = 512

    def __post_init__(self):
        if self.max_keypoints < self.nfeatures:
            raise ValueError("max_keypoints must be >= nfeatures")


@dataclasses.dataclass(frozen=True)
class OdometerConfig:
    """Every knob of the reference ``StereoOdometer``.

    Constructor kwargs: reference ``stereo_odometer.py:14-15``.
    Class constants:   reference ``stereo_odometer.py:5-12``.
    """

    nfeatures: int = 500
    match_threshold: float = 0.8
    rigidity_threshold: float = 0.0
    outlier_threshold: float = 0.0
    preprocessed_frames: bool = False
    min_matches: int = 10

    # Class constants in the reference (TODO-config'd there at :39 and :214).
    min_valid_disparity: float = 4.0
    max_valid_disparity: float = 100.0
    max_distance_change: float = 1.0              # meters per frame
    max_rotation_change: float = math.pi / 3.0    # radians per frame

    orb: ORBParams = dataclasses.field(default_factory=ORBParams)

    # Additions beyond the reference: optional RANSAC robust fit.
    use_ransac: bool = False
    ransac_iters: int = 64
    ransac_inlier_threshold: float = 0.05

    def __post_init__(self):
        if self.orb.nfeatures != self.nfeatures:
            object.__setattr__(self, "orb",
                               dataclasses.replace(self.orb, nfeatures=self.nfeatures,
                                                   max_keypoints=max(self.orb.max_keypoints,
                                                                     self.nfeatures)))


# Skip-cause codes for the jitted state machine. The reference stores a string
# (`stereo_odometer.py:35` and the assignments listed in SURVEY.md section 4);
# inside XLA we carry an int code and map it back to the exact strings.
SKIP_NONE = 0
SKIP_KEYPOINTS = 1
SKIP_MATCHES = 2
SKIP_RIGIDITY = 3
SKIP_OUTLIER = 4
SKIP_NAN = 5
SKIP_BIGDIST = 6
SKIP_BIGROT = 7

SKIP_CAUSE_STRINGS = {
    SKIP_NONE: "",
    SKIP_KEYPOINTS: "keypoints",
    SKIP_MATCHES: "matches",
    SKIP_RIGIDITY: "rigidity",
    SKIP_OUTLIER: "outlier",
    SKIP_NAN: "nan",
    SKIP_BIGDIST: "bigdist",
    SKIP_BIGROT: "bigrot",
}
