"""Native stereo rectification: the setup-time calibration math.

Framework-standalone replacements for the one-time OpenCV setup
calls in the reference:
 - ``cv2.stereoRectify``            (reference stereo_camera.py:17-18)  -> :func:`stereo_rectify`
 - ``cv2.initUndistortRectifyMap``  (reference stereo_camera.py:19-22)  -> :func:`init_undistort_rectify_map`
 - ``cv2.undistortPoints``          (used internally by the above)      -> :func:`undistort_points`

These run once per camera at construction time, so they are plain NumPy in
float64 (precision matters more than speed here); the resulting rectification
maps become device-resident constants consumed by the remap (ops/remap.py).

The algorithms implement the standard published rectification recipe
(Bouguet's method as used by OpenCV): split the inter-camera rotation in half,
rotate both cameras onto a common plane, rotate that plane so the baseline
becomes the x-axis, then choose a common focal length / principal point and
compute inscribed ("inner") and bounding ("outer") valid-pixel rectangles from
an undistorted 9x9 grid of boundary points. Default behavior matches
``alpha = -1`` + ``CALIB_ZERO_DISPARITY`` (the reference passes no flags).
"""

from __future__ import annotations

import math

import numpy as np


def _rodrigues_to_vec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle vector (inverse Rodrigues)."""
    A = (R - R.T) * 0.5
    rho = np.array([A[2, 1], A[0, 2], A[1, 0]])
    s = np.linalg.norm(rho)
    c = (np.trace(R) - 1.0) * 0.5
    c = np.clip(c, -1.0, 1.0)
    if s < 1e-12 and c > 0:
        return np.zeros(3)
    if s < 1e-12 and c < 0:
        # theta = pi: extract axis from R + I
        M = (R + np.eye(3)) * 0.5
        axis = np.sqrt(np.maximum(np.diag(M), 0.0))
        # fix signs using off-diagonals
        i = int(np.argmax(axis))
        if axis[i] > 0:
            v = M[:, i] / axis[i]
            v[i] = axis[i]
            axis = v / np.linalg.norm(v)
        return axis * math.pi
    theta = math.atan2(s, c)
    return rho / s * theta


def _rodrigues_to_mat(r: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(r)
    if theta < 1e-12:
        return np.eye(3)
    k = r / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(theta) * K + (1 - math.cos(theta)) * (K @ K)


def _dist_coeffs(dist) -> np.ndarray:
    """Normalize a distortion vector to 8 coefficients (k1 k2 p1 p2 k3 k4 k5 k6)."""
    d = np.zeros(8)
    if dist is not None:
        flat = np.asarray(dist, dtype=np.float64).ravel()
        d[: len(flat)] = flat[:8]
    return d


def undistort_points(pts, K, dist, R=None, P=None, iters: int = 5):
    """Iteratively undistort pixel coordinates; optional rectify + reproject.

    ``pts`` is (N, 2). Mirrors ``cv2.undistortPoints`` (5 Newton-style
    iterations of inverse radial-tangential distortion).
    """
    K = np.asarray(K, dtype=np.float64)
    k1, k2, p1, p2, k3, k4, k5, k6 = _dist_coeffs(dist)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    x = (pts[:, 0] - cx) / fx
    y = (pts[:, 1] - cy) / fy
    x0, y0 = x.copy(), y.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        # Inverse of the rational radial model: reciprocal of the forward
        # kr = (1+k1r2+k2r4+k3r6)/(1+k4r2+k5r4+k6r6), iterated to a fixpoint.
        icdist = (1 + ((k6 * r2 + k5) * r2 + k4) * r2) / (
            1 + ((k3 * r2 + k2) * r2 + k1) * r2
        )
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    out = np.stack([x, y], axis=1)
    if R is not None or P is not None:
        Rm = np.eye(3) if R is None else np.asarray(R, dtype=np.float64)
        if P is not None:
            P = np.asarray(P, dtype=np.float64)
            Rm = P[:3, :3] @ Rm
        h = np.concatenate([out, np.ones((len(out), 1))], axis=1) @ Rm.T
        out = h[:, :2] / h[:, 2:3]
    return out


def _distort_normalized(x, y, dist):
    """Forward radial-tangential distortion of normalized coordinates."""
    k1, k2, p1, p2, k3, k4, k5, k6 = _dist_coeffs(dist)
    r2 = x * x + y * y
    kr = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) / (
        1 + ((k6 * r2 + k5) * r2 + k4) * r2
    )
    xd = x * kr + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * kr + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def _get_rectangles(K, dist, R, P, img_size):
    """Inner (inscribed) and outer (bounding) rects of the rectified image.

    Undistorts a 9x9 grid of source-image points through (K, dist, R, P); the
    inner rect is bounded by the extreme edge rows/columns, the outer rect is
    the bounding box. Returns ((ix, iy, iw, ih), (ox, oy, ow, oh)) in float.
    """
    w, h = img_size
    N = 9
    xs = np.arange(N) * w / (N - 1)
    ys = np.arange(N) * h / (N - 1)
    gx, gy = np.meshgrid(xs, ys)  # (N, N) with rows = y
    pts = np.stack([gx.ravel(), gy.ravel()], axis=1).astype(np.float64)
    upts = undistort_points(pts, K, dist, R=R, P=P).reshape(N, N, 2)

    ox0, oy0 = upts[..., 0].min(), upts[..., 1].min()
    ox1, oy1 = upts[..., 0].max(), upts[..., 1].max()
    ix0 = upts[:, 0, 0].max()   # left column -> max x
    ix1 = upts[:, -1, 0].min()  # right column -> min x
    iy0 = upts[0, :, 1].max()   # top row -> max y
    iy1 = upts[-1, :, 1].min()  # bottom row -> min y
    inner = (ix0, iy0, ix1 - ix0, iy1 - iy0)
    outer = (ox0, oy0, ox1 - ox0, oy1 - oy0)
    return inner, outer


def stereo_rectify(K_left, dist_left, K_right, dist_right, img_size, R, T,
                   alpha: float = -1.0, zero_disparity: bool = True):
    """Compute rectification rotations, projections, Q and valid ROIs.

    Arguments mirror the reference call ``cv2.stereoRectify(K_l, d_l, K_r,
    d_r, img_size, R, T)`` at stereo_camera.py:17-18 (``img_size`` is (w, h)).

    Returns (R1, R2, P1, P2, Q, roi_left, roi_right); ROIs are integer
    (x, y, w, h) tuples.
    """
    K1 = np.asarray(K_left, dtype=np.float64)
    K2 = np.asarray(K_right, dtype=np.float64)
    R = np.asarray(R, dtype=np.float64)
    T = np.asarray(T, dtype=np.float64).ravel()
    w, h = img_size

    # Split the relative rotation evenly between the two cameras.
    om = _rodrigues_to_vec(R)
    r_r = _rodrigues_to_mat(om * -0.5)
    t = r_r @ T

    # Dominant baseline axis: 0 -> horizontal stereo, 1 -> vertical.
    idx = 0 if abs(t[0]) > abs(t[1]) else 1
    c = t[idx]
    nt = np.linalg.norm(t)
    uu = np.zeros(3)
    uu[idx] = 1.0 if c > 0 else -1.0

    # Rotation bringing the baseline onto the chosen axis.
    ww = np.cross(t, uu)
    nw = np.linalg.norm(ww)
    if nw > 0:
        ww *= math.acos(min(abs(c) / nt, 1.0)) / nw
    wR = _rodrigues_to_mat(ww)

    R1 = wR @ r_r.T
    R2 = wR @ r_r
    t = R2 @ T  # baseline expressed in the rectified frame

    # Common focal length: the non-baseline-axis focal, averaged over cameras.
    ratio = 0.5  # new image size == image size
    fc_new = (K1[idx ^ 1, idx ^ 1] + K2[idx ^ 1, idx ^ 1]) * ratio

    # New principal points: center the undistorted corner cloud.
    cc_new = np.zeros((2, 2))
    for k, (K, dist, Rk) in enumerate(
        ((K1, dist_left, R1), (K2, dist_right, R2))
    ):
        corners = np.array(
            [[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]], dtype=np.float64
        )
        norm = undistort_points(corners, K, dist)
        A_tmp = np.array([[fc_new, 0, 0], [0, fc_new, 0], [0, 0, 1.0]])
        hpts = np.concatenate([norm, np.ones((4, 1))], axis=1) @ Rk.T
        proj = (hpts @ A_tmp.T)
        proj = proj[:, :2] / proj[:, 2:3]
        avg = proj.mean(axis=0)
        cc_new[k, 0] = (w - 1) / 2 - avg[0]
        cc_new[k, 1] = (h - 1) / 2 - avg[1]

    if zero_disparity:
        cc_new[0] = cc_new[1] = cc_new.mean(axis=0)
    elif idx == 0:
        cc_new[:, 1] = cc_new[:, 1].mean()
    else:
        cc_new[:, 0] = cc_new[:, 0].mean()

    P1 = np.zeros((3, 4))
    P1[0, 0] = P1[1, 1] = fc_new
    P1[0, 2], P1[1, 2] = cc_new[0]
    P1[2, 2] = 1.0
    P2 = P1.copy()
    P2[0, 2], P2[1, 2] = cc_new[1]
    P2[idx, 3] = t[idx] * fc_new

    alpha = min(alpha, 1.0)
    inner1, outer1 = _get_rectangles(K1, dist_left, R1, P1, img_size)
    inner2, outer2 = _get_rectangles(K2, dist_right, R2, P2, img_size)

    cx1_0, cy1_0 = cc_new[0]
    cx2_0, cy2_0 = cc_new[1]
    cx1, cy1, cx2, cy2 = cx1_0, cy1_0, cx2_0, cy2_0  # new size == old size
    s = 1.0
    if alpha >= 0:
        def s_all(inner, cx0, cy0, cx, cy, red):
            ix, iy, iw, ih = inner
            vals = [cx / (cx0 - ix), cy / (cy0 - iy),
                    (w - 1 - cx) / (ix + iw - cx0),
                    (h - 1 - cy) / (iy + ih - cy0)]
            return red(vals)

        s0 = max(s_all(inner1, cx1_0, cy1_0, cx1, cy1, max),
                 s_all(inner2, cx2_0, cy2_0, cx2, cy2, max))
        s1 = min(s_all(outer1, cx1_0, cy1_0, cx1, cy1, min),
                 s_all(outer2, cx2_0, cy2_0, cx2, cy2, min))
        s = s0 * (1 - alpha) + s1 * alpha

    fc_new *= s
    P1[0, 0] = P1[1, 1] = fc_new
    P1[0, 2], P1[1, 2] = cx1, cy1
    P2[0, 0] = P2[1, 1] = fc_new
    P2[0, 2], P2[1, 2] = cx2, cy2
    P2[idx, 3] = t[idx] * fc_new

    def make_roi(inner, cx0, cy0, cx, cy):
        ix, iy, iw, ih = inner
        x0 = int(math.ceil((ix - cx0) * s + cx))
        y0 = int(math.ceil((iy - cy0) * s + cy))
        ww_ = int(math.floor(iw * s))
        hh_ = int(math.floor(ih * s))
        # intersect with the image rect
        x1 = min(x0 + ww_, w)
        y1 = min(y0 + hh_, h)
        x0 = max(x0, 0)
        y0 = max(y0, 0)
        return (x0, y0, max(x1 - x0, 0), max(y1 - y0, 0))

    roi1 = make_roi(inner1, cx1_0, cy1_0, cx1, cy1)
    roi2 = make_roi(inner2, cx2_0, cy2_0, cx2, cy2)

    Q = np.array(
        [
            [1, 0, 0, -P1[0, 2]],
            [0, 1, 0, -P1[1, 2]],
            [0, 0, 0, fc_new],
            [0, 0, -1.0 / t[idx], (P1[0, 2] - P2[0, 2]) / t[idx]],
        ]
    )
    return R1, R2, P1, P2, Q, roi1, roi2


def init_undistort_rectify_map(K, dist, R, P, img_size):
    """Per-pixel inverse rectification map: dst pixel -> src pixel coords.

    Float32 analog of ``cv2.initUndistortRectifyMap`` (reference
    stereo_camera.py:19-22; the reference requests fixed-point CV_16SC2 maps,
    we keep float32 (H, W) ``map_x``/``map_y`` arrays for the device gather
    kernel — same information, no quantization).
    """
    K = np.asarray(K, dtype=np.float64)
    P = np.asarray(P, dtype=np.float64)
    R = np.eye(3) if R is None else np.asarray(R, dtype=np.float64)
    w, h = img_size

    A = P[:3, :3]
    iR = np.linalg.inv(A @ R)
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    X = iR[0, 0] * u + iR[0, 1] * v + iR[0, 2]
    Y = iR[1, 0] * u + iR[1, 1] * v + iR[1, 2]
    Wc = iR[2, 0] * u + iR[2, 1] * v + iR[2, 2]
    x = X / Wc
    y = Y / Wc
    xd, yd = _distort_normalized(x, y, dist)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    map_x = (fx * xd + cx).astype(np.float32)
    map_y = (fy * yd + cy).astype(np.float32)
    return map_x, map_y
