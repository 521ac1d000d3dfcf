"""KITTI odometry dataset loader (used when a local KITTI tree is available).

The benchmark environment ships no dataset, so this module is exercised only
when ``KITTI_ROOT`` points at a standard KITTI odometry layout::

    <root>/sequences/<seq>/image_0/*.png   (left gray)
    <root>/sequences/<seq>/image_1/*.png   (right gray)
    <root>/sequences/<seq>/calib.txt
    <root>/poses/<seq>.txt                 (ground truth, optional)

PNG decoding is NATIVE: the C++ frame loader (io/native/frameloader.cpp)
decodes KITTI's 8-bit PNGs (zlib inflate + scanline filters) and prefetches
them on a background thread — no cv2 anywhere in the dataset path.
"""

from __future__ import annotations

import os

import numpy as np

from openvo_jax.config import SGBMParams

KITTI_SGBM = SGBMParams(
    min_disparity=0, num_disparities=128, block_size=5,
    p1=8 * 25, p2=32 * 25, disp12_max_diff=1, pre_filter_cap=63,
    uniqueness_ratio=10, speckle_window_size=100, speckle_range=2,
)


def kitti_root():
    return os.environ.get("KITTI_ROOT")


def available(seq: str = "00") -> bool:
    root = kitti_root()
    return bool(root) and os.path.isdir(
        os.path.join(root, "sequences", seq, "image_0")
    )


def load_calib(seq: str = "00"):
    """Parse calib.txt -> dict of P0..P3 (3x4) projection matrices plus the
    derived (K, baseline) of the gray stereo pair."""
    path = os.path.join(kitti_root(), "sequences", seq, "calib.txt")
    mats = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            name, vals = line.split(":", 1)
            arr = np.fromstring(vals, sep=" ")
            if arr.size == 12:
                mats[name.strip()] = arr.reshape(3, 4)
    K = mats["P0"][:, :3]
    # P1 = K [I | t] with t_x = -fx * baseline
    baseline = -mats["P1"][0, 3] / mats["P1"][0, 0]
    return {"K": K, "baseline": float(baseline), "P": mats}


def load_poses(seq: str = "00"):
    path = os.path.join(kitti_root(), "poses", f"{seq}.txt")
    rows = np.loadtxt(path)
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, :4] = rows.reshape(-1, 3, 4)
    return poses


def frame_paths(seq: str = "00"):
    base = os.path.join(kitti_root(), "sequences", seq)
    left = sorted(os.listdir(os.path.join(base, "image_0")))
    return (
        [os.path.join(base, "image_0", f) for f in left],
        [os.path.join(base, "image_1", f) for f in left],
    )


def load_frame(path):
    """Decode one KITTI frame with the native C++ decoder (grayscale)."""
    from openvo_jax.io.native_loader import decode_image

    with open(path, "rb") as f:
        img = decode_image(f.read())
    if img.ndim == 3:  # RGB -> gray, BT.601 like cv2.IMREAD_GRAYSCALE
        img = np.clip(np.round(
            0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
        ), 0, 255).astype(np.uint8)
    return img


def frame_stream(seq: str = "00", ring_capacity: int = 4):
    """Prefetching (left, right) uint8 frame iterator over a sequence —
    disk IO + PNG decode overlap device compute via the C++ ring."""
    from openvo_jax.io.native_loader import FrameLoader

    lefts, rights = frame_paths(seq)
    lt = FrameLoader(lefts, ring_capacity)
    rt = FrameLoader(rights, ring_capacity)
    return zip(lt, rt)
