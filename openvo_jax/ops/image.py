"""Elementwise / stencil image primitives (grayscale, blur, sobel, resize).

JAX replacements for small OpenCV calls used by the reference:
 - ``cv2.cvtColor(BGR2GRAY)`` (reference stereo_camera.py:44-47) -> :func:`bgr_to_gray`
 - Gaussian smoothing + Sobel gradients are internal stages of OpenCV's ORB and
   SGBM implementations that we must supply ourselves (SURVEY.md N4/N7).

Everything here is pure jnp; XLA fuses these into neighboring kernels.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np


def bgr_to_gray(img):
    """BGR (H, W, 3) -> gray (H, W); OpenCV weights 0.114 B + 0.587 G + 0.299 R."""
    w = jnp.array([0.114, 0.587, 0.299], dtype=jnp.float32)
    g = jnp.tensordot(img.astype(jnp.float32), w, axes=([-1], [0]))
    if jnp.issubdtype(img.dtype, jnp.integer):
        return jnp.clip(jnp.round(g), 0, 255).astype(img.dtype)
    return g


def _reflect101_pad(img, ry, rx):
    """OpenCV BORDER_REFLECT_101 padding (edge pixel not repeated)."""
    return jnp.pad(img, ((ry, ry), (rx, rx)), mode="reflect")


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV-compatible 1D Gaussian (cv2.getGaussianKernel semantics)."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    r = (ksize - 1) / 2.0
    x = np.arange(ksize) - r
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur with REFLECT_101 borders (matches cv2 defaults
    used before BRIEF sampling inside OpenCV's ORB)."""
    k = jnp.asarray(gaussian_kernel_1d(ksize, sigma))
    r = ksize // 2
    x = _reflect101_pad(img.astype(jnp.float32), r, r)
    # Horizontal then vertical pass via shifted adds (small ksize -> unrolled).
    h = sum(k[i] * x[:, i : i + img.shape[1]] for i in range(ksize))
    v = sum(k[i] * h[i : i + img.shape[0], :] for i in range(ksize))
    return v


def sobel_xy(img):
    """3x3 Sobel dx, dy with REFLECT_101 borders (float32)."""
    x = _reflect101_pad(img.astype(jnp.float32), 1, 1)
    H, W = img.shape

    def sh(dy, dx):
        return x[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]

    dx = (
        (sh(-1, 1) + 2 * sh(0, 1) + sh(1, 1))
        - (sh(-1, -1) + 2 * sh(0, -1) + sh(1, -1))
    )
    dy = (
        (sh(1, -1) + 2 * sh(1, 0) + sh(1, 1))
        - (sh(-1, -1) + 2 * sh(-1, 0) + sh(-1, 1))
    )
    return dx, dy


def box_filter(img, ksize: int):
    """ksize x ksize unnormalized box sum, same-size output, zero padding."""
    r = ksize // 2
    x = jnp.pad(img.astype(jnp.float32), ((r, r), (r, r)))
    H, W = img.shape
    h = sum(x[:, i : i + W] for i in range(ksize))
    return sum(h[i : i + H, :] for i in range(ksize))


def resize_bilinear(img, out_h: int, out_w: int):
    """Bilinear resize with half-pixel centers (cv2.resize INTER_LINEAR)."""
    return jax.image.resize(img.astype(jnp.float32), (out_h, out_w), "linear")
