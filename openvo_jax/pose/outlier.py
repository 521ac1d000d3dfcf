"""Median-residual outlier rejection (single pass).

Behavior-exact rebuild of the reference's optional outlier pass
(stereo_odometer.py:189-197): fit a rigid transform on the current inlier
set, compute each correspondence's relative residual, and keep points whose
residual is strictly below ``outlier_threshold + median(residuals)``.

The median matches ``np.median`` semantics over the *valid* subset (average
of the two middle order statistics for even counts), computed with a masked
sort so it works on fixed-capacity padded arrays under jit.
"""

from __future__ import annotations

import jax.numpy as jnp

from openvo_jax.pose.kabsch import kabsch, residuals_relative


def masked_median(values, mask):
    """np.median over the masked subset of ``values`` (1D, padded).

    Like np.median, returns NaN if any selected value is NaN (the reference
    relies on this: a NaN residual turns the outlier threshold into NaN and
    every comparison against it False, emptying the inlier set).
    """
    big = jnp.asarray(jnp.inf, values.dtype)
    v = jnp.where(mask, values, big)
    v = jnp.sort(v)
    n = jnp.sum(mask.astype(jnp.int32))
    lo = jnp.maximum((n - 1) // 2, 0)
    hi = jnp.maximum(n // 2, 0)
    med = 0.5 * (v[lo] + v[hi])
    has_nan = jnp.any(jnp.isnan(values) & mask)
    return jnp.where(has_nan, jnp.nan, med)


def outlier_filter(src, dst, mask, outlier_threshold):
    """One round of fit + relative-residual gating.

    Returns the refined mask (subset of ``mask``). Matches the reference: the
    pre-fit uses all currently-valid points, the gate is strict ``<``.
    """
    T = kabsch(src, dst, mask)
    err = residuals_relative(T, src, dst, mask)
    thresh = outlier_threshold + masked_median(err, mask)
    return mask & (err < thresh)
