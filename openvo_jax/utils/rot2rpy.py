"""Public ``rot2RPY`` (API parity with reference utils/rot2RPY.py:3-38).

Accepts a 4x4 (or any matrix whose top-left 3x3 is the rotation) and returns
(roll, pitch, yaw), each a (2, 1) numpy array holding both Euler branches,
exactly like the reference. Delegates to the jit-capable implementation in
:mod:`openvo_jax.geometry.se3`.
"""

from __future__ import annotations

import numpy as np

from openvo_jax.geometry.se3 import rot2rpy


def rot2RPY(T):
    roll, pitch, yaw = rot2rpy(np.asarray(T, dtype=np.float64))
    return (np.asarray(roll, dtype=np.float64),
            np.asarray(pitch, dtype=np.float64),
            np.asarray(yaw, dtype=np.float64))
