"""Multi-camera rig batching: vmap over stereo pairs (BASELINE config 4).

The reference is strictly single-camera; this build scales to an N-camera
stereo rig by vmapping the entire per-frame odometer step over a leading
camera axis — one XLA program processes all cameras' frames concurrently on
one device, filling it with batched work.

All cameras share calibration (the synthetic-rig case); per-camera
calibration batching would only change the closed-over map constants into
batched operands.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from openvo_jax.config import OdometerConfig
from openvo_jax.models.stereo_odometer import init_state, make_step


def make_rig_step(camera, cfg: OdometerConfig, color: bool = False):
    """Batched step: (states, imgsL (N,H,W), imgsR) -> (states', oks, stats)."""
    step = make_step(camera, cfg, color)
    return jax.vmap(step)


def init_rig_state(camera, cfg: OdometerConfig, n_cameras: int):
    one = init_state(camera.cropped_shape, cfg.orb.max_keypoints)
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (n_cameras,) + x.shape), one
    )


class RigOdometer:
    """N independent odometers advanced by one vmapped XLA program."""

    def __init__(self, camera, n_cameras: int,
                 config: OdometerConfig | None = None):
        self.camera = camera
        self.config = config or OdometerConfig()
        self.n_cameras = n_cameras
        self._state = init_rig_state(camera, self.config, n_cameras)
        self._step = jax.jit(make_rig_step(camera, self.config),
                             donate_argnums=(0,))

    def update(self, imgs_left, imgs_right):
        """imgs_*: (N, H, W). Returns per-camera success flags (N,)."""
        self._state, oks, stats = self._step(
            self._state, jnp.asarray(imgs_left), jnp.asarray(imgs_right)
        )
        self.last_stats = jax.tree_util.tree_map(np.asarray, stats)
        return np.asarray(oks)

    def current_poses(self):
        return np.linalg.inv(np.asarray(self._state.c_T_w, dtype=np.float64))
