"""Spatial row-tiling of SGBM across a device mesh (SURVEY.md section 2c
"spatial sharding"): validated on an 8-virtual-CPU-device mesh in a
subprocess, bit-identical against the single-device pipeline — including
at a 2K-wide frame."""

import os
import subprocess
import sys

import pytest

SUB = r"""
import numpy as np
import jax
import jax.numpy as jnp

from openvo_jax.config import SGBMParams
from openvo_jax.io.synthetic import render_stereo_sequence
from openvo_jax.ops.sgbm import sgbm_disparity16
from openvo_jax.parallel.tiling import make_row_mesh, make_tiled_sgbm_fn

assert len(jax.devices()) == 8, jax.devices()

def check(img_size, num_disp):
    w, h = img_size
    params = SGBMParams(num_disparities=num_disp, block_size=5, p1=200,
                        p2=800, disp12_max_diff=1, pre_filter_cap=63,
                        uniqueness_ratio=10)
    seq = render_stereo_sequence(n_frames=1, img_size=img_size, f=220.0,
                                 baseline=0.4, seed=0)
    left = np.clip(seq["left"][0], 0, 255).astype(np.uint8)
    right = np.clip(seq["right"][0], 0, 255).astype(np.uint8)
    ref = np.asarray(sgbm_disparity16(jnp.asarray(left), jnp.asarray(right),
                                      params))
    mesh = make_row_mesh(8)
    fn = make_tiled_sgbm_fn(params, mesh)
    out = np.asarray(fn(jnp.asarray(left), jnp.asarray(right)))
    assert out.shape == ref.shape, (out.shape, ref.shape)
    neq = (out != ref).sum()
    assert neq == 0, f"{img_size}: {neq}/{ref.size} pixels differ"
    print(f"tiled == single-device at {img_size} ({ref.size} px)")

check((256, 96), 32)     # standard small frame
check((2048, 64), 32)    # 2K-wide frame (SURVEY 2c long-context analog)

# Indivisible H raises a clear ValueError, not a cryptic XLA sharding
# error.
params = SGBMParams(num_disparities=32, block_size=5, p1=200, p2=800)
fn = make_tiled_sgbm_fn(params, make_row_mesh(8))
try:
    fn(jnp.zeros((97, 128), jnp.uint8), jnp.zeros((97, 128), jnp.uint8))
    raise AssertionError("expected ValueError for H=97 on 8 devices")
except ValueError as e:
    assert "divisible" in str(e), e
print("TILED_OK")
"""

SPECKLE_SUB = r"""
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp

from openvo_jax.config import SGBMParams
from openvo_jax.io.synthetic import render_stereo_sequence
from openvo_jax.ops.sgbm import sgbm_disparity16
from openvo_jax.parallel.tiling import make_row_mesh, make_tiled_sgbm_fn

assert len(jax.devices()) == 8, jax.devices()
params = SGBMParams(num_disparities=32, block_size=5, p1=200, p2=800,
                    disp12_max_diff=1, pre_filter_cap=63,
                    uniqueness_ratio=10, speckle_window_size=50,
                    speckle_range=2)
seq = render_stereo_sequence(n_frames=1, img_size=(256, 96), f=220.0,
                             baseline=0.4, seed=0)
left = np.clip(seq["left"][0], 0, 255).astype(np.uint8)
right = np.clip(seq["right"][0], 0, 255).astype(np.uint8)
ref = np.asarray(sgbm_disparity16(jnp.asarray(left), jnp.asarray(right),
                                  params))
fn = make_tiled_sgbm_fn(params, make_row_mesh(8))
out = np.asarray(fn(jnp.asarray(left), jnp.asarray(right)))
neq = (out != ref).sum()
assert neq == 0, f"{neq}/{ref.size} pixels differ with speckle on"
print("SPECKLE_TILED_OK")
"""


def _cpu_mesh_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    return env


def _run_sub(code):
    return subprocess.run(
        [sys.executable, "-c", code],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=_cpu_mesh_env(), capture_output=True, text=True, timeout=3000,
    )


@pytest.mark.slow
def test_tiled_sgbm_bit_identical_on_cpu_mesh():
    out = _run_sub(SUB)
    assert "TILED_OK" in out.stdout, out.stdout + out.stderr


@pytest.mark.slow
def test_tiled_sgbm_speckle_on_cpu_mesh():
    """The tiled path accepts speckle params: the
    all_gather + replicated pointer-jump pass must reproduce the
    single-device cv2-oracle-validated filter bit-for-bit. Matches
    reference stereo_camera.py:24-27 (speckle params always honored)."""
    out = _run_sub(SPECKLE_SUB)
    assert "SPECKLE_TILED_OK" in out.stdout, out.stdout + out.stderr
