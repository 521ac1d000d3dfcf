"""openvo_jax: a JAX-native visual-odometry framework.

Built from scratch in JAX/XLA with the full capability surface of the
openVO reference (see SURVEY.md): stereo rectification, SGBM disparity, ORB
features, Hamming matching, rigid 3D-3D pose estimation and the
frame-to-frame tracking loop — every OpenCV C++ primitive re-implemented as
accelerator compute so the per-frame update jit-compiles to one XLA program
(with one CUDA kernel, SGM path aggregation, on NVIDIA GPUs).

Public API mirrors the reference's four exports (reference
src/openVO/__init__.py:1-5) plus this framework's extensions.
"""

from openvo_jax.config import OdometerConfig, ORBParams, SGBMParams
from openvo_jax.models.stereo_camera import StereoCamera
from openvo_jax.models.stereo_odometer import StereoOdometer
from openvo_jax.utils.rot2rpy import rot2RPY
from openvo_jax.utils.draw_pose import drawPoseOnImage

__version__ = "0.1.0"

__all__ = [
    "StereoCamera",
    "StereoOdometer",
    "rot2RPY",
    "drawPoseOnImage",
    "OdometerConfig",
    "ORBParams",
    "SGBMParams",
]
