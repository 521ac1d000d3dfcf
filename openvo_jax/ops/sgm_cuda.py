"""SGM path aggregation as a CUDA kernel for Hopper, called through XLA's FFI.

Route: CUDA C++ for ``sm_90a`` (``ops/cuda/sgm_paths.cu``), compiled with
``nvcc`` into the git-ignored ``ops/cuda/build/`` at first use on a machine
with a CUDA device, and registered as the FFI target ``openvo_sgm_paths``.
One warp walks one scanline of one direction; the d+-1 exchange and the min
over d are warp shuffles and one warp reduction (see the .cu file).

What stays in Python, and so is tested on the CPU: the decomposition of each
direction into lines (:func:`path_lines`), the padding of the disparity axis
to a multiple of 16, the batching rule and the argument checks. The plain
reference with the same semantics is ``ops/sgbm.py:path_sum_xla``; the
choice between the two is made at lowering time by ``ops/sgbm.py:path_sum``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

TARGET = "openvo_sgm_paths"
BIG = 1e9  # the path-restart value of ops/sgbm.py
MAX_DISP = 512  # 16 disparities per lane
_SRC = os.path.join(os.path.dirname(__file__), "cuda", "sgm_paths.cu")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "cuda", "build")
_lock = threading.Lock()
_registered = False


def path_lines(H: int, W: int, dirs) -> np.ndarray:
    """The scanlines of each direction as an (n, 5) int32 table.

    A direction ``(dy, dx)`` gives pixel (y, x) the predecessor
    (y - dy, x - dx). Row ``(dir, y0, x0, length, init_x)`` is one line:
    it starts at (y0, x0) and takes ``length`` steps of (dy, dx).
    ``init_x`` is the column of the init row that is the first pixel's
    predecessor, or -1 where the line starts from BIG: every horizontal
    line, and a line that enters from the side. Rows are sorted longest
    first so that the longest lines start first on the card.
    """
    blocks = []
    for i, (dy, dx) in enumerate(dirs):
        if dy == 0:
            y0 = np.arange(H)
            x0 = np.full(H, 0 if dx > 0 else W - 1)
        else:
            y_first = 0 if dy > 0 else H - 1
            y0 = np.full(W, y_first)
            x0 = np.arange(W)
            if dx != 0:  # diagonals also enter from the side
                k = np.arange(1, H)
                y0 = np.concatenate([y0, y_first + dy * k])
                x_side = 0 if dx > 0 else W - 1
                x0 = np.concatenate([x0, np.full(H - 1, x_side)])
        n_y = H - y0 if dy > 0 else (y0 + 1 if dy < 0 else np.full_like(y0, H))
        n_x = W - x0 if dx > 0 else (x0 + 1 if dx < 0 else np.full_like(x0, W))
        length = n_x if dy == 0 else np.minimum(n_y, n_x)
        xi = x0 - dx
        from_init = (dy != 0) & (y0 == (0 if dy > 0 else H - 1))
        from_init &= (xi >= 0) & (xi < W)
        init_x = np.where(from_init, xi, -1)
        blocks.append(np.stack(
            [np.full_like(y0, i), y0, x0, length, init_x], axis=1))
    table = np.concatenate(blocks).astype(np.int32)
    return table[np.argsort(-table[:, 3], kind="stable")]


def _cuda_device_present() -> bool:
    try:
        return bool(jax.devices("cuda"))
    except RuntimeError:
        return False


def _build() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    lib = os.path.join(_BUILD_DIR, f"libsgm_paths-{tag}.so")
    if os.path.exists(lib):
        return lib
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {_SRC}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def ensure_registered() -> None:
    """Build the kernel library and register its FFI target, once per
    process. A no-op without a CUDA device, where the kernel's branch is
    traced but never lowered."""
    global _registered
    with _lock:
        if _registered or not _cuda_device_present():
            return
        lib = ctypes.cdll.LoadLibrary(_build())
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.SgmPaths), platform="CUDA")
        _registered = True


@functools.lru_cache(maxsize=None)
def _lines_const(H: int, W: int, dirs: tuple) -> np.ndarray:
    return path_lines(H, W, dirs)


def path_sum(cost, dirs, p1: float, p2: float, init=None):
    """Kernel form of ``ops/sgbm.py:path_sum_xla``: (S, carry) for the
    directions ``dirs`` over an (H, W, D) int16 (x2 grid) or f32 volume.

    ``init`` (n_dirs, W, D) seeds the row before the first scan row of the
    vertical and diagonal directions (BIG if None); ``carry`` (n_dirs, W, D)
    is their last scan row (zeros for horizontal directions). Batches with
    ``jax.vmap``; the kernel walks every batch entry in one launch.
    """
    dirs = tuple((int(dy), int(dx)) for dy, dx in dirs)
    H, W, D = cost.shape[-3:]
    if D > MAX_DISP:
        raise ValueError(f"sgm_paths takes at most {MAX_DISP} disparities, "
                         f"got {D}")
    if cost.dtype != jnp.int16:
        cost = cost.astype(jnp.float32)
    n = len(dirs)
    if init is None:
        init = jnp.full((n, W, D), BIG, jnp.float32)
    init = jnp.asarray(init, jnp.float32)
    pad = -D % 16
    if pad:
        widths = [(0, 0)] * (cost.ndim - 1) + [(0, pad)]
        cost = jnp.pad(cost, widths)
        init = jnp.pad(init, [(0, 0)] * (init.ndim - 1) + [(0, pad)])
    ensure_registered()
    lines = jnp.asarray(_lines_const(H, W, dirs))
    batch = cost.shape[:-3]
    call = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct(cost.shape, jnp.float32),
         jax.ShapeDtypeStruct(batch + (n, W, D + pad), jnp.float32)),
        vmap_method="expand_dims",
    )
    S, carry = call(cost, init, lines,
                    dirs=np.asarray(dirs, np.int32).reshape(-1),
                    num_disp=np.int32(D), p1=np.float32(p1),
                    p2=np.float32(p2))
    if pad:
        S, carry = S[..., :D], carry[..., :D]
    return S, carry
