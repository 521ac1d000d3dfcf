"""ctypes bindings for the native (C++) frame loader.

The reference's frame IO is OpenCV's C++ ``cv2.imread``; this framework's
native runtime component is a small C++ PGM/PPM decoder with a pthread
prefetch ring (openvo_jax/io/native/frameloader.cpp) that overlaps disk IO +
decode with device compute. Bound via ctypes (pybind11 is not available in this
environment); the shared library is built once on demand with g++.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "native", "frameloader.cpp")
_LIB_DIR = os.path.join(os.path.dirname(__file__), "native", "build")
_LIB = os.path.join(_LIB_DIR, "libframeloader.so")
_lock = threading.Lock()
_lib = None


def _build():
    os.makedirs(_LIB_DIR, exist_ok=True)
    subprocess.run(
        ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC,
         "-o", _LIB, "-lpthread", "-lz"],
        check=True, capture_output=True,
    )


def get_lib():
    global _lib
    with _lock:
        if _lib is None:
            if not os.path.exists(_LIB) or (
                os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
            ):
                _build()
            lib = ctypes.CDLL(_LIB)
            lib.loader_create.restype = ctypes.c_void_p
            lib.loader_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ]
            lib.loader_next.restype = ctypes.c_int
            lib.loader_next.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_long, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ]
            lib.loader_destroy.argtypes = [ctypes.c_void_p]
            lib.decode_pnm_buffer.restype = ctypes.c_int
            lib.decode_pnm_buffer.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.decode_image_buffer.restype = ctypes.c_int
            lib.decode_image_buffer.argtypes = lib.decode_pnm_buffer.argtypes
            _lib = lib
    return _lib


def decode_pnm(data: bytes) -> np.ndarray:
    """Decode a PGM (P5) / PPM (P6) buffer to (H, W) or (H, W, 3) uint8."""
    lib = get_lib()
    cap = len(data)  # decoded payload is never larger than the file
    out = np.empty(cap, np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    ok = lib.decode_pnm_buffer(
        buf, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap, ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
    )
    if not ok:
        raise ValueError("not a valid 8-bit P5/P6 PNM buffer")
    n = w.value * h.value * c.value
    img = out[:n]
    if c.value == 1:
        return img.reshape(h.value, w.value).copy()
    return img.reshape(h.value, w.value, c.value).copy()


def decode_image(data: bytes) -> np.ndarray:
    """Decode a PNG (8-bit gray/RGB/RGBA, non-interlaced — the KITTI
    format) or PGM/PPM buffer to (H, W) or (H, W, 3) uint8, using the
    native C++ decoder (no cv2)."""
    lib = get_lib()
    if data[:4] == b"\x89PNG":
        # Size the output exactly from the IHDR (w, h at offsets 16/20).
        w0 = int.from_bytes(data[16:20], "big")
        h0 = int.from_bytes(data[20:24], "big")
        ctype = data[25]
        ch = {0: 1, 2: 3, 6: 3}.get(ctype, 3)
        cap = max(w0 * h0 * ch, 1)
    else:
        cap = len(data)  # PNM payload is never larger than the file
    out = np.empty(cap, np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    ok = lib.decode_image_buffer(
        buf, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap, ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
    )
    if not ok:
        raise ValueError("not a decodable 8-bit PNG/PNM buffer")
    n = w.value * h.value * c.value
    img = out[:n]
    if c.value == 1:
        return img.reshape(h.value, w.value).copy()
    return img.reshape(h.value, w.value, c.value).copy()


def write_pgm(path: str, img: np.ndarray):
    """Write an (H, W) uint8 array as binary PGM (test/tooling helper)."""
    img = np.ascontiguousarray(img, np.uint8)
    with open(path, "wb") as f:
        f.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())


class FrameLoader:
    """Prefetching frame stream over a list of PGM/PPM files.

    A background C++ thread reads and decodes ahead of the consumer, so the
    next frame is (usually) already in memory when the previous one finishes
    on the device. Iterate to receive uint8 numpy frames in order.
    """

    def __init__(self, paths, ring_capacity: int = 4,
                 max_bytes: int = 64 << 20):
        self._lib = get_lib()
        self._paths = [os.fsencode(p) for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = self._lib.loader_create(arr, len(self._paths),
                                               ring_capacity)
        self._max_bytes = max_bytes
        self._n = len(paths)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        out = np.empty(self._max_bytes, np.uint8)
        w = ctypes.c_int()
        h = ctypes.c_int()
        c = ctypes.c_int()
        rc = self._lib.loader_next(
            self._handle,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._max_bytes, ctypes.byref(w), ctypes.byref(h),
            ctypes.byref(c),
        )
        if rc == -1:
            raise StopIteration
        if rc == 0:
            raise ValueError("frame failed to decode (bad file?)")
        n = w.value * h.value * c.value
        img = out[:n]
        if c.value == 1:
            return img.reshape(h.value, w.value).copy()
        return img.reshape(h.value, w.value, c.value).copy()

    def close(self):
        if self._handle:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
