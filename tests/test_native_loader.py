"""Native C++ frame loader: PNG/PNM decode + prefetch ring."""

import numpy as np
import pytest

from openvo_jax.io.native_loader import (FrameLoader, decode_image,
                                         decode_pnm, write_pgm)


def test_decode_png_gray_vs_cv2(tmp_path):
    """Native PNG decode (zlib inflate + scanline filters) must reproduce
    a cv2-encoded 8-bit gray PNG bit-for-bit — the KITTI frame format
    (dataset IO without cv2)."""
    import cv2
    rng = np.random.default_rng(0)
    # Smooth gradient + noise: makes the encoder use Sub/Up/Avg/Paeth
    # filters, not just None.
    yy, xx = np.mgrid[0:120, 0:160]
    img = np.clip(yy + xx * 0.5 + rng.integers(0, 30, (120, 160)),
                  0, 255).astype(np.uint8)
    p = str(tmp_path / "g.png")
    assert cv2.imwrite(p, img)
    with open(p, "rb") as f:
        out = decode_image(f.read())
    np.testing.assert_array_equal(out, img)


def test_decode_png_color_vs_cv2(tmp_path):
    import cv2
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(40, 56, 3), dtype=np.uint8)
    p = str(tmp_path / "c.png")
    assert cv2.imwrite(p, img)  # cv2 writes BGR byte order
    with open(p, "rb") as f:
        out = decode_image(f.read())
    # PNG stores RGB; cv2.imwrite wrote our array as BGR -> flip channels.
    np.testing.assert_array_equal(out, img[..., ::-1])


def test_frame_loader_streams_png(tmp_path):
    import cv2
    rng = np.random.default_rng(2)
    paths, imgs = [], []
    for i in range(5):
        img = rng.integers(0, 256, size=(24, 32), dtype=np.uint8)
        p = str(tmp_path / f"p{i}.png")
        assert cv2.imwrite(p, img)
        paths.append(p)
        imgs.append(img)
    loader = FrameLoader(paths, ring_capacity=2)
    got = list(loader)
    assert len(got) == 5
    for a, b in zip(got, imgs):
        np.testing.assert_array_equal(a, b)
    loader.close()


def test_decode_png_rejects_garbage():
    with pytest.raises(ValueError):
        decode_image(b"\x89PNG\r\n\x1a\n" + b"\x00" * 40)


def test_decode_pgm_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(48, 64), dtype=np.uint8)
    p = str(tmp_path / "a.pgm")
    write_pgm(p, img)
    with open(p, "rb") as f:
        out = decode_pnm(f.read())
    np.testing.assert_array_equal(out, img)


def test_decode_ppm_with_comments():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(5, 7, 3), dtype=np.uint8)
    buf = b"P6\n# a comment\n7 5\n# another\n255\n" + img.tobytes()
    out = decode_pnm(buf)
    np.testing.assert_array_equal(out, img)


def test_decode_rejects_garbage():
    with pytest.raises(ValueError):
        decode_pnm(b"JUNKJUNKJUNKJUNK")
    with pytest.raises(ValueError):
        decode_pnm(b"P5\n10 10\n255\nshort")  # truncated payload


def test_frame_loader_streams_in_order(tmp_path):
    rng = np.random.default_rng(2)
    paths = []
    imgs = []
    for i in range(9):
        img = rng.integers(0, 256, size=(32, 40), dtype=np.uint8)
        p = str(tmp_path / f"f{i:03d}.pgm")
        write_pgm(p, img)
        paths.append(p)
        imgs.append(img)
    loader = FrameLoader(paths, ring_capacity=3)
    got = list(loader)
    assert len(got) == 9
    for a, b in zip(got, imgs):
        np.testing.assert_array_equal(a, b)
    loader.close()


def test_frame_loader_bad_file_raises(tmp_path):
    p = str(tmp_path / "bad.pgm")
    with open(p, "wb") as f:
        f.write(b"not a pnm at all")
    loader = FrameLoader([p])
    with pytest.raises(ValueError):
        next(loader)
    loader.close()
