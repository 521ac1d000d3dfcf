"""Pose overlay rendering (API parity with reference utils/drawPoseOnImage.py).

The reference draws four red Hershey-font text lines of RPY + translation at
the bottom of the frame via ``cv2.putText`` (drawPoseOnImage.py:27-38).
SURVEY.md N11 classifies this as a host-side utility, so it is implemented
here with a dependency-free 5x7 bitmap font rasterized by NumPy: same text
content, same line layout (heights H-180/-120/-60/-10), same red color, same
camera->aircraft axis remap (displayed Roll = yaw, Pitch = -pitch,
Yaw = roll; reference :23-26), same smaller-norm Euler-branch selection
(reference :8-16). Draws in place and returns the image.
"""

from __future__ import annotations

import numpy as np

from openvo_jax.utils.rot2rpy import rot2RPY

# 5x7 bitmap glyphs for the characters the overlay uses. Each glyph is 7 rows
# of 5 bits, MSB left.
_GLYPHS = {
    "0": [0x0E, 0x11, 0x13, 0x15, 0x19, 0x11, 0x0E],
    "1": [0x04, 0x0C, 0x04, 0x04, 0x04, 0x04, 0x0E],
    "2": [0x0E, 0x11, 0x01, 0x02, 0x04, 0x08, 0x1F],
    "3": [0x1F, 0x02, 0x04, 0x02, 0x01, 0x11, 0x0E],
    "4": [0x02, 0x06, 0x0A, 0x12, 0x1F, 0x02, 0x02],
    "5": [0x1F, 0x10, 0x1E, 0x01, 0x01, 0x11, 0x0E],
    "6": [0x06, 0x08, 0x10, 0x1E, 0x11, 0x11, 0x0E],
    "7": [0x1F, 0x01, 0x02, 0x04, 0x08, 0x08, 0x08],
    "8": [0x0E, 0x11, 0x11, 0x0E, 0x11, 0x11, 0x0E],
    "9": [0x0E, 0x11, 0x11, 0x0F, 0x01, 0x02, 0x0C],
    "R": [0x1E, 0x11, 0x11, 0x1E, 0x14, 0x12, 0x11],
    "P": [0x1E, 0x11, 0x11, 0x1E, 0x10, 0x10, 0x10],
    "Y": [0x11, 0x11, 0x0A, 0x04, 0x04, 0x04, 0x04],
    "o": [0x00, 0x00, 0x0E, 0x11, 0x11, 0x11, 0x0E],
    "l": [0x0C, 0x04, 0x04, 0x04, 0x04, 0x04, 0x0E],
    "i": [0x04, 0x00, 0x0C, 0x04, 0x04, 0x04, 0x0E],
    "t": [0x08, 0x08, 0x1C, 0x08, 0x08, 0x09, 0x06],
    "c": [0x00, 0x00, 0x0E, 0x10, 0x10, 0x11, 0x0E],
    "h": [0x10, 0x10, 0x16, 0x19, 0x11, 0x11, 0x11],
    "a": [0x00, 0x00, 0x0E, 0x01, 0x0F, 0x11, 0x0F],
    "w": [0x00, 0x00, 0x11, 0x11, 0x15, 0x15, 0x0A],
    "x": [0x00, 0x00, 0x11, 0x0A, 0x04, 0x0A, 0x11],
    "y": [0x00, 0x00, 0x11, 0x11, 0x0F, 0x01, 0x0E],
    "z": [0x00, 0x00, 0x1F, 0x02, 0x04, 0x08, 0x1F],
    "=": [0x00, 0x00, 0x1F, 0x00, 0x1F, 0x00, 0x00],
    "-": [0x00, 0x00, 0x00, 0x1F, 0x00, 0x00, 0x00],
    ".": [0x00, 0x00, 0x00, 0x00, 0x00, 0x0C, 0x0C],
    ",": [0x00, 0x00, 0x00, 0x00, 0x0C, 0x04, 0x08],
    " ": [0x00] * 7,
}


def _render_text(img, text, org, scale, color):
    """Rasterize ``text`` at ``org`` = (x, baseline_y) with integer scale."""
    h, w = img.shape[:2]
    x0, y_base = org
    gh, gw = 7 * scale, 5 * scale
    y0 = y_base - gh
    x = x0
    for ch in text:
        rows = _GLYPHS.get(ch, _GLYPHS[" "])
        for r, bits in enumerate(rows):
            for c in range(5):
                if bits & (1 << (4 - c)):
                    ys = y0 + r * scale
                    xs = x + c * scale
                    ye, xe = ys + scale, xs + scale
                    if 0 <= ys and ye <= h and 0 <= xs and xe <= w:
                        img[ys:ye, xs:xe] = color
        x += gw + scale  # 1-glyph-pixel spacing
    return img


def drawPoseOnImage(T, img):
    """Draw RPY + xyz of pose ``T`` onto BGR image ``img`` (in place)."""
    T = np.asarray(T, dtype=np.float64)
    roll, pitch, yaw = rot2RPY(T)
    rep = [np.linalg.norm([roll[i], pitch[i], yaw[i]]) for i in (0, 1)]
    i = 1 if rep[0] > rep[1] else 0
    r, p, y = roll[i].item(), pitch[i].item(), yaw[i].item()

    t_x, t_y, t_z = float(T[0, 3]), float(T[1, 3]), float(T[2, 3])
    hgt = img.shape[0]
    color = (0, 0, 255) if img.ndim == 3 else 255  # BGR red
    lines = [
        (f"Roll = {np.round(y, 3)}", hgt - 180, 4),
        (f"Pitch = {np.round(-p, 3)}", hgt - 120, 4),
        (f"Yaw = {np.round(r, 3)}", hgt - 60, 4),
        (
            f"x,y,z = {np.round(t_x, 1)}, {np.round(t_y, 1)}, {np.round(t_z, 1)}",
            hgt - 10,
            3,
        ),
    ]
    for text, ybase, scale in lines:
        _render_text(img, text, (0, ybase), scale, color)
    return img
