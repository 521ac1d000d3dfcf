"""ORB feature detection + description in JAX.

Replaces ``cv2.ORB_create(nfeatures).detectAndCompute(img, mask)`` (reference
stereo_odometer.py:22,117; SURVEY.md N7). Components, all vectorized over the
whole image with static shapes:

 - scale pyramid (nlevels=8, factor 1.2, bilinear resize),
 - FAST-9/16 corner test computed as ``max over 16 arc starts of the min
   margin over 9 contiguous circle pixels`` (this simultaneously yields the
   corner decision and the FAST score used for 3x3 non-max suppression),
 - Harris corner response (block 7, k=0.04) for ranking, like ORB's default
   HARRIS_SCORE,
 - per-level top-K selection with OpenCV's per-level feature budget split
   (geometric decay by 1/scale_factor),
 - intensity-centroid orientation over the radius-15 circular patch,
 - steered BRIEF-256 using OpenCV's exact rBRIEF test pattern (recovered
   empirically from cv2.ORB.compute and held-out-verified; see
   ops/orb_pattern.py), rotated by the keypoint angle with cv2's GET_VALUE
   rounding and sampled from the uint8-rounded 7x7 sigma=2 Gaussian blur —
   descriptors are bit-comparable with cv2-produced ones (matched
   cross-implementation in tests/test_orb.py), modulo rare near-tie
   rounding flips.

Differences from OpenCV, by design (documented for the parity tests):
 - the detection mask gates candidates *before* per-level top-K (OpenCV
   filters after), which only ever yields more usable masked features.

Variable-length keypoint lists become fixed-capacity padded arrays with a
validity mask (`max_keypoints` rows), the jit-friendly idiom replacing
OpenCV's dynamic vectors.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from openvo_jax.config import ORBParams
from openvo_jax.ops.hamming import pack_bits
from openvo_jax.ops.image import gaussian_blur, resize_bilinear, sobel_xy, box_filter

HALF_PATCH = 15  # intensity-centroid circle radius (OpenCV halfPatchSize)

# FAST segment test circle of radius 3: 16 (dx, dy) offsets in circular order.
FAST_CIRCLE = np.array(
    [
        (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
    ],
    dtype=np.int32,
)


def brief_pattern():
    """OpenCV's ORB rBRIEF 256-pair test pattern (empirically recovered and
    held-out-verified against cv2.ORB.compute; see ops/orb_pattern.py and
    tools/extract_orb_pattern.py). Using the exact cv2 pattern makes our
    descriptors bit-comparable with OpenCV-produced ones (mixed pipelines,
    stored descriptors), modulo rare near-tie rounding flips.
    Returns int32 array (256, 4): (px, py, qx, qy)."""
    from openvo_jax.ops.orb_pattern import CV2_ORB_PATTERN

    return CV2_ORB_PATTERN


@functools.lru_cache(maxsize=None)
def _cv2_umax(radius: int = HALF_PATCH):
    """OpenCV ORB's discretized circle bounds: umax[v] = half-width of the
    intensity-centroid patch at |row| v (cvRound circle with an explicit
    symmetry fix-up — the published ORB initializer's semantics)."""
    r = radius
    vmax = int(np.floor(r * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(r * np.sqrt(2.0) / 2))
    umax = np.zeros(r + 2, np.int64)
    for v in range(vmax + 1):
        # cvRound = round-half-to-even
        umax[v] = int(np.rint(np.sqrt(float(r * r - v * v))))
    v0 = 0
    for v in range(r, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


@functools.lru_cache(maxsize=None)
def centroid_weights(radius: int = HALF_PATCH):
    """(u, v) coordinate weight grids over cv2 ORB's discretized circular
    patch (numpy) — matching IC_Angle's integration domain exactly so our
    orientations track cv2's."""
    r = radius
    umax = _cv2_umax(r)
    v, u = np.mgrid[-r : r + 1, -r : r + 1]
    circ = np.abs(u) <= umax[np.abs(v)]
    return (u * circ).astype(np.float32), (v * circ).astype(np.float32), circ


def features_per_level(nfeatures: int, nlevels: int, scale_factor: float):
    """OpenCV ORB's geometric per-level feature budget."""
    factor = 1.0 / scale_factor
    ndesired = nfeatures * (1 - factor) / (1 - factor**nlevels)
    counts = []
    total = 0
    for _ in range(nlevels - 1):
        c = int(round(ndesired))
        counts.append(c)
        total += c
        ndesired *= factor
    counts.append(max(nfeatures - total, 0))
    return counts


def fast_score(img_f32, threshold: float):
    """FAST-9/16 score map: max over arc starts of min margin over the arc.

    Returns (score, corner_mask); a pixel is a corner iff score > threshold.

    The 16 circle neighbors are kept as a PYTHON list of (H, W) slices and
    the circular log-folding (min over 9 contiguous pixels = 3 doubling
    passes + one +8 fold) rotates the list by Python indexing — the stacked
    (16, H, W) tensor + axis-0 jnp.rolls of an earlier version forced XLA
    to materialize whole-stack intermediates (hundreds of MB per frame once
    the stream path vmaps this over a frame batch); slice lists fuse into
    flat elementwise chains instead.
    """
    H, W = img_f32.shape
    pad = jnp.pad(img_f32, 3, mode="edge")
    neigh = [pad[3 + dy : 3 + dy + H, 3 + dx : 3 + dx + W]
             for dx, dy in FAST_CIRCLE]

    def arc_score(m):
        # min over 9 contiguous circle pixels for each of the 16 starts:
        # m2[k] = min(m[k], m[k+1]), m4 = min over 4, m8 = min over 8,
        # m9[k] = min(m8[k], m[k+8]); rotation is list reindexing (free).
        m2 = [jnp.minimum(m[k], m[(k + 1) % 16]) for k in range(16)]
        m4 = [jnp.minimum(m2[k], m2[(k + 2) % 16]) for k in range(16)]
        m8 = [jnp.minimum(m4[k], m4[(k + 4) % 16]) for k in range(16)]
        m9 = [jnp.minimum(m8[k], m[(k + 8) % 16]) for k in range(16)]
        out = m9[0]
        for k in range(1, 16):
            out = jnp.maximum(out, m9[k])
        return out

    bright = [n - img_f32 for n in neigh]
    dark = [img_f32 - n for n in neigh]
    score = jnp.maximum(arc_score(bright), arc_score(dark))
    return score, score > threshold


def harris_response(img_f32, block_size: int = 7, k: float = 0.04):
    """Harris corner response over the full image (OpenCV HarrisResponses
    uses a 7x7 block sum of Sobel products, scaled; the scale only affects
    ranking monotonically so we keep the raw response)."""
    dx, dy = sobel_xy(img_f32)
    sxx = box_filter(dx * dx, block_size)
    syy = box_filter(dy * dy, block_size)
    sxy = box_filter(dx * dy, block_size)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def _topk_rows(rows2d, k):
    """Batched exact top-k over the last axis of (B, n): the row version of
    :func:`_topk_flat` (same two-stage structure, same tie-breaking), one
    lax.top_k call for all B rows instead of B separate calls."""
    b, n = rows2d.shape
    G = 256
    m = -(-n // G)
    if k >= m or n < 4096:
        return jax.lax.top_k(rows2d, k)
    pad = G * m - n
    rows = jnp.pad(rows2d, ((0, 0), (0, pad)),
                   constant_values=-jnp.inf).reshape(b, G, m)
    rv, ri = jax.lax.top_k(rows, k)
    gi = ri + jnp.arange(G, dtype=jnp.int32)[None, :, None] * m
    fv, fi = jax.lax.top_k(rv.reshape(b, G * k), k)
    return fv, jnp.take_along_axis(gi.reshape(b, G * k), fi, axis=1)


def _topk_flat(flat, k):
    """Exact top-k over a flat array in two stages: reshape to (G, m) rows,
    per-row lax.top_k(k), then lax.top_k over the G*k candidates, so the
    sorting runs on G short rows batched instead of one long array.

    EXACT drop-in for ``lax.top_k(flat, k)`` including tie-breaking:
    groups partition ascending index ranges and per-row top_k prefers the
    lower index on ties, so the candidate array lists any two tied
    elements in ascending original-index order, and an element crowded
    out of its row's top-k loses only to k elements that flat top_k
    would also have preferred."""
    n = flat.shape[0]
    G = 256
    m = -(-n // G)
    if k >= m or n < 4096:
        return jax.lax.top_k(flat, k)
    pad = G * m - n
    rows = jnp.pad(flat, (0, pad), constant_values=-jnp.inf).reshape(G, m)
    rv, ri = jax.lax.top_k(rows, k)
    gi = ri + jnp.arange(G, dtype=jnp.int32)[:, None] * m
    fv, fi = jax.lax.top_k(rv.reshape(-1), k)
    return fv, jnp.take(gi.reshape(-1), fi)


def _nms3x3(score):
    """3x3 non-max suppression: keep pixels equal to their neighborhood max."""
    H, W = score.shape
    pad = jnp.pad(score, 1, constant_values=-jnp.inf)
    mx = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            mx = jnp.maximum(mx, pad[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W])
    return score >= mx


def _detect_level(img_l, mask_l, k_level, params: ORBParams):
    """Detect top-k_level corners on one pyramid level.

    Two retention orders (ORBParams.cv2_ranking):
     - default: rank ALL FAST corners by Harris response — measurably
       better VO accuracy (documented deviation);
     - cv2 mode: OpenCV ORB's exact selection (orb.cpp computeKeyPoints
       with HARRIS_SCORE): FAST corners -> retain the best 2*k by FAST
       score -> re-rank those by Harris -> keep the best k. Gives
       >= 0.92 corner overlap @2 px and exact per-level counts vs cv2.

    Returns (xy (k,2) int32 level coords, response (k,), valid (k,)).
    """
    H, W = img_l.shape
    score, corner = fast_score(img_l, float(params.fast_threshold))
    corner = corner & _nms3x3(score)

    # Border exclusion (edge_threshold) — keeps orientation/BRIEF patches
    # fully inside the image.
    b = params.edge_threshold
    ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    inside = (xs >= b) & (xs < W - b) & (ys >= b) & (ys < H - b)
    corner = corner & inside
    if mask_l is not None:
        corner = corner & (mask_l > 0)

    resp = harris_response(img_l)
    if not params.cv2_ranking:
        flat = jnp.where(corner, resp, -jnp.inf).reshape(-1)
        top_vals, top_idx = _topk_flat(flat, k_level)
    else:
        # Stage 1: best 2k by FAST score (cv2's pre-Harris retainBest).
        k2 = min(2 * k_level, H * W)
        flat_fast = jnp.where(corner, score, -jnp.inf).reshape(-1)
        fast_vals, fast_idx = _topk_flat(flat_fast, k2)
        # Stage 2: among those, best k by Harris response.
        resp_at = jnp.where(jnp.isfinite(fast_vals),
                            jnp.take(resp.reshape(-1), fast_idx), -jnp.inf)
        top_vals, sel = jax.lax.top_k(resp_at, k_level)
        top_idx = jnp.take(fast_idx, sel)
    valid = jnp.isfinite(top_vals)
    xy = jnp.stack([top_idx % W, top_idx // W], axis=1).astype(jnp.int32)
    return xy, top_vals, valid


def _patch_windows(img, xy, r):
    """Extract (2r+1, 2r+1) windows centered at each keypoint (K windows).
    Keypoints are guaranteed >= edge_threshold(31) > r from the borders."""
    size = 2 * r + 1

    def one(pt):
        return jax.lax.dynamic_slice(img, (pt[1] - r, pt[0] - r),
                                     (size, size))

    return jax.vmap(one)(xy)  # (K, size, size)


def _patch_windows_stack(stack, levels, xy, r):
    """(2r+1, 2r+1) windows from a pyramid stack (nl, H, W): each keypoint
    selects its level's slab. Invalid rows (xy 0) clamp inside level 0."""
    size = 2 * r + 1

    def one(lv, pt):
        return jax.lax.dynamic_slice(
            stack, (lv, pt[1] - r, pt[0] - r), (1, size, size))[0]

    return jax.vmap(one)(levels, xy)  # (K, size, size)


def _orientations_from_windows(wins, valid):
    """Intensity-centroid angle (radians) from (K, 31, 31) patch windows."""
    uw, vw, _ = centroid_weights()
    m10 = jnp.einsum("kij,ij->k", wins, jnp.asarray(uw))
    m01 = jnp.einsum("kij,ij->k", wins, jnp.asarray(vw))
    ang = jnp.arctan2(m01, m10)
    return jnp.where(valid, ang, 0.0)


def _orientations(img_l, xy, valid):
    """Intensity-centroid angle (radians) at each keypoint."""
    wins = _patch_windows(img_l, xy, HALF_PATCH)  # (K, 31, 31)
    return _orientations_from_windows(wins, valid)


# BRIEF sample radius after rotation: pattern points are in a +/-13 box, so
# a rotated sample reaches at most 13*sqrt(2) < 19 pixels from the center.
BRIEF_WIN = 19


def _descriptors(img_blur, xy, angles, valid, wins=None):
    """Steered BRIEF-256 bits at each keypoint -> packed (K, 32) uint8.

    Samples come from a per-keypoint 39x39 window (one contiguous
    dynamic-slice per keypoint; pass precomputed stacked windows via
    ``wins``), then a LOCAL batched gather — replacing the 512 scattered
    whole-image gathers per keypoint of the naive form (gathers over tiny
    per-row windows vectorize; global ones do not).
    """
    pat = jnp.asarray(brief_pattern())  # (256, 4)
    px, py, qx, qy = (pat[:, 0].astype(jnp.float32), pat[:, 1].astype(jnp.float32),
                      pat[:, 2].astype(jnp.float32), pat[:, 3].astype(jnp.float32))
    rw = BRIEF_WIN
    size = 2 * rw + 1
    if wins is None:
        wins = _patch_windows(img_blur, xy, rw)
    wins = wins.reshape(-1, size * size)

    ca = jnp.cos(angles)[:, None]
    sa = jnp.sin(angles)[:, None]

    def local_idx(x, y):
        # OpenCV's GET_VALUE rounding: col = round(x*cos - y*sin),
        # row = round(x*sin + y*cos), relative to the window center.
        col = rw + jnp.round(x[None, :] * ca - y[None, :] * sa).astype(jnp.int32)
        row = rw + jnp.round(x[None, :] * sa + y[None, :] * ca).astype(jnp.int32)
        return row * size + col  # (K, 256), always in range

    ip, iq = local_idx(px, py), local_idx(qx, qy)
    tp = jnp.take_along_axis(wins, ip, axis=1)
    tq = jnp.take_along_axis(wins, iq, axis=1)
    bits = (tp < tq).astype(jnp.uint8)
    bits = jnp.where(valid[:, None], bits, 0)
    return pack_bits(bits)


def detect_and_compute(img, mask, params: ORBParams):
    """Full ORB pipeline on a (H, W) grayscale image.

    BATCHED-PYRAMID execution: all levels live in one
    (nlevels, H, W) stack (level l occupies the top-left (h_l, w_l)
    corner) and every per-pixel stage — FAST, NMS, Harris, blur — runs
    ONCE, vmapped over the stack, instead of once per level. Per-level
    top-k is one batched call, instead of a per-level loop of small ops
    whose cost is mostly dispatch and fusion overhead. Level-edge effects
    from the zero canvas stay within ~5 px of each level's border — far
    inside the 31 px edge_threshold exclusion — so detections and
    descriptors are unchanged (orientation/BRIEF windows reach at most 19+3 px from a
    keypoint that is >= 31 px inside its level).

    Args:
      img: (H, W) uint8/float image.
      mask: optional (H, W) detection mask (nonzero = allowed), level-0 size.
      params: ORBParams.

    Returns a dict of fixed-capacity arrays (K = params.max_keypoints):
      xy:       (K, 2) float32 level-0 keypoint coords
      response: (K,)   float32 Harris response
      angle:    (K,)   float32 orientation (radians)
      octave:   (K,)   int32 pyramid level
      size:     (K,)   float32 patch diameter at level 0
      desc:     (K, 32) uint8 packed 256-bit descriptors
      valid:    (K,)   bool
    """
    H, W = img.shape
    imgf = img.astype(jnp.float32)
    nl = params.nlevels
    b = params.edge_threshold
    if b < BRIEF_WIN + 3:
        # The batched-pyramid (45, 45) raw windows assume keypoints are
        # >= 22 px inside their level; a smaller edge_threshold would read
        # zero-canvas pixels across level borders — fail
        # loudly rather than return silently-wrong descriptors.
        raise ValueError(
            f"edge_threshold={b} < {BRIEF_WIN + 3}: the batched raw-window"
            " pipeline needs keypoints >= 22 px inside their level")
    budgets = features_per_level(params.nfeatures, nl, params.scale_factor)

    dims = []
    for level in range(nl):
        scale = params.scale_factor**level
        h_l = max(int(round(H / scale)), 2 * b + 3)
        w_l = max(int(round(W / scale)), 2 * b + 3)
        dims.append((h_l, w_l))
    k_eff = [max(min(budgets[lv], dims[lv][0] * dims[lv][1]), 1)
             for lv in range(nl)]
    P = max(k_eff)

    # --- build the pyramid stack (and mask stack) ---
    stack = jnp.zeros((nl, H, W), jnp.float32)
    stack = jax.lax.dynamic_update_slice(stack, imgf[None], (0, 0, 0))
    mstack = None if mask is None else jnp.zeros((nl, H, W), jnp.bool_)
    if mask is not None:
        mstack = jax.lax.dynamic_update_slice(
            mstack, (mask > 0)[None], (0, 0, 0))
    for level in range(1, nl):
        h_l, w_l = dims[level]
        img_l = resize_bilinear(imgf, h_l, w_l)
        img_l = jnp.pad(img_l, ((0, H - h_l), (0, W - w_l)))
        stack = jax.lax.dynamic_update_slice(stack, img_l[None],
                                             (level, 0, 0))
        if mask is not None:
            # nearest-neighbor downsample of the level-0 mask
            yy = jnp.clip(jnp.round(jnp.arange(h_l) * (H / h_l))
                          .astype(jnp.int32), 0, H - 1)
            xx = jnp.clip(jnp.round(jnp.arange(w_l) * (W / w_l))
                          .astype(jnp.int32), 0, W - 1)
            m_l = (mask[yy][:, xx] > 0)
            m_l = jnp.pad(m_l, ((0, H - h_l), (0, W - w_l)))
            mstack = jax.lax.dynamic_update_slice(mstack, m_l[None],
                                                  (level, 0, 0))

    # --- batched per-pixel stages over the stack ---
    score, corner = jax.vmap(
        lambda im: fast_score(im, float(params.fast_threshold)))(stack)
    corner = corner & jax.vmap(_nms3x3)(score)
    hl_arr = jnp.asarray([h for h, _ in dims], jnp.int32)[:, None, None]
    wl_arr = jnp.asarray([w for _, w in dims], jnp.int32)[:, None, None]
    ys = jax.lax.broadcasted_iota(jnp.int32, (1, H, W), 1)
    xs = jax.lax.broadcasted_iota(jnp.int32, (1, H, W), 2)
    corner &= ((xs >= b) & (xs < wl_arr - b) & (ys >= b) & (ys < hl_arr - b))
    if mask is not None:
        corner &= mstack
    resp = jax.vmap(harris_response)(stack)

    # --- per-level top-k on each level's EXACT (h_l, w_l) canvas slice:
    # selection work stays sum-of-level-areas (1.67 MP at KITTI) instead
    # of nlevels x full canvas (3.74 MP) ---
    budget_arr = jnp.asarray(k_eff, jnp.int32)[:, None]
    rank = jnp.arange(P, dtype=jnp.int32)[None, :]
    xy_list, val_list = [], []
    for lv in range(nl):
        h_l, w_l = dims[lv]
        corner_l = corner[lv, :h_l, :w_l].reshape(-1)
        resp_l = resp[lv, :h_l, :w_l].reshape(-1)
        if not params.cv2_ranking:
            flat = jnp.where(corner_l, resp_l, -jnp.inf)
            # Select only THIS level's budget (rows past it are masked by
            # rank < budget anyway); top-k cost scales with k, and P is
            # level 0's budget — 2x+ the small levels' need.
            tv, ti = _topk_flat(flat, k_eff[lv])
            if k_eff[lv] < P:
                tv = jnp.pad(tv, (0, P - k_eff[lv]),
                             constant_values=-jnp.inf)
                ti = jnp.pad(ti, (0, P - k_eff[lv]))
        else:
            # Stage 1: best 2k by FAST score (cv2's pre-Harris
            # retainBest); stage 2: among those, best k by Harris.
            k2 = min(2 * k_eff[lv], h_l * w_l)
            score_l = score[lv, :h_l, :w_l].reshape(-1)
            fv, fi = _topk_flat(jnp.where(corner_l, score_l, -jnp.inf), k2)
            resp_at = jnp.where(jnp.isfinite(fv), jnp.take(resp_l, fi),
                                -jnp.inf)
            kk = min(P, k2)
            tv, sel = jax.lax.top_k(resp_at, kk)
            ti = jnp.take(fi, sel)
            if kk < P:
                tv = jnp.pad(tv, (0, P - kk), constant_values=-jnp.inf)
                ti = jnp.pad(ti, (0, P - kk))
        xy_list.append(jnp.stack([ti % w_l, ti // w_l], axis=-1))
        val_list.append(tv)
    top_vals = jnp.stack(val_list)                      # (nl, P)
    xy2 = jnp.stack(xy_list).astype(jnp.int32)          # (nl, P, 2)
    valid2 = jnp.isfinite(top_vals) & (rank < budget_arr)

    # --- compact to the fixed capacity FIRST: valid rows first, preserving
    # level-major rank order (identical valid-row order to the looped
    # form; padding rows move to the tail, which is masked everywhere).
    # Ordering before window extraction means the expensive per-keypoint
    # gathers below run on K=max_keypoints rows instead of nlevels*P
    # padded rows (864 -> 512 at defaults). ---
    K = params.max_keypoints
    n = nl * P
    lv_flat = jnp.repeat(jnp.arange(nl, dtype=jnp.int32), P)
    xy_flat = xy2.reshape(-1, 2)
    resp_flat = top_vals.reshape(-1)
    valid_flat = valid2.reshape(-1)
    if sum(k_eff) > K:
        # More valid keypoints than capacity is statically possible
        # (budget rounding + the per-level floor of 1 can push
        # sum(k_eff) past nfeatures): keep the K BEST by response across
        # levels, like the pre-batched truncation did — not the first K
        # in level-major order.
        order_key = jnp.where(valid_flat, -resp_flat, jnp.inf)
    else:
        order_key = jnp.where(valid_flat,
                              jnp.arange(n, dtype=jnp.float32), jnp.inf)
    perm = jnp.argsort(order_key)
    if n > K:
        perm = perm[:K]

    def compact(a, pad_val=0):
        a = a[perm]
        if n < K:
            padding = jnp.full((K - n,) + a.shape[1:], pad_val, a.dtype)
            a = jnp.concatenate([a, padding])
        return a

    xy_lvl = compact(xy_flat)
    octv = compact(lv_flat)
    resp = compact(resp_flat, -jnp.inf)
    valid = compact(valid_flat, False)

    # --- orientation + descriptors from ONE raw window per keypoint ---
    # A (45, 45) raw window covers both consumers: the 31x31 interior is
    # the IC_Angle patch, and blurring the window in-register (separable
    # 7-tap, valid region) yields the exact 39x39 blurred BRIEF window —
    # every blur tap reads raw pixels >= 3 px inside the window, so the
    # values equal the whole-image blur. This removes the whole-stack
    # gaussian AND the second per-keypoint window slice set.
    rw = BRIEF_WIN + 3  # 19 + blur radius
    wins_raw = _patch_windows_stack(stack, octv, xy_lvl, rw)  # (K, 45, 45)
    c0 = rw - HALF_PATCH
    wins_o = wins_raw[:, c0:c0 + 2 * HALF_PATCH + 1,
                      c0:c0 + 2 * HALF_PATCH + 1]
    ang = _orientations_from_windows(wins_o, valid)
    # Round like cv2's uint8 working image: ORB compares uint8-rounded
    # blur values, so rounding keeps descriptors bit-comparable.
    from openvo_jax.ops.image import gaussian_kernel_1d
    kb = jnp.asarray(gaussian_kernel_1d(7, 2.0))
    size_d = 2 * BRIEF_WIN + 1
    h_pass = sum(kb[i] * wins_raw[:, :, i:i + size_d] for i in range(7))
    wins_d = jnp.round(
        sum(kb[i] * h_pass[:, i:i + size_d, :] for i in range(7)))
    desc = _descriptors(None, xy_lvl, ang, valid, wins=wins_d)

    scale_tab = jnp.asarray(
        [params.scale_factor**lv for lv in range(nl)], jnp.float32)
    xy = xy_lvl.astype(jnp.float32) * scale_tab[octv][:, None]

    size = jnp.where(
        valid,
        31.0 * params.scale_factor ** octv.astype(jnp.float32),
        0.0,
    )
    return {
        "xy": xy,
        "response": resp,
        "angle": ang,
        "octave": octv,
        "size": size,
        "desc": desc,
        "valid": valid,
    }
