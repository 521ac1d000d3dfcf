"""Semi-Global Block Matching (SGBM) disparity estimation in JAX.

Replaces ``cv2.StereoSGBM_create(...).compute()`` (reference
stereo_camera.py:23-27,51; SURVEY.md N4). Stages, mirroring Hirschmuller's
SGM as implemented by OpenCV:

 1. Prefilter: horizontal Sobel clipped to ``[-cap, cap] + cap``
    (preFilterCap semantics).
 2. Matching cost: Birchfield-Tomasi sampling-insensitive absolute
    difference between the prefiltered images, evaluated for every disparity
    in ``[minD, minD + numDisparities)``.
 3. Block aggregation: blockSize x blockSize box sum (replicated borders).
 4. Path-wise cost aggregation over 4/5/8 directions with penalties P1/P2:
        L_r(p, d) = C(p, d) + min(L_r(p-r, d),
                                  L_r(p-r, d-1) + P1, L_r(p-r, d+1) + P1,
                                  min_k L_r(p-r, k) + P2) - min_k L_r(p-r, k)
 5. WTA disparity + uniqueness-ratio test + left-right consistency check
    (disp12MaxDiff) + parabolic subpixel refinement quantized to the x16
    int16 grid exactly like OpenCV (the reference then divides by 16,
    stereo_camera.py:51).
 6. Optional speckle filtering: connected components of similar disparity
    (4-connectivity, |d1-d2| <= 16*speckleRange on the x16 grid) smaller than
    speckleWindowSize are invalidated. Components are labeled with
    segmented min-scans (a data-parallel replacement for OpenCV's
    sequential flood fill).

Layout: the cost volume is (H, W, D) with the disparity axis last (D is a
multiple of 16, usually 128). The directional recurrence (step 4) is
:func:`path_sum`: on a CUDA device the Hopper kernel of ops/sgm_cuda.py,
one warp per scanline; elsewhere the plain ``lax.scan`` reference
:func:`path_sum_xla`. Both give the same bits.

Invalid disparity = (minDisparity - 1), encoded as (minD-1)*16 on the int16
grid — after the reference's /16 this is the value the feature mask's
MIN_VALID_DISPARITY=4 band excludes (stereo_odometer.py:6-7,38-41).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from openvo_jax.config import SGBMParams
from openvo_jax.ops import sgm_cuda

BIG = np.float32(sgm_cuda.BIG)  # a host scalar: importing touches no device


def int16_sentinel(block_size: int, cap: int) -> int | None:
    """Invalid-cost sentinel for the exact int16 x2-grid encoding, or None
    when no sentinel can both dominate every valid cost (> 4*cap on the x2
    grid) and keep block_size^2 box sums inside int16 (a fixed 600 would
    wrap negative for block_size >= 7)."""
    max_valid2 = 4 * cap
    s_max = 32767 // (block_size * block_size)
    if s_max > max_valid2:
        return min(s_max, 2 * max_valid2)
    return None


def prefilter_xsobel(img, cap: int):
    """Horizontal Sobel clipped to [-cap, cap] and shifted to [0, 2*cap]."""
    x = jnp.pad(img.astype(jnp.float32), 1, mode="edge")
    H, W = img.shape

    def sh(dy, dx):
        return x[1 + dy : 1 + dy + H, 1 + dx : 1 + dx + W]

    dx = (
        (sh(-1, 1) + 2 * sh(0, 1) + sh(1, 1))
        - (sh(-1, -1) + 2 * sh(0, -1) + sh(1, -1))
    )
    return jnp.clip(dx, -cap, cap) + cap


def bt_cost_volume(left_p, right_p, min_disp: int, num_disp: int,
                   block_size: int = 1, cap: int = 63):
    """Birchfield-Tomasi cost volume (H, W, D) between prefiltered images.

    Construction: the right image is broadcast over the disparity
    lane axis and sheared so that lane d holds right(x - d) (log2(D) roll
    passes — no gathers, no lane-1 slices). The BT half-sample envelopes of
    the sheared volume are then plain x-rolls at fixed d, since
    right(x - d +/- 1) = r_sh(x +/- 1, d).

    Out-of-range samples (x - d out of the right image) get a max-cost
    sentinel; the caller invalidates the left band anyway.

    dtype contract: returns an int16 volume on the exact x2 half-integer
    grid when ``block_size``/``cap`` admit an overflow-free int16 envelope
    (encoded sentinel s must satisfy s > 4*cap to dominate every valid cost
    AND block_size^2 * s <= 32767 so fully-invalid box sums cannot wrap);
    otherwise falls back to a float32 volume at true cost scale. Downstream
    (block_sum, the sweeps) accepts either dtype.
    """
    H, W = left_p.shape
    D = num_disp
    sentinel16 = int16_sentinel(block_size, cap)
    use_int16 = sentinel16 is not None

    def envelopes(a, axis=1):
        am = 0.5 * (a + jnp.roll(a, 1, axis=axis))   # value at x - 0.5
        ap = 0.5 * (a + jnp.roll(a, -1, axis=axis))  # value at x + 0.5
        lo = jnp.minimum(jnp.minimum(am, ap), a)
        hi = jnp.maximum(jnp.maximum(am, ap), a)
        return lo, hi

    # Prefiltered values are integers in [0, 2*cap] and the BT envelopes
    # are half-integers: bfloat16 (8 significand bits) represents the 0.5
    # grid exactly only up to 128, so the heavy broadcast/shear/envelope
    # stage runs in bf16 (half the HBM traffic) for the default cap=63
    # (values <= 126) and falls back to f32 for larger preFilterCap —
    # keeping the documented exact-grid contract at e.g. cap=301. The
    # final cost is promoted back to f32 either way.
    work_dtype = jnp.bfloat16 if 2 * cap <= 127 else jnp.float32
    l_lo, l_hi = envelopes(left_p.astype(work_dtype))

    # lane d of r_sh holds right(x - (min_disp + d)).
    rb = jnp.broadcast_to(right_p.astype(work_dtype)[..., None], (H, W, D))
    r_sh = _shear_x(rb, +1, jnp.nan)
    if min_disp != 0:
        r_sh = jnp.roll(r_sh, min_disp, axis=1)
        # jnp.roll wraps real pixel data from the opposite image edge into
        # the volume; those columns would pass the validity checks with
        # bogus content. Re-fill them with NaN (→ sentinel below). For
        # min_disp > 0 the wrapped columns are x < min_disp; for
        # min_disp < 0 they are x >= W + min_disp.
        xs = jax.lax.broadcasted_iota(jnp.int32, (1, W, 1), 1)
        nan = jnp.asarray(jnp.nan, work_dtype)
        if min_disp > 0:
            r_sh = jnp.where(xs < min_disp, nan, r_sh)
        else:
            r_sh = jnp.where(xs >= W + min_disp, nan, r_sh)
    r_lo, r_hi = envelopes(r_sh, axis=1)

    lp = left_p.astype(work_dtype)[..., None]
    c_l = jnp.maximum(0, jnp.maximum(lp - r_hi, r_lo - lp))
    c_r = jnp.maximum(
        0, jnp.maximum(r_sh - l_hi[..., None], l_lo[..., None] - r_sh)
    )
    cost = jnp.minimum(c_l, c_r)
    # Pixel costs are half-integers <= 2*cap: x2 is an exact int16 encoding
    # that halves HBM traffic; the aggregation decodes to f32 (x0.5) on
    # load. NaN marks sheared-out/wrapped samples: a max-cost sentinel
    # there. The sentinel is block-size-aware: block_size^2 * s <= 32767
    # (or the box sum wraps int16 NEGATIVE in fully-invalid windows and SGM
    # then *prefers* the invalid band) while s > 4*cap keeps the ordering
    # above every valid cost. Outside that envelope (block_size >= 13 at
    # cap=63, or huge preFilterCap) the volume stays float32.
    nan_mask = jnp.isnan(cost)
    if use_int16:
        cost2 = jnp.where(nan_mask, jnp.float32(sentinel16),
                          cost.astype(jnp.float32) * 2.0)
        return cost2.astype(jnp.int16)
    sentinel = jnp.float32(4.0 * cap)
    return jnp.where(nan_mask, sentinel, cost.astype(jnp.float32))


def block_sum(vol, block_size: int):
    """blockSize x blockSize spatial box sum of the (H, W, D) volume with
    replicated borders."""
    if block_size <= 1:
        return vol
    r = block_size // 2
    v = jnp.pad(vol, ((r, r), (0, 0), (0, 0)), mode="edge")
    H = vol.shape[0]
    v = sum(v[i : i + H] for i in range(block_size))
    v = jnp.pad(v, ((0, 0), (r, r), (0, 0)), mode="edge")
    W = vol.shape[1]
    return sum(v[:, i : i + W] for i in range(block_size))


def _shift_d(row, k):
    if k == 0:
        return row
    out = jnp.roll(row, k, axis=-1)
    if k > 0:
        return out.at[..., :k].set(BIG)
    return out.at[..., k:].set(BIG)


def _shift_x(row, k):
    if k == 0:
        return row
    out = jnp.roll(row, k, axis=0)
    if k > 0:
        return out.at[:k].set(BIG)
    return out.at[k:].set(BIG)


def _scan_rows(cost, xshifts, p1: float, p2: float, reverse: bool,
               init=None):
    """Aggregate along axis 0 of (N0, N1, D) ``cost`` for several directions
    at once (one lax.scan; directions differ only in their axis-1 shift:
    row r's predecessor is row r -/+ 1 at column x - shift). Returns the SUM
    of the directions' path costs and the final per-direction L carry —
    individual L volumes are never materialized.

    ``init`` optionally seeds the per-direction L carry (used by the
    multi-device row-tiled pipeline, parallel/tiling.py, to continue a
    sweep across tile boundaries exactly).
    """

    def step(prevs, c_row):
        new = []
        total = None
        for prev, k in zip(prevs, xshifts):
            pr = _shift_x(prev, k)
            minprev = jnp.min(pr, axis=-1, keepdims=True)
            cand = jnp.minimum(
                pr, jnp.minimum(_shift_d(pr, 1), _shift_d(pr, -1)) + p1
            )
            cand = jnp.minimum(cand, minprev + p2)
            L = c_row + cand - minprev
            new.append(L)
            total = L if total is None else total + L
        return tuple(new), total

    if cost.dtype == jnp.int16:
        cost = cost.astype(jnp.float32) * 0.5
    if init is None:
        init = tuple(
            jnp.full(cost.shape[1:], BIG, jnp.float32) for _ in xshifts
        )
    carry, S = jax.lax.scan(step, tuple(init), cost, reverse=reverse)
    return S, carry


def path_sum_xla(cost, dirs, p1: float, p2: float, init=None):
    """Plain reference of the path aggregation: (S, carry) for the
    directions ``dirs`` over an (H, W, D) int16 (x2 grid) or f32 volume.

    A direction ``(dy, dx)`` gives pixel (y, x) the predecessor
    (y - dy, x - dx). Horizontal directions scan the transposed volume;
    vertical and diagonal ones are batched per ``dy`` into one row scan.
    ``init`` (n_dirs, W, D) seeds the row before the first scan row of the
    non-horizontal directions (BIG if None); ``carry`` (n_dirs, W, D) is
    their last scan row (zeros for horizontal directions).
    """
    H, W, D = cost.shape
    carry = [jnp.zeros((W, D), jnp.float32) for _ in dirs]
    parts = []
    for dy, dx in dirs:
        if dy == 0:
            costT = jnp.swapaxes(cost, 0, 1)  # (W, H, D)
            s, _ = _scan_rows(costT, (0,), p1, p2, dx < 0)
            parts.append(jnp.swapaxes(s, 0, 1))
    for sign in (1, -1):
        idx = [i for i, (dy, _) in enumerate(dirs) if dy == sign]
        if not idx:
            continue
        group_init = None if init is None else tuple(init[i] for i in idx)
        s, c = _scan_rows(cost, tuple(dirs[i][1] for i in idx), p1, p2,
                          sign < 0, init=group_init)
        parts.append(s)
        for i, ci in zip(idx, c):
            carry[i] = ci
    return sum(parts[1:], parts[0]), jnp.stack(carry)


def path_sum(cost, dirs, p1: float, p2: float, init=None):
    """Path aggregation (S, carry) with the contract of
    :func:`path_sum_xla`. Lowered for a CUDA device it is the Hopper kernel
    (ops/sgm_cuda.py), bit-identical to the plain reference, which every
    other platform runs. The choice is made when the program is lowered for
    its platform, so one trace serves both."""
    dirs = tuple((int(dy), int(dx)) for dy, dx in dirs)
    if init is not None:
        init = jnp.stack([jnp.asarray(c, jnp.float32) for c in init])

    def kernel(c, i):
        return sgm_cuda.path_sum(c, dirs, p1, p2, i)

    def reference(c, i):
        return path_sum_xla(c, dirs, p1, p2, i)

    return jax.lax.platform_dependent(cost, init, cuda=kernel,
                                      default=reference)


def path_directions(num_paths: int):
    """(dy, dx) predecessor offsets of the SGM paths:
       4: left, right, up, down
       5: left, right, up, up-left, up-right  (OpenCV MODE_SGBM-like)
       8: all of the above + down, down-left, down-right
    """
    dirs = [(0, 1), (0, -1), (1, 0)]
    if num_paths == 4:
        return tuple(dirs + [(-1, 0)])
    dirs += [(1, 1), (1, -1)]
    if num_paths == 8:
        dirs += [(-1, 0), (-1, 1), (-1, -1)]
    return tuple(dirs)


def aggregate(cost, params: SGBMParams):
    """Sum of directional path costs S(p, d) over ``params.num_paths``
    directions (:func:`path_directions`)."""
    p1, p2 = float(params.effective_p1), float(params.effective_p2)
    return path_sum(cost, path_directions(params.num_paths), p1, p2)[0]


def aggregate_xla(cost, params: SGBMParams):
    """:func:`aggregate` on every platform through the plain lax.scan
    reference (the kernel's oracle)."""
    p1, p2 = float(params.effective_p1), float(params.effective_p2)
    return path_sum_xla(cost, path_directions(params.num_paths), p1, p2)[0]


def _wta(S, params: SGBMParams):
    """WTA + uniqueness + subpixel on the aggregated volume.

    Returns (disp16 int32 on the x16 grid, valid mask); disparities include
    minDisparity. Invalid pixels are NOT yet marked — the mask is returned.
    """
    D = params.num_disparities
    best = jnp.argmin(S, axis=-1)
    minS = jnp.min(S, axis=-1)

    valid = jnp.ones(best.shape, bool)
    if params.uniqueness_ratio > 0:
        d_idx = jnp.arange(D)[None, None, :]
        far = jnp.abs(d_idx - best[..., None]) > 1
        bad = jnp.any(
            far & (S * (100.0 - params.uniqueness_ratio) < minS[..., None] * 100.0),
            axis=-1,
        )
        valid &= ~bad

    # Parabolic subpixel: offset = (S[d-1] - S[d+1]) / (2*(S[d-1]+S[d+1]-2*S[d]))
    # Neighbor costs via masked reductions (one-hot compare on the
    # disparity axis) instead of take_along_axis.
    d_idx = jax.lax.broadcasted_iota(jnp.int32, S.shape, 2)
    bm1 = jnp.clip(best - 1, 0, D - 1)[..., None]
    bp1 = jnp.clip(best + 1, 0, D - 1)[..., None]
    s_m = jnp.sum(jnp.where(d_idx == bm1, S, 0.0), axis=-1)
    s_p = jnp.sum(jnp.where(d_idx == bp1, S, 0.0), axis=-1)
    denom = s_m + s_p - 2.0 * minS
    interior = (best > 0) & (best < D - 1) & (denom > 0)
    frac = jnp.where(interior, (s_m - s_p) / jnp.maximum(2.0 * denom, 1e-9), 0.0)
    frac = jnp.clip(frac, -0.5, 0.5)

    d_float = best.astype(jnp.float32) + frac + params.min_disparity
    disp16 = jnp.round(d_float * 16.0).astype(jnp.int32)
    return disp16, valid, best


def _shear_x(vol, sign: int, fill):
    """Per-lane shear of an (H, W, D) volume along the W axis:
    for sign=-1, out[y, x, d] = vol[y, x + d, d]; for sign=+1,
    out[y, x, d] = vol[y, x - d, d]. Out-of-range positions become ``fill``.

    Implemented as log2(D) roll+select passes (lane-indexed binary shifts):
    no gathers, no per-lane slices.
    """
    H, W, D = vol.shape
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, 1, D), 2)
    xs = jax.lax.broadcasted_iota(jnp.int32, (1, W, 1), 1)
    out = vol
    k = 1
    while k < D:
        rolled = jnp.roll(out, sign * k, axis=1)
        if sign < 0:
            # content moves left; the last k columns are invalid
            rolled = jnp.where(xs >= W - k, fill, rolled)
        else:
            rolled = jnp.where(xs < k, fill, rolled)
        out = jnp.where((lane & k) != 0, rolled, out)
        k *= 2
    return out


def _lr_check(S, best_left, params: SGBMParams):
    """Left-right consistency: recompute the right image's WTA disparity from
    the same aggregated volume (costR(y, xr, d) = S(y, xr + d, d)) and check
    |dL(x) - dR(x - dL(x))| <= disp12MaxDiff.

    costR is assembled by a log2(D)-pass shear of the volume; the final dR
    lookup along x is similarly a shift-and-select reduction over the
    disparity axis (no gathers).
    """
    H, W, D = S.shape
    # costR[:, xr, d] = S[:, xr + d, d]: a shear along (x, d), applied in
    # log2(D) full-volume passes — pass k shifts by 2^k only the lanes whose
    # disparity index has bit k set. Pure rolls + selects.
    costR = _shear_x(S, -1, BIG)
    bestR = jnp.argmin(costR, axis=-1).astype(jnp.int32)

    # dR_at_left[:, x] = bestR[:, x - best_left(x)]: build the reverse shear
    # shifted[..., d] = bestR[x - d] the same way, then select lane
    # best_left with a one-hot reduction.
    bestR_b = jnp.broadcast_to(bestR[..., None], (H, W, D)).astype(jnp.int32)
    shifted = _shear_x(bestR_b, +1, -(1 << 20))
    onehot = (
        jax.lax.broadcasted_iota(jnp.int32, (H, W, D), 2)
        == best_left[..., None]
    )
    dR = jnp.sum(jnp.where(onehot, shifted, 0), axis=-1)
    ok = jnp.abs(best_left - dR) <= params.disp12_max_diff
    x = jnp.arange(W)[None, :]
    ok |= (x - best_left) < 0  # no right pixel to check against
    return ok


_LBIG = 1.0e9  # label infinity (labels are exact f32 ints < 2^24)


def _shift_fill(a, k, axis, fill):
    """jnp.roll with the wrapped region overwritten by ``fill``. ``k`` is a
    STATIC shift, so the unrolled log2(n)-step doubling graph is made of
    static slices; a while_loop variant with traced shifts compiles far
    more slowly inside the scanned odometer step."""
    axis = axis % a.ndim
    out = jnp.roll(a, k, axis=axis)
    idx = jax.lax.broadcasted_iota(jnp.int32, a.shape, axis)
    bad = idx < k if k > 0 else idx >= a.shape[axis] + k
    return jnp.where(bad, fill, out)


def _run_min(lab, conn_pred, axis):
    """Min label over each connected RUN along ``axis`` (both directions),
    via Hillis-Steele segmented-scan doubling: step k merges m[x] with
    m[x-k] when the whole span is connected; the span mask doubles with
    c_2k[x] = c_k[x] & c_k[x-k]. Pure roll/min/where — no
    gathers. ``conn_pred[.., x]`` = pixel connected to its predecessor."""
    n = lab.shape[axis]

    def sweep(m, c, sign):
        k = 1
        while k < n:
            m = jnp.where(
                c, jnp.minimum(m, _shift_fill(m, sign * k, axis, _LBIG)), m)
            c = c & _shift_fill(c, sign * k, axis, False)
            k *= 2
        return m

    m = sweep(lab, conn_pred, 1)
    return sweep(m, _shift_fill(conn_pred, -1, axis, False), -1)


def _segment_sizes_sorted(lab_flat):
    """Size of each label's group, returned per element, GATHER/SCATTER-
    free: sort (label, position) pairs, measure run lengths of equal
    labels with segmented Hillis-Steele scans on the sorted 1-D array,
    and un-sort by a second key-val sort on the original position."""
    n = lab_flat.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    sk, sval = jax.lax.sort_key_val(lab_flat, pos)
    seg_start = jnp.concatenate(
        [jnp.ones((1,), bool), sk[1:] != sk[:-1]])
    # forward inclusive segmented sum of ones = rank-in-segment + 1
    tot = jnp.ones((n,), jnp.int32)
    conn_f = ~seg_start
    k = 1
    while k < n:
        tot = jnp.where(conn_f, tot + _shift_fill(tot, k, 0, 0), tot)
        conn_f = conn_f & _shift_fill(conn_f, k, 0, False)
        k *= 2
    # segment total sits at the segment end; broadcast it back with a
    # reverse segmented max-scan
    seg_end = jnp.concatenate([sk[1:] != sk[:-1], jnp.ones((1,), bool)])
    total = jnp.where(seg_end, tot, 0)
    conn_b = ~_shift_fill(seg_start, -1, 0, True)
    k = 1
    while k < n:
        total = jnp.maximum(
            total, jnp.where(conn_b, _shift_fill(total, -k, 0, 0), 0))
        conn_b = conn_b & _shift_fill(conn_b, -k, 0, False)
        k *= 2
    _, out = jax.lax.sort_key_val(sval, total)
    return out


def _speckle_filter_batched(disp16, valid, params: SGBMParams):
    """Batched core of :func:`_speckle_filter` over (B, H, W) stacks.

    Labeling is SCAN-ONLY (alternating row/column segmented min-scan
    rounds until no label changes; checked against the CPU cv2 oracle)
    and component sizes come from the sort-based
    :func:`_segment_sizes_sorted` on GLOBALLY-OFFSET flat labels (frame
    b's labels live in [b*n, (b+1)*n), so one flat sort serves the whole
    batch). Labels stay frame-local (< 2^24, exact f32) in the scan
    stages.

    Size-count nuance: invalid pixels are label-singletons (connectivity
    requires both endpoints valid), so group size == sorted-run length
    with no validity weighting; invalid pixels get size 1 where the old
    scatter gave 0 — both are <= the window threshold and the result is
    ANDed with ``valid``, so the filter output is unchanged."""
    B, H, W = disp16.shape
    max_diff = 16 * params.speckle_range
    n = H * W

    d = disp16
    # Connectivity to the predecessor along each axis; invalid pixels are
    # singletons (no edges at all).
    conn_x = (jnp.abs(d - _shift_fill(d, 1, -1, 1 << 20)) <= max_diff)
    conn_y = (jnp.abs(d - _shift_fill(d, 1, -2, 1 << 20)) <= max_diff)
    conn_x &= valid & _shift_fill(valid, 1, -1, False)
    conn_y &= valid & _shift_fill(valid, 1, -2, False)

    idx = (jax.lax.broadcasted_iota(jnp.int32, (H, W), 0) * W
           + jax.lax.broadcasted_iota(jnp.int32, (H, W), 1))
    labels = jnp.broadcast_to(idx.astype(jnp.float32), (B, H, W))

    def one_round(lab):
        lab = _run_min(lab, conn_x, axis=-1)
        return _run_min(lab, conn_y, axis=-2)

    # A few unrolled rounds converge on typical SGBM output;
    # high-tortuosity components (spirals/serpentines) can need O(#bends)
    # rounds, so a convergence-checked while_loop finishes the tail
    # instead of a fixed count (a fixed count under-merges adversarial
    # shapes, undercounting their sizes). Labels only ever decrease, so
    # convergence is guaranteed; the loop bound is a never-reached safety
    # cap.
    for _ in range(4):
        labels = one_round(labels)

    def _cond(state):
        i, _, changed = state
        return changed & (i < H * W)

    def _body(state):
        i, lab, _ = state
        new = one_round(lab)
        return i + 1, new, jnp.any(new != lab)

    _, labels, _ = jax.lax.while_loop(
        _cond, _body, (jnp.int32(0), labels, jnp.bool_(True)))

    offs = (jnp.arange(B, dtype=jnp.int32) * n)[:, None]
    lab = (labels.astype(jnp.int32).reshape(B, n) + offs).reshape(-1)
    comp_size = _segment_sizes_sorted(lab).reshape(B, H, W)
    keep = comp_size > params.speckle_window_size
    return valid & keep


def _speckle_filter(disp16, valid, params: SGBMParams):
    """Connected-component speckle rejection (cv2.filterSpeckles semantics:
    4-connected components of |d1-d2| <= 16*speckleRange with <=
    speckleWindowSize pixels are invalidated).

    Labeling: alternating row/column segmented min-scans (gather-free
    label propagation; one alternation fully resolves every straight run,
    so staircase-shaped components converge in a handful of rounds) and
    sort-based component sizing — no gathers or scatters at all.

    vmap (the batched-extract stream shape, the camera rig) routes through
    a custom_vmap rule to the flat-global-index batched core — see
    :func:`_speckle_filter_batched` for why."""

    @jax.custom_batching.custom_vmap
    def run(d, v):
        return _speckle_filter_batched(d[None], v[None], params)[0]

    @run.def_vmap
    def _rule(axis_size, in_batched, d, v):  # noqa: ANN001
        if not in_batched[0]:
            d = jnp.broadcast_to(d, (axis_size,) + d.shape)
        if not in_batched[1]:
            v = jnp.broadcast_to(v, (axis_size,) + v.shape)
        return _speckle_filter_batched(d, v, params), True

    return run(disp16, valid)


@functools.partial(jax.jit, static_argnums=2)
def sgbm_disparity16(left, right, params: SGBMParams):
    """Full SGBM pipeline -> int16-grid disparity (x16) with invalid =
    (minDisparity - 1) * 16, exactly the contract of cv2.StereoSGBM.compute.

    jitted with static ``params`` (a frozen dataclass): eager callers get
    ONE device dispatch per frame instead of per-op round-trips; inside an
    outer jit the call inlines as usual."""
    cap = max(params.pre_filter_cap, 15) | 1
    with jax.named_scope("sgbm_prefilter"):
        lp = prefilter_xsobel(left, cap)
        rp = prefilter_xsobel(right, cap)

    with jax.named_scope("sgbm_cost_volume"):
        C = bt_cost_volume(lp, rp, params.min_disparity,
                           params.num_disparities,
                           block_size=params.block_size, cap=cap)
        C = block_sum(C, params.block_size)

    with jax.named_scope("sgbm_aggregate"):
        S = aggregate(C, params)
    with jax.named_scope("sgbm_wta"):
        disp16, valid, best = _wta(S, params)
        if params.disp12_max_diff >= 0:
            valid &= _lr_check(S, best, params)
        # Left band: the full search range has no right-image support.
        x = jnp.arange(left.shape[1])[None, :]
        valid &= (x - (best + params.min_disparity)) >= 0
    return _finalize(disp16, valid, params)


def _finalize(disp16, valid, params: SGBMParams):
    """Speckle filter + invalid-value encoding (shared tail)."""
    if params.speckle_window_size > 0 and params.speckle_range > 0:
        valid = _speckle_filter(disp16, valid, params)
    invalid_val = (params.min_disparity - 1) * 16
    return jnp.where(valid, disp16, invalid_val).astype(jnp.int16)


@functools.partial(jax.jit, static_argnums=2)
def sgbm_disparity(left, right, params: SGBMParams):
    """Float disparity in pixels: int16 grid / 16 (reference
    stereo_camera.py:51)."""
    return sgbm_disparity16(left, right, params).astype(jnp.float32) / 16.0
