"""Spatial tile sharding for SGBM: image rows sharded across a device mesh
with halo exchange (SURVEY.md section 2c "spatial sharding" — the domain's
context-parallelism analog, for 2K-class imagery that exceeds one chip's
comfortable working set).

Decomposition (exact, not an approximation):

 - Each device holds an H/n-row band of the stereo pair. The cost volume
   needs a (block radius + 1)-row halo (1 row for the x-Sobel prefilter +
   radius for the box sum): the neighboring devices' boundary rows travel
   via ``jax.lax.ppermute``; global top/bottom edges replicate
   their own border row, reproducing the single-device edge-pad semantics.
 - Horizontal path sweeps and the WTA/uniqueness/subpixel/left-right
   post-processing are row-local: fully parallel across devices.
 - Vertical path sweeps are a scan across rows, so tiles depend on their
   upper (top-down) / lower (bottom-up) neighbor. They run as a
   *device wavefront*: n masked steps in which the per-direction L carry
   (the sweep's boundary row) hops to the next device via ppermute. Total
   sequential work equals ONE whole-image sweep — the vertical recurrence
   is inherently serial — while cost volume, horizontal sweeps and WTA
   scale with the mesh.
 - Speckle filtering is a GLOBAL connected-component pass over the tiny
   (H, W) disparity map (not the (H, W, D) volume), so the tiled path
   ``all_gather``s the per-band disparities and runs the labeling
   replicated — byte-for-byte the single-device filter — then slices its
   own band of the verdicts.

The per-tile math runs the single-device building blocks of ops/sgbm.py,
path aggregation included (``path_sum``: the CUDA kernel on a GPU, the
lax.scan reference elsewhere), with the per-direction carry seeded and
returned across tiles. The result is the single-device disparity,
bit-identically (tests/test_tiling.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from openvo_jax.config import SGBMParams
from openvo_jax.ops import sgbm as S

ROW_AXIS = "rows"


def make_row_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (ROW_AXIS,))


def _exchange_halo(band, n_dev, halo):
    """Extend a local (H_t, W) band with ``halo`` rows from each vertical
    neighbor (ppermute); global edges replicate the border row,
    matching the single-device edge-pad."""
    idx = jax.lax.axis_index(ROW_AXIS)
    down = [(i, i + 1) for i in range(n_dev - 1)]   # my bottom rows -> next
    up = [(i + 1, i) for i in range(n_dev - 1)]     # my top rows -> prev
    from_above = jax.lax.ppermute(band[-halo:], ROW_AXIS, down)
    from_below = jax.lax.ppermute(band[:halo], ROW_AXIS, up)
    top_edge = jnp.broadcast_to(band[0:1], (halo,) + band.shape[1:])
    bot_edge = jnp.broadcast_to(band[-1:], (halo,) + band.shape[1:])
    above = jnp.where(idx == 0, top_edge, from_above)
    below = jnp.where(idx == n_dev - 1, bot_edge, from_below)
    return jnp.concatenate([above, band, below], axis=0)


def _vertical_wavefront(C, xshifts, p1, p2, reverse, n_dev):
    """Top-down (or bottom-up) directional sweep across row tiles: n
    masked steps; the (ndirs, W, D) L carry hops device-to-device via
    ppermute."""
    idx = jax.lax.axis_index(ROW_AXIS)
    dirs = [(-1 if reverse else 1, k) for k in xshifts]
    if reverse:
        perm = [(i + 1, i) for i in range(n_dev - 1)]
        order = lambda k: n_dev - 1 - k  # noqa: E731
    else:
        perm = [(i, i + 1) for i in range(n_dev - 1)]
        order = lambda k: k  # noqa: E731

    Sv = jnp.zeros(C.shape, jnp.float32)
    carry = None
    for k in range(n_dev):
        mine = idx == order(k)
        # The first tile in sweep order starts fresh; later tiles use the
        # received carry (only valid on the device whose turn it is).
        S_k, carry_out = S.path_sum(C, dirs, p1, p2, init=carry)
        Sv = jnp.where(mine, S_k, Sv)
        if k < n_dev - 1:
            carry = jax.lax.ppermute(carry_out, ROW_AXIS, perm)
    return Sv


def _tiled_core(left_t, right_t, params, n_dev, cap):
    """Per-band (disp16, valid) from the single-device building blocks."""
    h_t = left_t.shape[0]
    radius = params.block_size // 2
    halo = radius + 1  # prefilter stencil (1) + block-sum radius
    p1, p2 = float(params.effective_p1), float(params.effective_p2)
    idx = jax.lax.axis_index(ROW_AXIS)
    lx = _exchange_halo(left_t.astype(jnp.float32), n_dev, halo)
    rx = _exchange_halo(right_t.astype(jnp.float32), n_dev, halo)
    lp = S.prefilter_xsobel(lx, cap)
    rp = S.prefilter_xsobel(rx, cap)
    Cc = S.bt_cost_volume(lp, rp, params.min_disparity,
                          params.num_disparities,
                          block_size=params.block_size, cap=cap)
    Cc = Cc.astype(jnp.float32)  # exact; simplifies the edge fix-up
    # The single-device block_sum edge-replicates COST rows at global
    # borders; replicated RAW rows would feed the Sobel a different
    # vertical context, so fix the halo in cost space for the edge
    # devices (interior tiles keep their real neighbor rows).
    top_fix = jnp.broadcast_to(Cc[halo:halo + 1],
                               (radius,) + Cc.shape[1:])
    bot_fix = jnp.broadcast_to(Cc[h_t + halo - 1:h_t + halo],
                               (radius,) + Cc.shape[1:])
    top = jnp.where(idx == 0, top_fix, Cc[halo - radius:halo])
    bot = jnp.where(idx == n_dev - 1, bot_fix,
                    Cc[h_t + halo:h_t + halo + radius])
    core = jnp.concatenate([top, Cc[halo:h_t + halo], bot], axis=0)
    # Vertical box over the (h_t + 2*radius) core rows, then the same
    # horizontal edge-padded box as the single-device block_sum.
    v = core[:h_t]
    for j0 in range(1, 2 * radius + 1):
        v = v + core[j0:j0 + h_t]
    v = jnp.pad(v, ((0, 0), (radius, radius), (0, 0)), mode="edge")
    w_img = left_t.shape[1]
    C = v[:, :w_img]
    for j0 in range(1, 2 * radius + 1):
        C = C + v[:, j0:j0 + w_img]
    if S.int16_sentinel(params.block_size, cap) is not None:
        C = C * 0.5  # decode the x2 int16 grid (the path aggregation does
        # this on load for int16 volumes; ours is already f32)

    # Horizontal pair: row-local, fully parallel across tiles.
    Sh = S.path_sum(C, ((0, 1), (0, -1)), p1, p2)[0]

    # Vertical sweeps: device wavefront with carry handoff.
    if params.num_paths == 4:
        Stot = (Sh
                + _vertical_wavefront(C, (0,), p1, p2, False, n_dev)
                + _vertical_wavefront(C, (0,), p1, p2, True, n_dev))
    elif params.num_paths == 5:
        Stot = Sh + _vertical_wavefront(C, (0, 1, -1), p1, p2, False,
                                        n_dev)
    else:
        Stot = (Sh
                + _vertical_wavefront(C, (0, 1, -1), p1, p2, False,
                                      n_dev)
                + _vertical_wavefront(C, (0, 1, -1), p1, p2, True,
                                      n_dev))

    # WTA + uniqueness + subpixel + LR + left band: row-local.
    disp16, valid, best = S._wta(Stot, params)
    if params.disp12_max_diff >= 0:
        valid &= S._lr_check(Stot, best, params)
    x = jnp.arange(C.shape[1])[None, :]
    valid &= (x - (best + params.min_disparity)) >= 0
    return disp16, valid


def make_tiled_sgbm_fn(params: SGBMParams, mesh: Mesh):
    """Build a jitted (left (H, W) u8, right (H, W) u8) -> disparity16
    function whose rows are sharded over ``mesh``. H must be a multiple of
    the mesh size. Speckle filtering runs as a replicated global pass over
    the all_gathered (H, W) disparity (see module docstring)."""
    n_dev = mesh.shape[ROW_AXIS]
    cap = max(params.pre_filter_cap, 15) | 1

    def local_fn(left_t, right_t):
        h_t = left_t.shape[0]
        disp16, valid = _tiled_core(left_t, right_t, params, n_dev, cap)
        if params.speckle_window_size > 0 and params.speckle_range > 0:
            # Global connected components over the (H, W) disparity map:
            # gather all bands, run the labeling replicated (identical on
            # every device), slice our band.
            idx = jax.lax.axis_index(ROW_AXIS)
            d_all = jax.lax.all_gather(disp16, ROW_AXIS, axis=0,
                                       tiled=True)
            v_all = jax.lax.all_gather(valid, ROW_AXIS, axis=0,
                                       tiled=True)
            keep = S._speckle_filter(d_all, v_all, params)
            valid = jax.lax.dynamic_slice_in_dim(keep, idx * h_t, h_t, 0)
        invalid_val = (params.min_disparity - 1) * 16
        return jnp.where(valid, disp16, invalid_val).astype(jnp.int16)

    sharded = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(ROW_AXIS), P(ROW_AXIS)),
        out_specs=P(ROW_AXIS),
        check_vma=False,
    )

    jitted = None

    def _constrained(left, right):
        sh = NamedSharding(mesh, P(ROW_AXIS))
        left = jax.lax.with_sharding_constraint(left, sh)
        right = jax.lax.with_sharding_constraint(right, sh)
        return sharded(left, right)

    def fn(left, right):
        nonlocal jitted
        if left.shape[0] % n_dev != 0:
            raise ValueError(
                f"row-tiled SGBM needs H divisible by the mesh size: "
                f"H={left.shape[0]}, mesh={n_dev} devices")
        if jitted is None:
            jitted = jax.jit(_constrained)
        return jitted(left, right)

    return fn
