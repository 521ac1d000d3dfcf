"""Multi-chip streaming VO: frames sharded across a device mesh.

BASELINE config 5 ("long-sequence VO: full fused pipeline sharded across
chips"). Design per SURVEY.md section 2c:

 - the frame stream (B, H, W) is sharded along the batch/frame axis of a 1-D
   ``jax.sharding.Mesh``;
 - each device extracts features and fits the relative pose of every
   *consecutive local pair* of its shard;
 - the single cross-shard dependency — the last frame of the previous shard —
   travels between devices via ``jax.lax.ppermute`` inside ``shard_map``
   (XLA hands the collective to NCCL on GPUs);
 - per-frame relative poses are then ``all_gather``-ed and composed into a
   trajectory with ``jax.lax.associative_scan`` over 4x4 matmuls, making even
   the sequential pose chain log-depth parallel.

This is the throughput-oriented batch API: pure frame-to-frame tracking
(failed fits contribute identity), while the sequential ``StereoOdometer``
keeps the reference's full skip/fallback semantics.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from openvo_jax.config import OdometerConfig
from openvo_jax.models.stereo_odometer import make_pipeline_fns

FRAME_AXIS = "frames"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (FRAME_AXIS,))


def compose_trajectory(T_rel):
    """Cumulative pose chain P_i = T_i @ T_{i-1} @ ... @ T_0 via
    associative_scan (log-depth instead of the reference's sequential
    left-multiplication, stereo_odometer.py:138)."""
    return jax.lax.associative_scan(
        lambda a, b: jnp.matmul(b, a, precision=jax.lax.Precision.HIGHEST),
        T_rel)


def make_relative_pose_fn(camera, cfg: OdometerConfig, color: bool = False):
    """(framesL (B,H,W), framesR) -> (T_rel (B,4,4), ok (B,)) single-device.

    T_rel[0] = I; T_rel[i] maps frame i-1 coords to frame i coords.
    """
    fns = make_pipeline_fns(camera, cfg, color)
    extract, attempt = fns["extract"], fns["attempt"]

    def fn(frames_l, frames_r):
        feats = jax.vmap(extract)(frames_l, frames_r)
        prev = jax.tree_util.tree_map(lambda x: x[:-1], feats)
        nxt = jax.tree_util.tree_map(lambda x: x[1:], feats)
        zeros = jnp.zeros((frames_l.shape[0] - 1,), jnp.int32)
        T, ok, _, _ = jax.vmap(attempt)(prev, nxt, zeros, zeros)
        eye = jnp.eye(4, dtype=T.dtype)
        T = jnp.where(ok[:, None, None], T, eye)
        T = jnp.concatenate([eye[None], T], axis=0)
        ok = jnp.concatenate([jnp.ones((1,), bool), ok], axis=0)
        return T, ok

    return fn


def make_sharded_trajectory_fn(camera, cfg: OdometerConfig, mesh: Mesh,
                               color: bool = False):
    """Build the jitted multi-chip trajectory function.

    Input: (framesL (B,H,W), framesR (B,H,W)) sharded on axis 0 over the
    mesh; B must be a multiple of mesh size. Output: (B, 4, 4) camera poses
    (c_T_w chain, replicated) and the per-frame ok flags.
    """
    fns = make_pipeline_fns(camera, cfg, color)
    extract, attempt = fns["extract"], fns["attempt"]
    n_dev = mesh.shape[FRAME_AXIS]

    def local_fn(frames_l, frames_r):
        # frames_*: the local shard (b, H, W)
        feats = jax.vmap(extract)(frames_l, frames_r)
        # Halo exchange: send my LAST frame's features to the next
        # device so it can link its first frame to the stream.
        perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
        last = jax.tree_util.tree_map(lambda x: x[-1], feats)
        recv = jax.lax.ppermute(last, FRAME_AXIS, perm)
        prev = jax.tree_util.tree_map(
            lambda r, loc: jnp.concatenate([r[None], loc[:-1]], axis=0),
            recv, feats,
        )
        b = frames_l.shape[0]
        zeros = jnp.zeros((b,), jnp.int32)
        T, ok, _, _ = jax.vmap(attempt)(prev, feats, zeros, zeros)
        eye = jnp.eye(4, dtype=T.dtype)
        # Global frame 0 has no predecessor: identity.
        is_first = (jax.lax.axis_index(FRAME_AXIS) == 0)
        first_mask = (jnp.arange(b) == 0) & is_first
        ok = jnp.where(first_mask, True, ok)
        T = jnp.where((first_mask | ~ok)[:, None, None], eye, T)
        # Gather the full relative-pose chain and compose (log-depth scan).
        T_all = jax.lax.all_gather(T, FRAME_AXIS, axis=0, tiled=True)
        ok_all = jax.lax.all_gather(ok, FRAME_AXIS, axis=0, tiled=True)
        traj = compose_trajectory(T_all)
        return traj, ok_all

    sharded = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(FRAME_AXIS), P(FRAME_AXIS)),
        out_specs=(P(), P()),
        check_vma=False,
    )

    def fn(frames_l, frames_r):
        sh = NamedSharding(mesh, P(FRAME_AXIS))
        frames_l = jax.lax.with_sharding_constraint(frames_l, sh)
        frames_r = jax.lax.with_sharding_constraint(frames_r, sh)
        return sharded(frames_l, frames_r)

    return jax.jit(fn)
