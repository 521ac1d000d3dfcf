"""Batch-extraction streaming VO: batched extraction + scanned state machine.

The per-frame odometer step (reference stereo_odometer.py:115-160) is mostly
state-independent work — rectify, SGBM, reproject, ORB (``extract``) — and a
small sequential tail (match vs the last accepted frame, Kabsch, gates, pose
chain). This module runs the state-free part BATCHED over frames
(``jax.vmap``; the SGM path kernel walks every batch entry in one launch)
and scans only the sequential state machine over the extracted features.

The trajectory is IDENTICAL to sequential stepping by construction: the
state machine consumes exactly the same FrameFeatures in the same order
(tests/test_parallel.py asserts this).

The value of this shape is (a) the building block for multi-device frame
sharding (parallel/sharding.py), where each shard extracts its frame
block batched, (b) bounded-memory chunked processing of long sequences,
and (c) more parallel work per launch than one frame gives. bench.py
reports it as ``stream_fps`` next to the latency shape.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from openvo_jax.config import OdometerConfig
from openvo_jax.models.stereo_odometer import make_pipeline_fns


def make_stream_fn(camera, cfg: OdometerConfig, color: bool = False,
                   chunk: int | None = None):
    """Build ``stream(state, lefts, rights) -> (state', (ok, c_T_w))``.

    ``lefts``/``rights`` are (B, H, W[, 3]) frame stacks. Features for all
    B frames are extracted batched, then the odometer state machine (with
    the reference's full skip/fallback semantics) scans over them. With
    ``chunk`` set, frames are processed in chunks of that size (bounds the
    batched activation memory for long sequences; B must be divisible).
    """
    fns = make_pipeline_fns(camera, cfg, color)
    extract, step_feats = fns["extract"], fns["step_feats"]
    extract_b = jax.vmap(extract)

    def scan_feats(state, feats):
        def body(s, f):
            s2, ok, _ = step_feats(s, f)
            return s2, (ok, s2.c_T_w)

        return jax.lax.scan(body, state, feats)

    def stream(state, lefts, rights):
        b = lefts.shape[0]
        if chunk is None or chunk >= b:
            return scan_feats(state, extract_b(lefts, rights))
        if b % chunk:
            raise ValueError(f"frame count {b} not divisible by {chunk=}")

        def chunk_body(s, lr):
            return scan_feats(s, extract_b(lr[0], lr[1]))

        sh = (b // chunk, chunk)
        state, outs = jax.lax.scan(
            chunk_body, state,
            (lefts.reshape(sh + lefts.shape[1:]),
             rights.reshape(sh + rights.shape[1:])),
        )
        return state, jax.tree_util.tree_map(
            lambda x: x.reshape((b,) + x.shape[2:]), outs)

    return stream
