"""Parallel layer: vmapped multi-camera rig (BASELINE config 4), pose
composition scan, and the multi-chip sharded pipeline (BASELINE config 5,
validated on an 8-virtual-device CPU mesh in a subprocess — the SURVEY.md
section 4 'fake backend' strategy)."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from openvo_jax import OdometerConfig, ORBParams, StereoCamera
from openvo_jax.config import SGBMParams
from openvo_jax.io.synthetic import render_stereo_sequence
from openvo_jax.parallel.rig import RigOdometer
from openvo_jax.parallel.sharding import compose_trajectory, make_relative_pose_fn

IMG_SIZE = (256, 192)
SGBM = SGBMParams(num_disparities=64, block_size=5, p1=200, p2=800,
                  disp12_max_diff=1, pre_filter_cap=63, uniqueness_ratio=10)


def small_setup(n_frames=4):
    seq = render_stereo_sequence(n_frames=n_frames, img_size=IMG_SIZE,
                                 f=280.0, baseline=0.5, seed=0, step=0.3,
                                 yaw_rate=0.004)
    cam = StereoCamera(seq["K"], seq["dist"], seq["K"], seq["dist"],
                       {"R": seq["R"], "T": seq["T"]}, SGBM, IMG_SIZE)
    cfg = OdometerConfig(nfeatures=256,
                         orb=ORBParams(nfeatures=256, max_keypoints=256))
    return seq, cam, cfg


def test_compose_trajectory_matches_sequential():
    rng = np.random.default_rng(0)
    import cv2
    Ts = []
    for _ in range(7):
        R, _ = cv2.Rodrigues(rng.normal(scale=0.05, size=3))
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = rng.normal(scale=0.1, size=3)
        Ts.append(T)
    Ts = np.stack(Ts).astype(np.float32)
    out = np.asarray(compose_trajectory(jnp.asarray(Ts)))
    acc = np.eye(4, dtype=np.float32)
    for i in range(7):
        acc = Ts[i] @ acc
        np.testing.assert_allclose(out[i], acc, atol=1e-4)


def test_rig_odometer_vmaps_independent_cameras():
    seq, cam, cfg = small_setup(3)
    n_cams = 3
    rig = RigOdometer(cam, n_cams, cfg)
    for i in range(3):
        l = np.clip(seq["left"][i], 0, 255).astype(np.uint8)
        r = np.clip(seq["right"][i], 0, 255).astype(np.uint8)
        # all cameras see the same frames -> identical results per camera
        oks = rig.update(np.stack([l] * n_cams), np.stack([r] * n_cams))
        assert oks.shape == (n_cams,)
        assert oks.all(), f"frame {i}: {oks}"
    poses = rig.current_poses()
    assert poses.shape == (n_cams, 4, 4)
    for c in range(1, n_cams):
        np.testing.assert_allclose(poses[c], poses[0], atol=1e-5)
    # And the rig actually moved forward.
    assert poses[0][2, 3] > 0.3


def test_rig_heterogeneous_sequences_independent_state_machines():
    """BASELINE config 4's real multi-camera semantics: three cameras on
    three DIFFERENT sequences (different textures AND different step
    sizes), one camera fed a blank frame mid-sequence — each camera's
    skip/fallback machine and trajectory must evolve independently
    (identical frames per camera would only prove vmap determinism)."""
    from openvo_jax.config import SKIP_KEYPOINTS

    n_frames = 4
    steps = [0.3, 0.2, 0.3]
    seqs = []
    for c, step in enumerate(steps):
        seqs.append(render_stereo_sequence(
            n_frames=n_frames, img_size=IMG_SIZE, f=280.0, baseline=0.5,
            seed=c, step=step, yaw_rate=0.004))
    cam = StereoCamera(seqs[0]["K"], seqs[0]["dist"], seqs[0]["K"],
                       seqs[0]["dist"],
                       {"R": seqs[0]["R"], "T": seqs[0]["T"]}, SGBM,
                       IMG_SIZE)
    cfg = OdometerConfig(nfeatures=256,
                         orb=ORBParams(nfeatures=256, max_keypoints=256))
    rig = RigOdometer(cam, 3, cfg)

    BLANK_FRAME, BLANK_CAM = 2, 2
    for i in range(n_frames):
        ls, rs = [], []
        for c in range(3):
            l = np.clip(seqs[c]["left"][i], 0, 255).astype(np.uint8)
            r = np.clip(seqs[c]["right"][i], 0, 255).astype(np.uint8)
            if i == BLANK_FRAME and c == BLANK_CAM:
                l = np.zeros_like(l)
                r = np.zeros_like(r)
            ls.append(l)
            rs.append(r)
        oks = rig.update(np.stack(ls), np.stack(rs))
        if i == BLANK_FRAME:
            # Only the blank camera fails, with its own skip cause; the
            # other machines are untouched.
            assert not oks[BLANK_CAM]
            assert oks[0] and oks[1], oks
            codes = rig.last_stats["skip_code"]
            assert codes[BLANK_CAM] == SKIP_KEYPOINTS
            assert codes[0] == 0 and codes[1] == 0
        else:
            assert oks.all(), (i, oks)

    poses = rig.current_poses()
    # Each camera tracked ITS OWN sequence: forward progress matches each
    # sequence's step size (camera 2 recovers the blank frame's motion by
    # matching frame 3 against its retained frame-1 state).
    z_expect = [(n_frames - 1) * s for s in steps]
    for c in range(3):
        # Independence is the contract under test, not metric accuracy:
        # per-frame fits at this toy resolution carry +-0.17 m noise and
        # seed-dependent scale bias (the KITTI-resolution bench is the
        # accuracy gate, ATE ~1%), so the bound only pins each camera to
        # ITS OWN sequence's ballpark.
        assert abs(poses[c][2, 3] - z_expect[c]) < 0.35, (
            c, poses[c][2, 3], z_expect[c])
        assert poses[c][2, 3] > 0.3  # every camera made forward progress
    assert abs(poses[0][2, 3] - poses[1][2, 3]) > 0.2  # truly different


def test_batch_relative_poses_single_device():
    seq, cam, cfg = small_setup(4)
    fn = jax.jit(make_relative_pose_fn(cam, cfg))
    ls = jnp.asarray(np.clip(seq["left"], 0, 255).astype(np.uint8))
    rs = jnp.asarray(np.clip(seq["right"], 0, 255).astype(np.uint8))
    T_rel, ok = fn(ls, rs)
    ok = np.asarray(ok)
    assert ok.shape == (4,)
    assert ok[0] and ok[1:].sum() >= 2
    # relative motion ~ 0.3m forward per tracked frame (camera convention:
    # T maps prev points into the new frame -> translation is -step in z).
    # This batch API is UNGATED (no bigdist/bigrot rejection, by design —
    # see sharding.py), so at this toy resolution a single frame's
    # unfiltered fit may be off; require the typical fit to be accurate
    # and every fit to be sane.
    T_rel = np.asarray(T_rel)
    errs = [abs(T_rel[i][2, 3] + 0.3) for i in range(1, 4) if ok[i]]
    assert np.median(errs) < 0.15, errs
    assert max(errs) < 0.5, errs


SHARDED_SUBPROCESS = r"""
import numpy as np
import jax
from __graft_entry__ import dryrun_multichip
dryrun_multichip(8)
print("SHARDED_OK")
"""


def _cpu_mesh_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    return env


@pytest.mark.slow
def test_sharded_trajectory_on_cpu_mesh():
    """Run the full multi-chip pipeline on 8 virtual CPU devices in a
    subprocess. The dryrun body
    itself asserts that tracking succeeds across shard boundaries."""
    out = subprocess.run(
        [sys.executable, "-c", SHARDED_SUBPROCESS],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=_cpu_mesh_env(), capture_output=True, text=True, timeout=3000,
    )
    assert "SHARDED_OK" in out.stdout, out.stdout + out.stderr


SHARDED_EQUALITY_SUBPROCESS = r"""
import numpy as np
import jax
import jax.numpy as jnp
from __graft_entry__ import _small_setup
from openvo_jax.parallel.sharding import (
    compose_trajectory, make_mesh, make_relative_pose_fn,
    make_sharded_trajectory_fn)

n_dev = 8
n_frames = 2 * n_dev
cam, cfg, lefts, rights = _small_setup(
    img_size=(192, 144), num_disp=64, nfeat=192, kps=192, nlevels=4,
    f=210.0, baseline=0.5, n_frames=n_frames, step=0.2)

# Single-device reference: the same ungated relative-pose pipeline.
T_rel, ok_ref = jax.jit(make_relative_pose_fn(cam, cfg))(lefts, rights)
traj_ref = compose_trajectory(T_rel)

mesh = make_mesh(n_dev)
traj, ok = make_sharded_trajectory_fn(cam, cfg, mesh)(lefts, rights)

ok, ok_ref = np.asarray(ok), np.asarray(ok_ref)
traj, traj_ref = np.asarray(traj), np.asarray(traj_ref)
assert ok.sum() >= n_frames - 2, f"tracked only {ok.sum()}/{n_frames}"
assert (ok == ok_ref).all(), (ok, ok_ref)
err = np.abs(traj - traj_ref).max()
assert err < 1e-4, f"sharded trajectory deviates: max abs err {err}"
print("VALUES_MATCH", ok.sum(), float(err))
"""


@pytest.mark.slow
def test_sharded_equals_unsharded_trajectory():
    """VALUE-shaped multi-device evidence: the 8-device sharded
    trajectory must equal the single-device relative-pose chain — this pins
    the ppermute frame-halo linkage (sharding.py) numerically, not just
    'it ran'. Matches the pose-chain contract of reference
    stereo_odometer.py:135-158."""
    out = subprocess.run(
        [sys.executable, "-c", SHARDED_EQUALITY_SUBPROCESS],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=_cpu_mesh_env(), capture_output=True, text=True, timeout=3000,
    )
    assert "VALUES_MATCH" in out.stdout, out.stdout + out.stderr


def test_stream_equals_sequential_stepping():
    """Throughput shape (parallel/stream.py): batched extract + scanned
    state machine must produce the SAME success flags and pose chain as
    frame-at-a-time make_step stepping — the stream is an execution-shape
    change only (bench.py headline path)."""
    from openvo_jax.models.stereo_odometer import init_state, make_step
    from openvo_jax.parallel.stream import make_stream_fn

    seq, cam, cfg = small_setup(5)
    lefts = jnp.asarray(np.clip(seq["left"], 0, 255).astype(np.uint8))
    rights = jnp.asarray(np.clip(seq["right"], 0, 255).astype(np.uint8))

    step = make_step(cam, cfg, color=False)

    def run_seq(state, ls, rs):
        def body(s, lr):
            s2, ok, _ = step(s, lr[0], lr[1])
            return s2, (ok, s2.c_T_w)
        return jax.lax.scan(body, state, (ls, rs))

    def mk_state():
        return init_state(cam.cropped_shape, cfg.orb.max_keypoints)

    _, (ok_ref, traj_ref) = jax.jit(run_seq)(mk_state(), lefts, rights)

    for chunk in (None, 5, 1):
        stream = jax.jit(make_stream_fn(cam, cfg, color=False, chunk=chunk))
        _, (ok, traj) = stream(mk_state(), lefts, rights)
        np.testing.assert_array_equal(np.asarray(ok), np.asarray(ok_ref))
        np.testing.assert_allclose(np.asarray(traj), np.asarray(traj_ref),
                                   atol=1e-5, err_msg=f"chunk={chunk}")
    assert np.asarray(ok_ref).all()
