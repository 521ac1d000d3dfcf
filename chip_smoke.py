"""Smoke run of the stereo-VO system on an NVIDIA GPU.

    python chip_smoke.py          # one GPU: the main path, phases 1-6
    python chip_smoke.py --four   # four GPUs: the two multi-device paths

One process drives the card through the entry points a user calls, at the
KITTI odometry geometry of bench.py (1242x376 gray, D=128, block 5,
P1/P2 200/800), on the 64-frame corridor that bench.py renders from seed 0:

  1. the card (nvidia-smi name and power limit) and JAX's devices; no GPU
     means exit 2 before any other phase;
  2. SGBM: ``sgbm_disparity16`` with the CUDA path-aggregation kernel
     against the same pipeline on the plain lax.scan reference
     (``aggregate_xla``), bit-identical, speckle off and on; the step's
     ``compiled.memory_analysis()``;
  3. the corridor through ``StereoOdometer.update`` and through the scanned
     ``make_step`` (bench.py's latency shape): equal trajectories, tracked
     frames and ATE against ground truth (ATE <= 5% of the path), and the
     first 8 frames against the CPU backend in this process (camera
     positions within 1 cm, equal ok flags);
  4. the batched entry points, ``make_stream_fn(chunk=16)`` and the
     8-camera rig (``parallel/rig.py``), against phase 3's trajectory;
     ``peak_bytes_in_use``;
  5. ``jax.profiler`` traces of 3 ``StereoOdometer.update`` frames and of
     the 64-frame scan, reduced by ``tools/trace_report.py``: busy share
     and the top 10 device ops;
  6. times, in turns: the kernel against ``aggregate_xla`` at 376x1242x128,
     and the 64-frame latency-shape step with each.

``--four`` runs only the multi-device paths, each against its one-device
result: ``make_sharded_trajectory_fn`` on a 4-device mesh (16 frames;
camera positions within 1 mm, equal ok flags: the per-device batches are
smaller, so XLA may fuse and round differently) and ``make_tiled_sgbm_fn``
at 1242x376 (376 = 4 x 94 rows), bit-identical, speckle off and on.

Every line of the phases ends with the card's name and power limit. A
failing phase makes the exit code 1 and suppresses the result line; the last line of a
passing run is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

CPU_FRAMES = 8
CPU_POS_TOL_M = 0.01
STREAM_POS_TOL_M = 1e-3
ATE_MAX_FRAC = 0.05
TRACE_FRAMES = 3
SHARDED_FRAMES = 16


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def xla_aggregation():
    """Route SGBM's path aggregation through the plain lax.scan reference
    (``aggregate_xla``) instead of the CUDA kernel, for what is traced
    inside the block. Compiled objects made inside stay valid after it."""
    import jax

    from openvo_jax.ops import sgbm

    kernel = sgbm.aggregate
    sgbm.aggregate = sgbm.aggregate_xla
    jax.clear_caches()
    try:
        yield
    finally:
        sgbm.aggregate = kernel
        jax.clear_caches()


class Smoke:
    def __init__(self, card: str):
        import jax

        self.jax = jax
        self.card = card
        self.dev = jax.devices()[0]

    def say(self, msg: str) -> None:
        print(f"{msg}  [{self.card}]", flush=True)

    def time_fn(self, fn, n: int):
        """Median and min seconds of ``n`` calls of ``fn`` (each ends in
        block_until_ready)."""
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            self.jax.block_until_ready(fn())
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)), float(min(ts))

    # -- shared set-up ------------------------------------------------------

    def setup(self, n_frames=None):
        import jax.numpy as jnp

        import bench
        from openvo_jax import OdometerConfig

        self.bench = bench
        self.n = n_frames or bench.N_FRAMES
        self.seq = bench.get_sequence(self.n)
        self.lefts = jnp.asarray(
            np.clip(self.seq["left"], 0, 255).astype(np.uint8))
        self.rights = jnp.asarray(
            np.clip(self.seq["right"], 0, 255).astype(np.uint8))
        self.cfg = OdometerConfig()
        self.cam = self.make_camera(bench.SGBM)
        self.gt = np.asarray(self.seq["T_wc"], np.float64)[:self.n]
        self.path_len = float(np.sum(np.linalg.norm(
            np.diff(self.gt[:, :3, 3], axis=0), axis=1)))
        return True

    def make_camera(self, sgbm_dict):
        from openvo_jax import StereoCamera

        s = self.seq
        return StereoCamera(s["K"], s["dist"], s["K"], s["dist"],
                            {"R": s["R"], "T": s["T"]}, sgbm_dict,
                            self.bench.IMG_SIZE)

    def make_scan(self, cam, cfg):
        """bench.py's latency shape: lax.scan of the full step."""
        from openvo_jax.models.stereo_odometer import make_step

        step = make_step(cam, cfg, color=False)

        def run_seq(state, ls, rs):
            def body(s, lr):
                s2, ok, _ = step(s, lr[0], lr[1])
                return s2, (ok, s2.c_T_w)
            return self.jax.lax.scan(body, state, (ls, rs))

        return run_seq

    def init_state(self):
        from openvo_jax.models.stereo_odometer import init_state

        return init_state(self.cam.cropped_shape,
                          self.cfg.orb.max_keypoints)

    # -- phase 2 --------------------------------------------------------------

    def phase_sgbm(self):
        jax = self.jax
        from openvo_jax.ops.sgbm import sgbm_disparity16

        left = self.lefts[0].astype(np.float32)
        right = self.rights[0].astype(np.float32)
        ok = True
        outs = {}
        for label, sgbm_dict in (("speckle off", self.bench.SGBM),
                                 ("speckle on", self.bench.SGBM_SPECKLE)):
            params = self.make_camera(sgbm_dict).sgbm
            t0 = time.time()
            outs[label] = (params, np.asarray(
                sgbm_disparity16(left, right, params)))
            self.say(f"sgbm_disparity16 ({label}) with the kernel: compiled "
                     f"and "
                  f"ran in {time.time() - t0:.1f} s")
        with xla_aggregation():
            for label, (params, got) in outs.items():
                ref = np.asarray(sgbm_disparity16(left, right, params))
                neq = int(np.sum(got != ref))
                valid = float(np.mean(got >= 0))
                self.say(f"SGBM {got.shape[0]}x{got.shape[1]} D="
                      f"{params.num_disparities} {label}: kernel vs plain "
                      f"reference: {neq} of {ref.size} pixels differ "
                      f"(valid {100 * valid:.1f}%)")
                shape = tuple(self.bench.IMG_SIZE[::-1])
                ok &= neq == 0 and got.shape == shape
        state = self.init_state()
        step = jax.jit(self.make_scan(self.cam, self.cfg)).lower(
            state, self.lefts, self.rights).compile()
        self.scan_compiled = step
        self.say(f"memory_analysis of the 64-frame step: "
              f"{step.memory_analysis()}")
        return ok

    # -- phase 3 --------------------------------------------------------------

    def trajectory_report(self, label, c_T_w, oks):
        poses = np.linalg.inv(np.asarray(c_T_w, np.float64))
        ate = float(np.mean(np.linalg.norm(
            poses[:, :3, 3] - self.gt[:len(poses), :3, 3], axis=1)))
        tracked = int(np.sum(oks))
        self.say(f"{label}: tracked {tracked}/{len(oks)}, ATE {ate:.4f} m "
                 f"over "
              f"a {self.path_len:.2f} m path ({100 * ate / self.path_len:.2f}%"
              f", limit {100 * ATE_MAX_FRAC:.0f}%)")
        return ate <= ATE_MAX_FRAC * self.path_len

    def phase_corridor(self):
        jax = self.jax
        from openvo_jax import StereoOdometer

        odo = StereoOdometer(self.cam)
        t0 = time.time()
        oks_u, cw_u = [], []
        for i in range(self.n):
            oks_u.append(odo.update(self.lefts[i], self.rights[i]))
            cw_u.append(odo.c_T_w)
        cw_u = np.stack(cw_u)
        self.say(f"StereoOdometer.update x{self.n}: {time.time() - t0:.1f} s "
              "(compile included)")
        ok = self.trajectory_report("StereoOdometer.update", cw_u, oks_u)

        _, (oks_s, cw_s) = self.scan_compiled(
            self.init_state(), self.lefts, self.rights)
        oks_s, cw_s = np.asarray(oks_s), np.asarray(cw_s)
        ok &= self.trajectory_report("scanned make_step", cw_s, oks_s)
        diff = float(np.max(np.abs(cw_s - cw_u)))
        same = bool(np.array_equal(oks_s, np.asarray(oks_u)))
        self.say(f"update vs scanned step: ok flags equal {same}, "
              f"max |c_T_w difference| {diff:.3g} (must be 0)")
        ok &= same and diff == 0.0
        self.cw_ref, self.oks_ref = cw_s, oks_s

        cpu = jax.devices("cpu")[0]
        t0 = time.time()
        with jax.default_device(cpu):
            cam_cpu = self.make_camera(self.bench.SGBM)
            from openvo_jax.models.stereo_odometer import init_state

            st = init_state(cam_cpu.cropped_shape, self.cfg.orb.max_keypoints)
            ls = jax.device_put(self.lefts[:CPU_FRAMES], cpu)
            rs = jax.device_put(self.rights[:CPU_FRAMES], cpu)
            _, (oks_c, cw_c) = jax.jit(self.make_scan(cam_cpu, self.cfg))(
                st, ls, rs)
            oks_c, cw_c = np.asarray(oks_c), np.asarray(cw_c)
        pos_c = np.linalg.inv(cw_c.astype(np.float64))[:, :3, 3]
        pos_g = np.linalg.inv(cw_s[:CPU_FRAMES].astype(np.float64))[:, :3, 3]
        dpos = float(np.max(np.linalg.norm(pos_c - pos_g, axis=1)))
        same = bool(np.array_equal(oks_c, oks_s[:CPU_FRAMES]))
        self.say(f"first {CPU_FRAMES} frames, GPU vs CPU backend "
              f"({time.time() - t0:.1f} s on the CPU): ok flags equal {same}, "
              f"max camera-position difference {dpos:.3g} m "
              f"(limit {CPU_POS_TOL_M} m)")
        return ok and same and dpos <= CPU_POS_TOL_M

    # -- phase 4 --------------------------------------------------------------

    def compare_batched(self, label, cw, oks):
        cw, oks = np.asarray(cw), np.asarray(oks)
        same = bool(np.array_equal(oks, self.oks_ref))
        dpos = float(np.max(np.linalg.norm(
            np.linalg.inv(cw.astype(np.float64))[:, :3, 3]
            - np.linalg.inv(self.cw_ref.astype(np.float64))[:, :3, 3],
            axis=1)))
        exact = bool(np.array_equal(cw, self.cw_ref))
        self.say(f"{label} vs latency shape: ok flags equal {same}, bit-equal "
              f"{exact}, max camera-position difference {dpos:.3g} m "
              f"(limit {STREAM_POS_TOL_M} m)")
        return same and dpos <= STREAM_POS_TOL_M

    def phase_batched(self):
        jax = self.jax
        import jax.numpy as jnp

        from openvo_jax.parallel.rig import init_rig_state, make_rig_step
        from openvo_jax.parallel.stream import make_stream_fn

        stream = jax.jit(make_stream_fn(self.cam, self.cfg, chunk=16),
                         donate_argnums=(0,))
        t0 = time.time()
        _, (oks, cw) = stream(self.init_state(), self.lefts, self.rights)
        ok = self.compare_batched(
            f"make_stream_fn(chunk=16) ({time.time() - t0:.1f} s)", cw, oks)

        n_cam = self.bench.N_CAMERAS
        rig_step = make_rig_step(self.cam, self.cfg)

        def run_rig(states, ls, rs):
            def body(s, lr):
                s2, okr, _ = rig_step(s, lr[0], lr[1])
                return s2, (okr, s2.c_T_w)
            return jax.lax.scan(body, states, (ls, rs))

        ls = jnp.broadcast_to(self.lefts[:, None],
                              (self.n, n_cam) + self.lefts.shape[1:])
        rs = jnp.broadcast_to(self.rights[:, None],
                              (self.n, n_cam) + self.rights.shape[1:])
        t0 = time.time()
        _, (oks, cw) = jax.jit(run_rig, donate_argnums=(0,))(
            init_rig_state(self.cam, self.cfg, n_cam), ls, rs)
        oks, cw = np.asarray(oks), np.asarray(cw)
        dt = time.time() - t0
        for c in range(n_cam):
            ok &= self.compare_batched(f"rig camera {c} ({dt:.1f} s)",
                                       cw[:, c], oks[:, c])
        peak = (self.dev.memory_stats() or {}).get("peak_bytes_in_use")
        if peak is None:
            self.say("no peak_bytes_in_use from the device")
            return False
        self.say(f"peak_bytes_in_use after phases 2-4: {peak} "
                 f"({peak / 2**30:.2f} GiB)")
        return ok

    # -- phase 5 --------------------------------------------------------------

    def phase_trace(self):
        jax = self.jax
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tools"))
        import trace_report

        from openvo_jax import StereoOdometer

        def traced(label, div, run):
            root = tempfile.mkdtemp(prefix="smoke_trace_")
            try:
                with jax.profiler.trace(root):
                    run()
                path, devices = trace_report.reduce_trace(root)
            finally:
                shutil.rmtree(root, ignore_errors=True)
            self.say(f"trace of {label} (per-unit columns are per frame):")
            self.say(trace_report.format_report(path, devices, div, 10))
            return bool(devices)

        odo = StereoOdometer(self.cam)
        odo.update(self.lefts[0], self.rights[0])  # warm: no compile inside

        def updates():
            for i in range(1, 1 + TRACE_FRAMES):
                odo.update(self.lefts[i], self.rights[i])

        st = jax.block_until_ready(self.init_state())
        ok = traced(f"{TRACE_FRAMES} StereoOdometer.update frames",
                    TRACE_FRAMES, updates)
        ok &= traced(f"the {self.n}-frame latency-shape scan", self.n,
                     lambda: jax.block_until_ready(self.scan_compiled(
                         st, self.lefts, self.rights)))
        return ok

    # -- phase 6 --------------------------------------------------------------

    def phase_timing(self):
        jax = self.jax
        import jax.numpy as jnp

        from openvo_jax.ops import sgbm

        params = self.cam.sgbm
        cap = max(params.pre_filter_cap, 15) | 1

        @jax.jit
        def cost_volume(left, right):
            lp = sgbm.prefilter_xsobel(left, cap)
            rp = sgbm.prefilter_xsobel(right, cap)
            C = sgbm.bt_cost_volume(lp, rp, params.min_disparity,
                                    params.num_disparities,
                                    block_size=params.block_size, cap=cap)
            return sgbm.block_sum(C, params.block_size)

        C = cost_volume(self.lefts[0].astype(jnp.float32),
                        self.rights[0].astype(jnp.float32))
        kern = jax.jit(lambda c: sgbm.aggregate(c, params)).lower(C).compile()
        xla = jax.jit(lambda c: sgbm.aggregate_xla(c, params)).lower(
            C).compile()
        same = bool(jnp.array_equal(kern(C), xla(C)))
        self.say(f"aggregate: kernel vs aggregate_xla on the corridor's "
                 f"frame 0 "
              f"cost volume {tuple(C.shape)} {C.dtype}: bit-equal {same}")
        for label, fn in (("kernel", kern), ("aggregate_xla", xla),
                          ("aggregate_xla", xla), ("kernel", kern)):
            med, best = self.time_fn(lambda f=fn: f(C), 20)
            self.say(f"path aggregation {'x'.join(map(str, C.shape))}, "
                     f"{params.num_paths} paths, {label}: median "
                     f"{1e3 * med:.3f} ms, "
                     f"min {1e3 * best:.3f} ms")

        state = self.init_state()
        with xla_aggregation():
            t0 = time.time()
            scan_xla = jax.jit(self.make_scan(self.cam, self.cfg)).lower(
                state, self.lefts, self.rights).compile()
            self.say(f"64-frame step with aggregate_xla compiled in "
                  f"{time.time() - t0:.1f} s")
        _, (oks_x, _) = scan_xla(self.init_state(), self.lefts, self.rights)
        n_ok = int(np.sum(np.asarray(oks_x)))
        self.say(f"64-frame step with aggregate_xla: tracked {n_ok}/{self.n} "
              f"(kernel: {int(np.sum(self.oks_ref))})")
        for label, fn in (("kernel", self.scan_compiled),
                          ("aggregate_xla", scan_xla),
                          ("aggregate_xla", scan_xla),
                          ("kernel", self.scan_compiled)):
            st = [jax.block_until_ready(self.init_state()) for _ in range(3)]
            med, best = self.time_fn(
                lambda f=fn: f(st.pop(), self.lefts, self.rights), 3)
            self.say(f"64-frame latency-shape step, {label}: median "
                     f"{1e3 * med:.1f} ms ({self.n / med:.2f} frames/s), "
                     f"min {1e3 * best:.1f} ms")
        return same and n_ok == int(np.sum(self.oks_ref))

    # -- --four -----------------------------------------------------------

    def phase_sharded(self):
        jax = self.jax
        from openvo_jax.parallel.sharding import (
            make_mesh, make_sharded_trajectory_fn)

        n = min(SHARDED_FRAMES, self.n)
        ls, rs = self.lefts[:n], self.rights[:n]
        one = make_sharded_trajectory_fn(self.cam, self.cfg, make_mesh(1))
        traj1, ok1 = (np.asarray(a) for a in one(ls, rs))
        four = make_sharded_trajectory_fn(self.cam, self.cfg, make_mesh(4))
        t0 = time.time()
        traj4, ok4 = (np.asarray(a) for a in four(ls, rs))
        same = bool(np.array_equal(ok1, ok4))
        dpos = float(np.max(np.linalg.norm(
            np.linalg.inv(traj1.astype(np.float64))[:, :3, 3]
            - np.linalg.inv(traj4.astype(np.float64))[:, :3, 3], axis=1)))
        self.say(f"make_sharded_trajectory_fn, {n} frames, 4-device mesh vs "
              f"1 device ({time.time() - t0:.1f} s): ok flags equal {same} "
              f"({int(ok4.sum())}/{n} ok), bit-equal "
              f"{bool(np.array_equal(traj1, traj4))}, max camera-position "
              f"difference {dpos:.3g} m (limit {STREAM_POS_TOL_M} m)")
        return same and dpos <= STREAM_POS_TOL_M

    def phase_tiled(self):
        from openvo_jax.ops.sgbm import sgbm_disparity16
        from openvo_jax.parallel.tiling import (make_row_mesh,
                                                make_tiled_sgbm_fn)

        ok = True
        for label, sgbm_dict in (("speckle off", self.bench.SGBM),
                                 ("speckle on", self.bench.SGBM_SPECKLE)):
            params = self.make_camera(sgbm_dict).sgbm
            left, right = self.lefts[0], self.rights[0]
            ref = np.asarray(sgbm_disparity16(left, right, params))
            fn = make_tiled_sgbm_fn(params, make_row_mesh(4))
            got = np.asarray(fn(left, right))
            neq = int(np.sum(got != ref))
            self.say(f"make_tiled_sgbm_fn {ref.shape[0]}x{ref.shape[1]} on 4 "
                  f"devices ({label}) vs "
                  f"sgbm_disparity16 on one: {neq} of {ref.size} pixels "
                  "differ")
            ok &= neq == 0
        return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the two multi-device paths on 4 GPUs")
    args = ap.parse_args()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices}", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)
    print(f"jax {jax.__version__}: {devices}", flush=True)
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"need {need} GPUs, JAX found {len(devices)}", file=sys.stderr)
        return 2

    from openvo_jax.utils.cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    smoke = Smoke(card)
    if args.four:
        phases = [("setup", lambda: smoke.setup(SHARDED_FRAMES)),
                  ("sharded trajectory", smoke.phase_sharded),
                  ("tiled SGBM", smoke.phase_tiled)]
    else:
        phases = [("setup", smoke.setup), ("2 SGBM kernel", smoke.phase_sgbm),
                  ("3 corridor", smoke.phase_corridor),
                  ("4 stream and rig", smoke.phase_batched),
                  ("5 trace", smoke.phase_trace),
                  ("6 kernel vs XLA timing", smoke.phase_timing)]
    failed = []
    for name, fn in phases:
        t0 = time.time()
        try:
            ok = bool(fn())
        except Exception:  # noqa: BLE001 - report and fail the phase
            traceback.print_exc()
            ok = False
        print(f"== phase {name}: {'ok' if ok else 'FAILED'} "
              f"({time.time() - t0:.1f} s)", flush=True)
        if not ok:
            failed.append(name)
            if name == "setup":
                break
    if failed:
        print(f"FAILED phases: {failed}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
