"""Benchmark: stereo-VO throughput at KITTI resolution on one GPU.

Prints JSON lines of the form
  {"metric": ..., "value": N, "unit": "frames/sec/device", ...}
CUMULATIVELY — one updated line after EVERY completed pass, so the last
line always carries every number measured so far even if a later pass
times out. Every line names the device: ``platform``, ``device_kind`` and
``device_count`` as JAX reports them, and the card's ``gpu_name`` and
``power_limit`` as nvidia-smi reports them. A run that finds no GPU fails
(exit code 1); it never falls back to the CPU.

Passes (each a SUBPROCESS with its own budget, run one at a time; the
parent never imports JAX, so only one process holds the card):
  off-lat  speckle-off, frame-at-a-time lax.scan of the full jitted step
           (rectify -> SGBM -> reproject -> ORB -> match -> Kabsch -> gates
           -> pose chain). Causal per-frame latency.
  off-tp   speckle-off, batched feature extraction + scanned state machine
           (parallel/stream.py). Bit-identical trajectory.
  on-lat   speckle ON (the KITTI loader's shipped default, io/kitti.py),
           latency shape.
  rig      8-camera vmapped rig (BASELINE config 4): aggregate
           frames/sec/device across cameras.

The headline `value` is the best completed speckle-off shape; per-shape
numbers and compile seconds are reported as separate fields.

Run `python bench.py --one <pass>` to reproduce a single pass manually.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

IMG_SIZE = (1242, 376)   # KITTI odometry gray resolution
F, B = 718.0, 0.54       # KITTI-like focal length / baseline
N_FRAMES = 64            # 64 frames / 31.5 m path
RENDER_TAG = 2           # bump when the scene geometry/params change
N_CAMERAS = 8            # rig pass (BASELINE config 4)
PER_FRAME = ("left", "right", "depth", "T_wc")  # arrays indexed by frame
SGBM = {
    "minDisparity": 0, "numDisparities": 128, "blockSize": 5,
    "P1": 200, "P2": 800, "disp12MaxDiff": 1, "preFilterCap": 63,
    "uniquenessRatio": 10, "speckleWindowSize": 0, "speckleRange": 0,
}
# The KITTI loader's shipped defaults enable speckle (io/kitti.py:24-28);
# the bench reports BOTH paths.
SGBM_SPECKLE = dict(SGBM, speckleWindowSize=100, speckleRange=2)

# Per-pass subprocess budgets (seconds). Ordered by importance; the parent
# additionally enforces GLOBAL_BUDGET over the whole run.
PASSES = [
    ("off-lat", int(os.environ.get("BENCH_T_OFF_LAT", 500))),
    ("off-tp", int(os.environ.get("BENCH_T_OFF_TP", 350))),
    ("on-lat", int(os.environ.get("BENCH_T_ON", 250))),
    ("rig", int(os.environ.get("BENCH_T_RIG", 300))),
]
GLOBAL_BUDGET = int(os.environ.get("BENCH_GLOBAL_BUDGET", 1250))


def card_info():
    """(name, power limit) of the first GPU as nvidia-smi reports them, or
    (None, None) where nvidia-smi is missing or finds no card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None, None
    first = out.stdout.strip().splitlines()[:1]
    if out.returncode != 0 or not first:
        return None, None
    name, _, limit = first[0].partition(",")
    return name.strip(), limit.strip()


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def seq_cache_path() -> str:
    """``<checkout>/.bench_seq.npz``: shares the rendered sequence across
    the pass subprocesses. The helper is imported here, not at the top, so
    that the parent never imports JAX."""
    from openvo_jax.utils.cache import checkout_path

    return checkout_path(".bench_seq.npz")


def get_sequence(n_frames: int = N_FRAMES):
    """Render (or load cached) synthetic corridor sequence at KITTI res,
    from seed 0: its first ``n_frames`` frames."""
    seq_cache = seq_cache_path()
    if os.path.exists(seq_cache):
        try:
            with np.load(seq_cache) as z:
                seq = {k: z[k] for k in z.files}
            if (seq["left"].shape[0] >= n_frames
                    and int(seq.get("render_tag", 0)) == RENDER_TAG):
                log(f"loaded cached sequence from {seq_cache}")
                return {k: (v[:n_frames] if k in PER_FRAME else v)
                        for k, v in seq.items()}
        except Exception as e:  # noqa: BLE001 - corrupt cache: re-render
            log(f"seq cache load failed ({e}); re-rendering")
    from openvo_jax.io.synthetic import render_stereo_sequence
    t0 = time.time()
    # Corridor sized for the 31.5 m path: the camera must neither reach
    # the back wall (valid-disparity band needs >= ~4 m of scene ahead)
    # nor drift into a side wall (steady yaw accumulates ~4 m laterally).
    seq = render_stereo_sequence(n_frames=n_frames, img_size=IMG_SIZE, f=F,
                                 baseline=B, seed=0, step=0.5,
                                 yaw_rate=0.004, corridor_length=80.0,
                                 corridor_half_width=7.0)
    log(f"rendered {n_frames} frames at {IMG_SIZE} in {time.time()-t0:.1f}s")
    seq["render_tag"] = np.asarray(RENDER_TAG)
    try:
        np.savez(seq_cache, **{k: np.asarray(v) for k, v in seq.items()})
    except Exception as e:  # noqa: BLE001 - cache is best-effort
        log(f"seq cache save failed: {e}")
    return seq


def run_one(tag: str):
    """Run one bench pass on the GPU; prints a PASS_RESULT JSON line."""
    import jax
    import jax.numpy as jnp

    from openvo_jax.utils.cache import compile_cache_dir, enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"no GPU: JAX found {jax.devices()}")
        sys.exit(1)
    enable_compile_cache()

    from openvo_jax import OdometerConfig, StereoCamera
    from openvo_jax.models.stereo_odometer import init_state, make_step
    from openvo_jax.parallel.stream import make_stream_fn

    sgbm_dict = SGBM_SPECKLE if tag.startswith("on") else SGBM

    log(f"devices: {jax.devices()}")
    seq = get_sequence()
    cfg = OdometerConfig()
    lefts = jnp.asarray(np.clip(seq["left"], 0, 255).astype(np.uint8))
    rights = jnp.asarray(np.clip(seq["right"], 0, 255).astype(np.uint8))
    cam = StereoCamera(seq["K"], seq["dist"], seq["K"], seq["dist"],
                       {"R": seq["R"], "T": seq["T"]}, sgbm_dict, IMG_SIZE)

    def mk_state():
        return init_state(cam.cropped_shape, cfg.orb.max_keypoints)

    def cache_entries():
        try:
            return len(os.listdir(compile_cache_dir()))
        except OSError:
            return 0

    def time_passes(run_fn, mk_st, label, n_work):
        n_cache0 = cache_entries()
        t0 = time.time()
        state, (oks, c_T_w) = run_fn(mk_st(), lefts, rights)
        tracked = int(np.asarray(oks).sum())
        compile_s = time.time() - t0
        # cold vs warm compile is observable: a cold compile writes new
        # persistent-cache entries, a warm one doesn't.
        compile_cold = cache_entries() > n_cache0
        log(f"[{label}] compile+first run: {compile_s:.1f}s, "
            f"tracked {tracked}/{np.asarray(oks).size}")
        cw = np.asarray(c_T_w, np.float64)
        if cw.ndim == 4:  # rig: (T, N, 4, 4) -> camera 0
            cw = cw[:, 0]
        poses = np.linalg.inv(cw)
        gt = np.asarray(seq["T_wc"], np.float64)
        ate = float(np.mean(np.linalg.norm(
            poses[:, :3, 3] - gt[:N_FRAMES, :3, 3], axis=1)))
        path_len = 0.5 * (N_FRAMES - 1)
        log(f"[{label}] ATE {ate:.3f} m over {path_len:.1f} m path "
            f"({100 * ate / path_len:.1f}%)")
        best = float("inf")
        for it in range(3):
            st = jax.block_until_ready(mk_st())
            t0 = time.perf_counter()
            out = jax.block_until_ready(run_fn(st, lefts, rights))
            dt = time.perf_counter() - t0
            n_ok = int(np.asarray(out[1][0]).sum())
            best = min(best, dt)
            log(f"[{label}] pass {it}: {dt*1000:.1f} ms for {n_work} "
                f"frames ({n_work/dt:.1f} fps, {n_ok} ok)")
        return dict(fps=n_work / best, tracked=tracked, ate=ate,
                    path_len=path_len, compile_s=round(compile_s, 1),
                    compile_cold=compile_cold)

    if tag == "rig":
        step = make_step(cam, cfg, color=False)
        rig_step = jax.vmap(step)

        def run_rig(states, ls, rs):
            def body(s, lr):
                s2, ok, _ = rig_step(s, lr[0], lr[1])
                return s2, (ok, s2.c_T_w)
            return jax.lax.scan(body, states, (ls, rs))

        run_rig_j = jax.jit(run_rig, donate_argnums=(0,))
        # Identical streams per camera: throughput-only number, compute is
        # shape-bound so duplicated data times the same as distinct data.
        lefts = jnp.broadcast_to(lefts[:, None], (N_FRAMES, N_CAMERAS)
                                 + lefts.shape[1:])
        rights = jnp.broadcast_to(rights[:, None], (N_FRAMES, N_CAMERAS)
                                  + rights.shape[1:])

        def mk_rig():
            one = mk_state()
            return jax.tree_util.tree_map(
                lambda x: jnp.broadcast_to(x, (N_CAMERAS,) + x.shape), one)

        r = time_passes(run_rig_j, mk_rig, tag, N_FRAMES * N_CAMERAS)
    elif tag.endswith("-tp"):
        # chunk=16: a 64-frame batched extract would hold 64 frames' cost
        # and aggregated volumes (~360 MB each) at once.
        stream = jax.jit(make_stream_fn(cam, cfg, color=False, chunk=16),
                         donate_argnums=(0,))
        r = time_passes(stream, mk_state, tag, N_FRAMES)
    else:  # latency shape: frame-at-a-time scan of the full step
        step = make_step(cam, cfg, color=False)

        def run_seq(state, ls, rs):
            def body(s, lr):
                s2, ok, _ = step(s, lr[0], lr[1])
                return s2, (ok, s2.c_T_w)
            return jax.lax.scan(body, state, (ls, rs))

        run_seq_j = jax.jit(run_seq, donate_argnums=(0,))
        r = time_passes(run_seq_j, mk_state, tag, N_FRAMES)

    r["tag"] = tag
    r["platform"] = dev.platform
    r["device_kind"] = dev.device_kind
    r["device_count"] = len(jax.devices())
    print("PASS_RESULT " + json.dumps(r), flush=True)


def emit(results, card):
    """Print the cumulative headline JSON line from completed passes."""
    name, limit = card
    any_r = next(iter(results.values()), {})
    device = {
        "platform": any_r.get("platform"),
        "device_kind": any_r.get("device_kind"),
        "device_count": any_r.get("device_count"),
        "gpu_name": name,
        "power_limit": limit,
    }
    off_lat = results.get("off-lat")
    off_tp = results.get("off-tp")
    shapes = [(s, r) for s, r in (("latency", off_lat), ("stream", off_tp))
              if r is not None]
    if not shapes:
        print(json.dumps({
            "metric": "stereo_vo_throughput_kitti_res", "value": 0.0,
            "unit": "frames/sec/device", **device,
            "error": "no speckle-off pass completed",
        }), flush=True)
        return
    head_shape, head = max(shapes, key=lambda sr: sr[1]["fps"])
    out = {
        "metric": "stereo_vo_throughput_kitti_res",
        "value": round(head["fps"], 2),
        "unit": "frames/sec/device",
        **device,
        "headline_shape": head_shape,
        "tracked_frames": head["tracked"],
        "total_frames": N_FRAMES,
        "ate_m": round(head["ate"], 4),
        "ate_pct_of_path": round(100 * head["ate"] / head["path_len"], 2),
    }
    for key, r in (("latency", off_lat), ("stream", off_tp),
                   ("speckle_on", results.get("on-lat")),
                   ("rig", results.get("rig"))):
        if r is not None:
            out[f"{key}_fps"] = round(r["fps"], 2)
            out[f"{key}_compile_s"] = r["compile_s"]
            out[f"{key}_compile_cold"] = r.get("compile_cold")
        else:
            out[f"{key}_fps"] = None
    on = results.get("on-lat")
    if on is not None:
        out["speckle_on_tracked"] = on["tracked"]
        out["speckle_on_ate_m"] = round(on["ate"], 4)
    if results.get("rig") is not None:
        out["rig_fps_aggregate"] = out.pop("rig_fps")
        out["rig_n_cameras"] = N_CAMERAS
    print(json.dumps(out), flush=True)


def main():
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        run_one(sys.argv[2])
        return

    # Parent: orchestrate one subprocess per pass; never imports jax.
    card = card_info()
    log(f"card: {card[0]}, power limit {card[1]}")
    results = {}
    t_start = time.time()
    for tag, budget in PASSES:
        remaining = GLOBAL_BUDGET - (time.time() - t_start)
        budget = min(budget, int(remaining))
        if budget < 60:
            log(f"[{tag}] skipped: {remaining:.0f}s of global budget left")
            continue
        t0 = time.time()
        out_text = ""
        try:
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", tag],
                stdout=subprocess.PIPE, stderr=sys.stderr,
                timeout=budget, text=True)
            out_text = p.stdout or ""
        except subprocess.TimeoutExpired as e:
            log(f"[{tag}] TIMED OUT after {time.time()-t0:.0f}s")
            out = e.stdout or b""
            out_text = out.decode() if isinstance(out, bytes) else out
        for line in out_text.splitlines():
            if line.startswith("PASS_RESULT "):
                results[tag] = json.loads(line[len("PASS_RESULT "):])
        if tag not in results:
            log(f"[{tag}] no result")
        # Cumulative emit: the last line carries every completed pass.
        emit(results, card)
    if not results:
        sys.exit(1)


if __name__ == "__main__":
    main()
