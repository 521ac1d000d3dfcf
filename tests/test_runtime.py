"""The GPU runtime around the pipeline: matmul precision of the traced
step, the smoke script's refusal to run without a GPU, the compile-cache
helper and the trace reducer."""

import os
import re
import shutil
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

from openvo_jax.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import trace_report  # noqa: E402


def _f32_dot_precisions(hlo: str):
    dots = [ln for ln in hlo.splitlines() if "stablehlo.dot_general" in ln]
    f32 = [ln for ln in dots if re.search(r"->\s*tensor<[0-9x]*xf32>", ln)]
    return [re.search(r"precision = \[([A-Z]+), ([A-Z]+)\]", ln)
            for ln in f32]


@pytest.mark.parametrize("entry", ["make_step", "make_stream_fn"])
def test_step_f32_matmuls_run_at_highest_precision(entry):
    """Without the global "highest" setting of this suite, every f32
    dot_general of the traced step still carries HIGHEST precision."""
    from __graft_entry__ import _small_setup
    from openvo_jax.models.stereo_odometer import init_state, make_step
    from openvo_jax.parallel.stream import make_stream_fn

    cam, cfg, lefts, rights = _small_setup(
        img_size=(128, 96), num_disp=32, nfeat=64, kps=64, nlevels=3,
        f=140.0, n_frames=2)
    state = init_state(cam.cropped_shape, cfg.orb.max_keypoints)
    with jax.default_matmul_precision(None):
        if entry == "make_step":
            fn, args = make_step(cam, cfg, False), (state, lefts[0],
                                                    rights[0])
        else:
            fn, args = make_stream_fn(cam, cfg), (state, lefts, rights)
        hlo = jax.jit(fn).lower(*args).as_text()
    found = _f32_dot_precisions(hlo)
    assert len(found) >= 4  # Q reprojection, ORB moments, Kabsch, pose chain
    assert all(m and m.groups() == ("HIGHEST", "HIGHEST") for m in found)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """On the CPU the smoke script exits non-zero before any phase and
    prints no result line; also when it stands alone, away from the
    repository."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "== phase" not in out.stdout
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_compile_cache_follows_the_environment(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    assert cache.compile_cache_dir() == str(tmp_path)
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    want = os.path.join(REPO, ".jax_cache")
    try:
        assert cache.compile_cache_dir() == want
        assert cache.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_bench_sequence_cache_lives_in_the_checkout():
    import bench

    assert bench.seq_cache_path() == os.path.join(REPO, ".bench_seq.npz")
    assert cache.checkout_path("x") == os.path.join(REPO, "x")


@pytest.mark.parametrize("module", ["bench", "openvo_jax"])
def test_import_reserves_no_device(module):
    """bench.py's parent must leave the card to its pass subprocesses (a
    JAX process that reaches a GPU reserves most of its memory): importing
    bench pulls in no JAX, and importing the package starts no backend."""
    code = (f"import sys, {module}\n"
            "if 'jax' in sys.modules:\n"
            "    from jax._src import xla_bridge\n"
            "    assert not xla_bridge._backends, list(xla_bridge._backends)\n"
            f"print('jax' in sys.modules)")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(module != "bench")


def _plane(name, lines):
    return SimpleNamespace(name=name, lines=[
        SimpleNamespace(name=ln, events=[
            SimpleNamespace(name=e[0], start_ns=e[1], duration_ns=e[2],
                            stats=list(e[3:]))
            for e in evs]) for ln, evs in lines.items()])


def test_trace_reducer_busy_share_and_top_ops():
    op = "hlo_op"
    gpu = _plane("/device:GPU:0", {
        "XLA Modules": [("jit_step", 0, 100)],
        "Stream #14(compute)": [("k1", 0, 30, (op, "fusion.1")),
                                ("k2", 40, 50, (op, "sgm")),
                                ("k3", 60, 10, (op, "sgm")),
                                ("k4", 95, 5, (op, "fusion.1"))],
        "Stream #15(copy)": [("memcpy", 20, 15)],
    })
    host = _plane("/host:CPU", {"python": [("x", 0, 1000)]})
    out = trace_report.reduce_planes([host, gpu])
    assert list(out) == ["/device:GPU:0"]
    r = out["/device:GPU:0"]
    # kernels cover [0, 35) from two streams, [40, 90) and [95, 100)
    assert r["busy_ns"] == 90 and r["span_ns"] == 100
    assert r["busy_share"] == pytest.approx(0.9)
    assert [g for g, _ in r["gaps"]] == [5, 5]
    assert r["top_ops"] == [("sgm", 2, 60.0), ("fusion.1", 2, 35.0),
                            ("memcpy", 1, 15.0)]
    text = trace_report.format_report("t", out, div=2)
    assert "busy share 90.0%" in text


def test_trace_reducer_names_kernels_by_hlo_op_without_ops_line():
    gpu = _plane("/device:GPU:0", {
        "Stream #7": [("sgm_paths_kernel", 0, 40, ("hlo_op", "custom-call.3")),
                      ("loop_fusion_9", 50, 10, ("hlo_op", "command_buffer")),
                      ("loop_fusion_9", 70, 10, ("hlo_op", "command_buffer")),
                      ("memset", 90, 2)],
    })
    r = trace_report.reduce_planes([gpu])["/device:GPU:0"]
    assert r["top_ops"] == [("custom-call.3", 1, 40.0),
                            ("loop_fusion_9", 2, 20.0), ("memset", 1, 2.0)]
    assert r["busy_ns"] == 62 and r["span_ns"] == 92


def test_trace_reducer_ignores_planes_without_kernels():
    assert trace_report.reduce_planes(
        [_plane("/device:GPU:0", {"XLA Modules": [("a", 0, 1)]})]) == {}
