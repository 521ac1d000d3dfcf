"""SGM path aggregation: the Hopper kernel's line decomposition and wrapper.

The CUDA kernel (ops/cuda/sgm_paths.cu) walks the line table that
ops/sgm_cuda.py:path_lines builds; it has no interpret mode. On the CPU,
``walk_lines`` below replays that table with the kernel's per-line
recurrence in NumPy float32 and must equal the lax.scan reference bit for
bit; the wrapper's lowering for a CUDA device (target, padding, batching,
the choice between kernel and reference) is checked from its StableHLO.
The kernel itself is compared with the reference by the ``gpu`` tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from openvo_jax.config import SGBMParams
from openvo_jax.ops import sgbm, sgm_cuda

P1, P2 = 200.0, 800.0
ALL_DIRS = [(0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1),
            (-1, -1)]


def walk_lines(cost, dirs, lines, p1, p2, init=None):
    """NumPy model of the kernel: each table row is one warp's line."""
    cost = np.asarray(cost)
    if cost.dtype == np.int16:
        cost = cost.astype(np.float32) * np.float32(0.5)
    H, W, D = cost.shape
    big = np.float32(sgm_cuda.BIG)
    p1, p2 = np.float32(p1), np.float32(p2)
    S = np.zeros((H, W, D), np.float32)
    carry = np.zeros((len(dirs), W, D), np.float32)
    for i, y, x, n, init_x in lines:
        dy, dx = dirs[i]
        pr = (np.asarray(init[i][init_x], np.float32)
              if init is not None and init_x >= 0
              else np.full(D, big, np.float32))
        for _ in range(n):
            m = pr.min()
            left = np.concatenate([[big], pr[:-1]]).astype(np.float32)
            right = np.concatenate([pr[1:], [big]]).astype(np.float32)
            cand = np.minimum(pr, np.minimum(left, right) + p1)
            cand = np.minimum(cand, m + p2)
            L = (cost[y, x] + cand) - m
            S[y, x] += L
            if dy != 0 and y == (H - 1 if dy > 0 else 0):
                carry[i, x] = L
            pr = L
            y += dy
            x += dx
    return S, carry


def random_cost(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 3000, shape)
    if dtype == "int16":
        return c.astype(np.int16)
    return (c * 0.5).astype(np.float32)


@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("num_paths", [4, 5, 8])
def test_line_walk_matches_aggregate(num_paths, dtype):
    cost = random_cost((7, 11, 32), dtype)
    params = SGBMParams(num_disparities=32, p1=int(P1), p2=int(P2),
                        num_paths=num_paths)
    dirs = sgbm.path_directions(num_paths)
    S, _ = walk_lines(cost, dirs, sgm_cuda.path_lines(7, 11, dirs), P1, P2)
    ref = np.asarray(jax.jit(lambda c: sgbm.aggregate(c, params))(cost))
    np.testing.assert_array_equal(S, ref)


@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("reverse", [False, True])
def test_line_walk_init_carry_matches_row_scan(reverse, dtype):
    """A sweep split into two row bands, the second seeded with the first's
    carry (parallel/tiling.py's wavefront), equals the unsplit sweep."""
    cost = random_cost((10, 9, 16), dtype, seed=1)
    shifts = (0, 1, -1)
    dirs = [(-1 if reverse else 1, k) for k in shifts]
    first, second = ((cost[5:], cost[:5]) if reverse
                     else (cost[:5], cost[5:]))

    def scan(c, init=None):
        return jax.jit(lambda c, i: sgbm.path_sum(c, dirs, P1, P2, i))(
            c, init)

    s1, c1 = scan(first)
    s2, c2 = scan(second, c1)
    w1, k1 = walk_lines(first, dirs, sgm_cuda.path_lines(5, 9, dirs), P1, P2)
    w2, k2 = walk_lines(second, dirs, sgm_cuda.path_lines(5, 9, dirs), P1,
                        P2, init=k1)
    np.testing.assert_array_equal(w1, np.asarray(s1))
    np.testing.assert_array_equal(k1, np.asarray(c1))
    np.testing.assert_array_equal(w2, np.asarray(s2))
    np.testing.assert_array_equal(k2, np.asarray(c2))
    whole, _ = sgbm.path_sum(jnp.asarray(cost), dirs, P1, P2)
    split = (np.concatenate([s2, s1]) if reverse
             else np.concatenate([s1, s2]))
    np.testing.assert_array_equal(split, np.asarray(whole))


@pytest.mark.parametrize("d", ALL_DIRS)
def test_path_lines_visit_every_pixel_once(d):
    H, W = 6, 9
    lines = sgm_cuda.path_lines(H, W, [d])
    seen = np.zeros((H, W), int)
    dy, dx = d
    for _, y, x, n, init_x in lines:
        # A line starts where its predecessor is off the image...
        py, px = y - dy, x - dx
        assert not (0 <= py < H and 0 <= px < W)
        # ...and takes the init row only from the row before the first.
        if init_x >= 0:
            assert dy != 0 and py in (-1, H) and init_x == px
        for _ in range(n):
            seen[y, x] += 1
            y, x = y + dy, x + dx
        assert not (0 <= y < H and 0 <= x < W)  # ...and runs to the edge
    np.testing.assert_array_equal(seen, 1)
    assert (np.diff(lines[:, 3]) <= 0).all()  # longest lines first


def _cuda_hlo(fn, *args):
    return jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()


def _kernel_calls(hlo):
    return [ln for ln in hlo.splitlines()
            if f"custom_call @{sgm_cuda.TARGET}" in ln]


@pytest.mark.parametrize("num_paths", [4, 5, 8])
def test_aggregate_lowers_to_one_kernel_call_on_cuda(num_paths):
    cost = jnp.asarray(random_cost((8, 12, 32), "int16"))
    params = SGBMParams(num_disparities=32, num_paths=num_paths)
    cuda = _cuda_hlo(lambda c: sgbm.aggregate(c, params), cost)
    calls = _kernel_calls(cuda)
    assert len(calls) == 1
    assert "stablehlo.while" not in cuda
    dirs = np.asarray(sgbm.path_directions(num_paths)).reshape(-1)
    assert f"dense<[{', '.join(map(str, dirs))}]>" in calls[0]
    cpu = jax.jit(lambda c: sgbm.aggregate(c, params)).trace(cost).lower(
        lowering_platforms=("cpu",)).as_text()
    assert not _kernel_calls(cpu) and "stablehlo.while" in cpu


def test_wrapper_pads_disparities_to_16():
    cost = jnp.asarray(random_cost((4, 6, 24), "float32"))
    fn = lambda c: sgm_cuda.path_sum(c, ALL_DIRS, P1, P2)  # noqa: E731
    (call,) = _kernel_calls(_cuda_hlo(fn, cost))
    assert "tensor<4x6x32xf32>" in call and "num_disp = 24" in call
    S, carry = jax.eval_shape(fn, cost)
    assert S.shape == (4, 6, 24) and carry.shape == (8, 6, 24)


def test_wrapper_batches_vmap_into_one_call():
    cost = jnp.asarray(random_cost((3, 4, 6, 16), "int16"))
    hlo = _cuda_hlo(jax.vmap(lambda c: sgm_cuda.path_sum(
        c, ALL_DIRS[:2], P1, P2)[0]), cost)
    (call,) = _kernel_calls(hlo)
    assert "tensor<3x4x6x16xi16>" in call
    assert "tensor<1x" in call  # the unbatched line table: one leading 1


def test_wrapper_casts_other_cost_dtypes_to_f32():
    cost = jnp.asarray(random_cost((4, 6, 16), "int16").astype(np.int32))
    (call,) = _kernel_calls(_cuda_hlo(
        lambda c: sgm_cuda.path_sum(c, ALL_DIRS[:1], P1, P2)[0], cost))
    assert "tensor<4x6x16xf32>" in call


def test_wrapper_rejects_too_many_disparities():
    cost = jnp.zeros((2, 3, sgm_cuda.MAX_DISP + 16), jnp.int16)
    with pytest.raises(ValueError, match="disparities"):
        jax.eval_shape(lambda c: sgm_cuda.path_sum(c, ALL_DIRS, P1, P2),
                       cost)


@pytest.mark.gpu
@pytest.mark.parametrize("num_paths", [4, 5, 8])
def test_kernel_bit_identical_on_gpu(gpu_device, num_paths):
    cost = jax.device_put(random_cost((40, 70, 64), "int16"), gpu_device)
    params = SGBMParams(num_disparities=64, num_paths=num_paths)
    got = jax.jit(lambda c: sgbm.aggregate(c, params))(cost)
    ref = jax.jit(lambda c: sgbm.aggregate_xla(c, params))(cost)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.gpu
def test_kernel_init_carry_on_gpu(gpu_device):
    cost = jax.device_put(random_cost((20, 30, 48), "float32"), gpu_device)
    dirs = [(1, 0), (1, 1), (1, -1)]

    def both(c):
        s1, k1 = sgm_cuda.path_sum(c[:9], dirs, P1, P2)
        s2, k2 = sgm_cuda.path_sum(c[9:], dirs, P1, P2, k1)
        r1, j1 = sgbm.path_sum_xla(c[:9], dirs, P1, P2)
        r2, j2 = sgbm.path_sum_xla(c[9:], dirs, P1, P2, j1)
        return (s1, k1, s2, k2), (r1, j1, r2, j2)

    got, ref = jax.jit(both)(cost)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
