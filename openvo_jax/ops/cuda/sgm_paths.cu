// SGM path aggregation for NVIDIA Hopper (sm_90a), called from JAX through
// XLA's foreign function interface (target "openvo_sgm_paths").
//
// Every SGM path direction is a set of independent scanlines: L at a pixel
// depends only on L at its predecessor on the same line. One warp owns one
// whole line and walks along it; the disparities are spread over the 32
// lanes (VPT consecutive disparities per lane), the d-1 / d+1 neighbours
// come from warp shuffles and the min over d is one warp reduction. All
// directions of a call run in one launch, so a KITTI frame gives ~10k
// concurrent lines. Each step reads one cost row (D values) once and adds
// its L row into S with vector atomics: the costs are exact half-integers
// and every partial sum stays far below 2^23, so the sum is exact in any
// order and S is bit-identical to the lax.scan reference (ops/sgbm.py).
//
// The line table (direction, start pixel, length, init column) is built in
// Python (ops/sgm_cuda.py:path_lines) so that the decomposition is tested
// on the CPU; this file only walks it.
//
// Recurrence (identical float operations to ops/sgbm.py:_scan_rows):
//   m    = min_k pr[k]
//   cand = min(pr[d], min(pr[d-1], pr[d+1]) + P1)      (BIG past the ends)
//   cand = min(cand, m + P2)
//   L[d] = (C[d] + cand) - m
// where pr is L at the predecessor, the init row at a line's first pixel on
// the first scan row, and BIG (1e9) everywhere else a line starts.

#include <cstdint>
#include <string>
#include <type_traits>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr float kBig = 1e9f;
constexpr int kMaxDirs = 8;
constexpr int kWarpsPerBlock = 4;
constexpr int kLineCols = 5;  // dir, y0, x0, length, init column (-1: BIG)
constexpr unsigned kFull = 0xffffffffu;

struct Dirs {
  int dy[kMaxDirs];
  int dx[kMaxDirs];
};

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <int VPT, typename CostT>
__device__ __forceinline__ void load_cost(const CostT* p, float (&c)[VPT]) {
  const Vec<CostT, VPT> v = *reinterpret_cast<const Vec<CostT, VPT>*>(p);
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    if constexpr (std::is_same_v<CostT, int16_t>) {
      c[j] = static_cast<float>(v.v[j]) * 0.5f;  // exact x2 grid decode
    } else {
      c[j] = v.v[j];
    }
  }
}

template <int VPT>
__device__ __forceinline__ void load_row(const float* p, float (&r)[VPT]) {
  const Vec<float, VPT> v = *reinterpret_cast<const Vec<float, VPT>*>(p);
#pragma unroll
  for (int j = 0; j < VPT; ++j) r[j] = v.v[j];
}

template <int VPT>
__device__ __forceinline__ void store_row(float* p, const float (&r)[VPT]) {
  Vec<float, VPT> v;
#pragma unroll
  for (int j = 0; j < VPT; ++j) v.v[j] = r[j];
  *reinterpret_cast<Vec<float, VPT>*>(p) = v;
}

template <int VPT>
__device__ __forceinline__ void add_row(float* p, const float (&r)[VPT]) {
  if constexpr (VPT == 1) {
    atomicAdd(p, r[0]);
  } else if constexpr (VPT == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(r[0], r[1]));
  } else {
#pragma unroll
    for (int j = 0; j < VPT; j += 4) {
      atomicAdd(reinterpret_cast<float4*>(p + j),
                make_float4(r[j], r[j + 1], r[j + 2], r[j + 3]));
    }
  }
}

// Min over the warp of non-negative floats: their bit patterns order like
// unsigned integers, so one redux instruction does it. L, the init rows and
// the costs are all >= 0 (x + 0.0f maps a -0.0 to +0.0).
__device__ __forceinline__ float warp_min_nonneg(float v) {
  return __uint_as_float(__reduce_min_sync(kFull, __float_as_uint(v + 0.0f)));
}

template <int VPT, typename CostT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sgm_paths_kernel(const CostT* __restrict__ cost, const float* __restrict__ init,
                 const int32_t* __restrict__ lines, int n_lines, Dirs dirs,
                 int n_dirs, int H, int W, int Dp, int D, float p1, float p2,
                 int64_t init_batch_stride, float* __restrict__ S,
                 float* __restrict__ carry) {
  const int lane = threadIdx.x & 31;
  const int line = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (line >= n_lines) return;
  const int64_t b = blockIdx.y;
  const int32_t* ln = lines + kLineCols * line;
  const int dir = ln[0];
  int y = ln[1];
  int x = ln[2];
  const int len = ln[3];
  const int init_x = ln[4];
  const int dy = dirs.dy[dir];
  const int dx = dirs.dx[dir];
  const int y_last = dy > 0 ? H - 1 : 0;
  const int d0 = lane * VPT;
  const bool lane_live = d0 < D;

  const int64_t plane = static_cast<int64_t>(H) * W * Dp;
  cost += b * plane;
  S += b * plane;
  const int64_t row = static_cast<int64_t>(W) * Dp;
  carry += b * n_dirs * row + dir * row + d0;
  init += b * init_batch_stride + dir * row + d0;

  float pr[VPT];
  if (init_x >= 0 && lane_live) {
    load_row<VPT>(init + static_cast<int64_t>(init_x) * Dp, pr);
  } else {
#pragma unroll
    for (int j = 0; j < VPT; ++j) pr[j] = kBig;
  }
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    if (d0 + j >= D) pr[j] = kBig;
  }

  int64_t off = (static_cast<int64_t>(y) * W + x) * Dp + d0;
  const int64_t step = (static_cast<int64_t>(dy) * W + dx) * Dp;
  float c[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) c[j] = 0.0f;
  if (lane_live) load_cost<VPT>(cost + off, c);

  for (int t = 0; t < len; ++t) {
    float cn[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) cn[j] = 0.0f;
    if (t + 1 < len && lane_live) load_cost<VPT>(cost + off + step, cn);

    float m = pr[0];
#pragma unroll
    for (int j = 1; j < VPT; ++j) m = fminf(m, pr[j]);
    m = warp_min_nonneg(m);
    float left = __shfl_up_sync(kFull, pr[VPT - 1], 1);
    float right = __shfl_down_sync(kFull, pr[0], 1);
    if (lane == 0) left = kBig;
    if (lane == 31) right = kBig;

    float L[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const float dm = j > 0 ? pr[j - 1] : left;
      const float dp = j < VPT - 1 ? pr[j + 1] : right;
      float cand = fminf(pr[j], fminf(dm, dp) + p1);
      cand = fminf(cand, m + p2);
      L[j] = d0 + j < D ? (c[j] + cand) - m : kBig;
    }
    if (lane_live) {
      add_row<VPT>(S + off, L);
      if (dy != 0 && y == y_last) {
        store_row<VPT>(carry + static_cast<int64_t>(x) * Dp, L);
      }
    }
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      pr[j] = L[j];
      c[j] = cn[j];
    }
    off += step;
    y += dy;
    x += dx;
  }
}

int64_t prod(ffi::Span<const int64_t> dims, size_t begin, size_t end) {
  int64_t p = 1;
  for (size_t i = begin; i < end; ++i) p *= dims[i];
  return p;
}

template <int VPT, typename CostT>
cudaError_t launch(cudaStream_t stream, const void* cost, const float* init,
                   const int32_t* lines, int n_lines, const Dirs& dirs,
                   int n_dirs, int64_t batch, int H, int W, int Dp, int D,
                   float p1, float p2, int64_t init_batch_stride, float* S,
                   float* carry) {
  const dim3 grid((n_lines + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  static_cast<unsigned>(batch));
  sgm_paths_kernel<VPT, CostT><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const CostT*>(cost), init, lines, n_lines, dirs, n_dirs, H,
      W, Dp, D, p1, p2, init_batch_stride, S, carry);
  return cudaGetLastError();
}

template <typename CostT>
cudaError_t dispatch_vpt(int vpt, cudaStream_t stream, const void* cost,
                         const float* init, const int32_t* lines, int n_lines,
                         const Dirs& dirs, int n_dirs, int64_t batch, int H,
                         int W, int Dp, int D, float p1, float p2,
                         int64_t init_batch_stride, float* S, float* carry) {
#define OPENVO_SGM_CASE(V)                                                   \
  case V:                                                                    \
    return launch<V, CostT>(stream, cost, init, lines, n_lines, dirs,        \
                            n_dirs, batch, H, W, Dp, D, p1, p2,              \
                            init_batch_stride, S, carry);
  switch (vpt) {
    OPENVO_SGM_CASE(1)
    OPENVO_SGM_CASE(2)
    OPENVO_SGM_CASE(4)
    OPENVO_SGM_CASE(8)
    OPENVO_SGM_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef OPENVO_SGM_CASE
}

ffi::Error SgmPathsImpl(cudaStream_t stream, ffi::AnyBuffer cost,
                        ffi::Buffer<ffi::F32> init,
                        ffi::Buffer<ffi::S32> lines,
                        ffi::Span<const int32_t> dir_pairs, int32_t num_disp,
                        float p1, float p2,
                        ffi::Result<ffi::Buffer<ffi::F32>> S,
                        ffi::Result<ffi::Buffer<ffi::F32>> carry) {
  const auto cd = cost.dimensions();
  const auto id = init.dimensions();
  const auto ld = lines.dimensions();
  if (cd.size() < 3 || id.size() < 3 || ld.size() < 2) {
    return ffi::Error::InvalidArgument("sgm_paths: bad ranks");
  }
  const size_t cr = cd.size();
  const int H = static_cast<int>(cd[cr - 3]);
  const int W = static_cast<int>(cd[cr - 2]);
  const int Dp = static_cast<int>(cd[cr - 1]);
  const int64_t batch = prod(cd, 0, cr - 3);
  const int n_dirs = static_cast<int>(dir_pairs.size() / 2);
  const size_t ir = id.size();
  const int64_t init_batch = prod(id, 0, ir - 3);
  const int n_lines = static_cast<int>(ld[ld.size() - 2]);
  if (n_dirs < 1 || n_dirs > kMaxDirs || id[ir - 3] != n_dirs ||
      id[ir - 2] != W || id[ir - 1] != Dp || ld[ld.size() - 1] != kLineCols ||
      prod(ld, 0, ld.size() - 2) != 1 ||
      (init_batch != 1 && init_batch != batch) || Dp % 16 != 0 ||
      num_disp < 1 || num_disp > Dp) {
    return ffi::Error::InvalidArgument("sgm_paths: inconsistent shapes");
  }
  int vpt = 1;
  while (32 * vpt < Dp) vpt *= 2;
  if (vpt > 16) {
    return ffi::Error::InvalidArgument("sgm_paths: more than 512 disparities");
  }
  Dirs dirs{};
  for (int i = 0; i < n_dirs; ++i) {
    dirs.dy[i] = dir_pairs[2 * i];
    dirs.dx[i] = dir_pairs[2 * i + 1];
  }
  const int64_t init_stride = init_batch == 1 ? 0 : n_dirs * int64_t{W} * Dp;

  cudaError_t err =
      cudaMemsetAsync(S->untyped_data(), 0, S->size_bytes(), stream);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(carry->untyped_data(), 0, carry->size_bytes(),
                          stream);
  }
  if (err == cudaSuccess && batch > 0 && n_lines > 0) {
    if (cost.element_type() == ffi::S16) {
      err = dispatch_vpt<int16_t>(vpt, stream, cost.untyped_data(),
                                  init.typed_data(), lines.typed_data(),
                                  n_lines, dirs, n_dirs, batch, H, W, Dp,
                                  num_disp, p1, p2, init_stride,
                                  S->typed_data(), carry->typed_data());
    } else if (cost.element_type() == ffi::F32) {
      err = dispatch_vpt<float>(vpt, stream, cost.untyped_data(),
                                init.typed_data(), lines.typed_data(), n_lines,
                                dirs, n_dirs, batch, H, W, Dp, num_disp, p1,
                                p2, init_stride, S->typed_data(),
                                carry->typed_data());
    } else {
      return ffi::Error::InvalidArgument("sgm_paths: cost must be s16 or f32");
    }
  }
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("sgm_paths: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SgmPaths, SgmPathsImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::AnyBuffer>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Attr<ffi::Span<const int32_t>>("dirs")
                                  .Attr<int32_t>("num_disp")
                                  .Attr<float>("p1")
                                  .Attr<float>("p2")
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>());
