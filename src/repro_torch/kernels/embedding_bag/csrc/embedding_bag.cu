// Hopper (sm_90a) kernel of the port's embedding bag.
//
// Built by kernels/build.py into a shared library with a plain C interface
// and called through ctypes from embedding_bag.py.  The launch function
// enqueues on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so that a refused launch raises in Python.
//
// ---------------------------------------------------------------------------
// embedding_bag — replaces _bag_kernel / embedding_bag
//   (src/repro/kernels/embedding_bag/embedding_bag.py).
//
//   out[b] = sum over l of weights[b, l] * table[ids[b, l]]; a slot with a
//   negative id is skipped and an id >= V reads row V-1 (the JAX oracle's
//   gather clamps it).  The result is in the table's dtype, rounded as the
//   reference rounds it: per slot t = T(row * w), then o = T(o + t), slots
//   in order from l = 0.  The products and sums use __fmul_rn / __fadd_rn,
//   so no multiply-add is contracted and the kernel is bitwise equal to the
//   plain version (ref.embedding_bag_plain) on the card.
//
//   Bound: device-memory bytes.  Each valid slot gathers one D-wide table
//   row (256 B for MIND's 64 x f32) from anywhere in a table of gigabytes,
//   so nothing is reused; ids and weights stream once and out is written
//   once.  The work is two float operations per gathered element.
//
//   Design: one warp per bag (the TPU kernel revisited the bag's output row
//   over a sequential grid of slots).  Lane i owns the columns
//   [VEC*(i + 32*c), +VEC) for c < NC, kept in f32 registers and loaded as
//   one vector of VEC elements: 16 B, or 8 B where D is narrower than 32
//   lanes of 16 B, so that every lane has work (MIND's D = 64 f32 runs 32
//   lanes of 2 floats; on an H100, 16 lanes of 4 took 0.915 ms in place of
//   0.652 ms on its serve_bulk batch).  D is a multiple of VEC, NC = ceil(D / (32 *
//   VEC)) <= 4.  The lanes load 32 slots' ids
//   and weights at a time and broadcast them by shuffle; the rows of kUnroll
//   slots are loaded before any of them is added, so several gathers are in
//   flight per warp, and are then added in slot order.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;
enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// round a float to T and back (identity for f32)
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC, int NC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
bag_kernel(const int* __restrict__ ids, const float* __restrict__ weights,
           const T* __restrict__ table, T* __restrict__ out, int B, int L, long long V,
           int D) {
  using VT = Vec<T, VEC>;
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // whole warps leave together
  const int* bid = ids + b * L;
  const float* bw = weights + b * L;

  float acc[NC][VEC];
  bool live[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    live[c] = (c * 32 + lane) * VEC < D;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[c][e] = 0.f;
  }

  for (int l0 = 0; l0 < L; l0 += 32) {
    const int n = min(32, L - l0);
    int my_id = -1;
    float my_w = 0.f;
    if (lane < n) {
      my_id = bid[l0 + lane];
      my_w = bw[l0 + lane];
    }
    for (int u0 = 0; u0 < n; u0 += kUnroll) {
      VT r[kUnroll][NC];
      int id[kUnroll];
      float wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // u0 + u < 32: u0 < n <= 32 and u0 is a multiple of kUnroll
        id[u] = __shfl_sync(kFull, my_id, u0 + u);
        wv[u] = __shfl_sync(kFull, my_w, u0 + u);
        if (u0 + u >= n) id[u] = -1;
        if (id[u] >= 0) {
          const long long row = id[u] < V ? id[u] : V - 1;
          const VT* p = reinterpret_cast<const VT*>(table + row * D);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            if (live[c]) r[u][c] = p[c * 32 + lane];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (id[u] < 0) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          if (!live[c]) continue;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const float t = round_to<T>(__fmul_rn(to_f(r[u][c].v[e]), wv[u]));
            acc[c][e] = round_to<T>(__fadd_rn(acc[c][e], t));
          }
        }
      }
    }
  }

  T* o = out + b * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (!live[c]) continue;
    VT res;
#pragma unroll
    for (int e = 0; e < VEC; ++e) res.v[e] = from_f<T>(acc[c][e]);
    reinterpret_cast<VT*>(o)[c * 32 + lane] = res;
  }
}

template <typename T, int VEC, int NC>
int launch(const void* ids, const void* weights, const void* table, void* out, int B, int L,
           long long V, int D, cudaStream_t st) {
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  bag_kernel<T, VEC, NC><<<blocks, kWarpsPerBlock * 32, 0, st>>>(
      static_cast<const int*>(ids), static_cast<const float*>(weights),
      static_cast<const T*>(table), static_cast<T*>(out), B, L, V, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_nc(int nc, const void* ids, const void* weights, const void* table, void* out, int B,
              int L, long long V, int D, cudaStream_t st) {
  switch (nc) {
    case 1: return launch<T, VEC, 1>(ids, weights, table, out, B, L, V, D, st);
    case 2: return launch<T, VEC, 2>(ids, weights, table, out, B, L, V, D, st);
    case 3: return launch<T, VEC, 3>(ids, weights, table, out, B, L, V, D, st);
    case 4: return launch<T, VEC, 4>(ids, weights, table, out, B, L, V, D, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_vec(const void* ids, const void* weights, const void* table, void* out, int B, int L,
               long long V, int D, int vec_bytes, cudaStream_t st) {
  constexpr int kWide = 16 / sizeof(T), kNarrow = 8 / sizeof(T);
  if (vec_bytes == 16)
    return launch_nc<T, kWide>((D + 32 * kWide - 1) / (32 * kWide), ids, weights, table, out, B,
                               L, V, D, st);
  if (vec_bytes == 8)
    return launch_nc<T, kNarrow>((D + 32 * kNarrow - 1) / (32 * kNarrow), ids, weights, table,
                                 out, B, L, V, D, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ids: (B, L) int32; weights: (B, L) f32; table: (V, D) of `dtype`
// (DT_F32 / DT_BF16); out: (B, D) of `dtype`.  Each lane loads vectors of
// `vec_bytes` (8 or 16); D is a multiple of that vector and at most 4
// warp-wide vectors; table and out are aligned to it (the wrapper checks).
// B, L > 0.
int embedding_bag_forward(const void* ids, const void* weights, const void* table, void* out,
                          int B, int L, long long V, int D, int dtype, int vec_bytes,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch_vec<float>(ids, weights, table, out, B, L, V, D, vec_bytes, st);
  if (dtype == DT_BF16)
    return launch_vec<__nv_bfloat16>(ids, weights, table, out, B, L, V, D, vec_bytes, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
