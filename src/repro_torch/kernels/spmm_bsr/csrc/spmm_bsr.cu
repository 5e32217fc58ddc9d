// Hopper (sm_90a) kernel of the port's block-sparse SpMM.
//
// Built by kernels/build.py into a shared library with a plain C interface
// and called through ctypes from spmm_bsr.py.  The launch function
// enqueues on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so that a refused launch raises in Python.
//
// ---------------------------------------------------------------------------
// spmm_bsr — replaces _spmm_kernel / spmm_bsr
//   (src/repro/kernels/spmm_bsr/spmm_bsr.py).
//
//   Block-ELL SpMM: out[r] = sum over slots j of blocks[r, j] @ X[indices[r, j]],
//   where out[r] is the r-th bm-row block of the (R*bm, F) output and X[c]
//   the c-th bk-row block of x.  A slot whose index is negative (-1 is the
//   padding) or not below C = x.rows / bk is skipped.  blocks and x may be
//   f32 or bf16, each on its own; out takes x's dtype.
//
//   Rounding is the reference's: each block's product is summed in f32,
//   rounded to out's dtype, and added into the output row block, which is
//   rounded again (`o_ref[0] += dot(a, x).astype(o.dtype)`).  Under bf16
//   that rounds twice per block; under f32 the block sums are added in f32.
//   The plain version (ref.spmm_bsr_plain) rounds at the same places; the
//   sum inside a block runs over the depth in order here, in the library's
//   order there, so the two agree to a tolerance, not bitwise.
//
//   Bound: operations.  Each non-padding block costs 2*bm*bk*F operations
//   against bm*bk*4 bytes of its own (64 per byte at F = 128 in f32), well
//   above the card's f32 ridge of 67 TFLOP/s over 3.35 TB/s = 20 per byte.
//   They run as f32 FMAs outside the tensor cores, so that f32 stays f32;
//   TF32 or bf16 tensor-core products are a later redesign.
//
//   Design: one block per (row block r, 64-column tile of F); the TPU
//   kernel's sequential grid over the K slots becomes a loop inside the
//   block, which reads each slot's index itself (the TPU prefetched them as
//   scalars).  Per slot, the block stages 32-deep chunks of the adjacency
//   block (transposed, f32) and of the gathered X tile in shared memory;
//   each of 256 threads owns an 8-row x 4-column patch of the output,
//   reads both operands as float4, and keeps the block's partial sum and
//   the output row block in registers.  The tiles of one row block are
//   neighbours in the grid, so the second reads the adjacency block from L2.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFT = 64;       // output columns per block
constexpr int kKC = 32;       // depth of one staged chunk
constexpr int kMaxBM = 128;   // rows of an adjacency block the kernel takes
constexpr int kATS = kMaxBM + 4;  // row stride of the transposed chunk (float4 rows)
enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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

template <typename TA, typename TX>
__global__ void __launch_bounds__(kThreads)
spmm_kernel(const int* __restrict__ indices, const TA* __restrict__ blocks,
            const TX* __restrict__ x, TX* __restrict__ out, int K, int bm, int bk, int C,
            int F, int nft) {
  __shared__ __align__(16) float At[kKC * kATS];  // At[kk][row]
  __shared__ __align__(16) float Xs[kKC * kFT];   // Xs[kk][col]
  const int r = blockIdx.x / nft;
  const int f0 = (blockIdx.x - r * nft) * kFT;
  const int tx = threadIdx.x & 15;   // columns 4*tx .. 4*tx+3
  const int ty = threadIdx.x >> 4;   // rows 8*ty .. 8*ty+7

  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;

  for (int slot = 0; slot < K; ++slot) {
    const int c = indices[static_cast<long long>(r) * K + slot];  // the same for every thread
    if (c < 0 || c >= C) continue;
    const TA* blk = blocks + (static_cast<long long>(r) * K + slot) * bm * bk;
    const TX* xb = x + static_cast<long long>(c) * bk * F;
    float p[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = 0.f;

    for (int k0 = 0; k0 < bk; k0 += kKC) {
      for (int idx = threadIdx.x; idx < kMaxBM * kKC; idx += kThreads) {
        const int row = idx / kKC, kk = idx - row * kKC;
        float a = 0.f;
        if (row < bm && k0 + kk < bk) a = to_f(blk[static_cast<long long>(row) * bk + k0 + kk]);
        At[kk * kATS + row] = a;
      }
      for (int idx = threadIdx.x; idx < kKC * kFT; idx += kThreads) {
        const int kk = idx / kFT, col = idx - kk * kFT;
        float v = 0.f;
        if (k0 + kk < bk && f0 + col < F)
          v = to_f(xb[static_cast<long long>(k0 + kk) * F + f0 + col]);
        Xs[idx] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&At[kk * kATS + 8 * ty]);
        const float4 a1 = *reinterpret_cast<const float4*>(&At[kk * kATS + 8 * ty + 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Xs[kk * kFT + 4 * tx]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) p[i][j] = fmaf(a[i], bb[j], p[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] = round_to<TX>(__fadd_rn(o[i][j], round_to<TX>(p[i][j])));
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = 8 * ty + i;
    if (row >= bm) continue;
    TX* orow = out + (static_cast<long long>(r) * bm + row) * F;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = f0 + 4 * tx + j;
      if (col < F) orow[col] = from_f<TX>(o[i][j]);
    }
  }
}

template <typename TA, typename TX>
int launch(const void* indices, const void* blocks, const void* x, void* out, int R, int K,
           int bm, int bk, int C, int F, cudaStream_t st) {
  const int nft = (F + kFT - 1) / kFT;
  spmm_kernel<TA, TX><<<R * nft, kThreads, 0, st>>>(
      static_cast<const int*>(indices), static_cast<const TA*>(blocks),
      static_cast<const TX*>(x), static_cast<TX*>(out), K, bm, bk, C, F, nft);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* spmm_bsr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// indices: (R, K) int32; blocks: (R, K, bm, bk) of blocks_dtype; x: (C*bk, F)
// of x_dtype; out: (R*bm, F) of x_dtype.  0 < bm <= 128; R, K, bk, F > 0.
int spmm_bsr_forward(const void* indices, const void* blocks, const void* x, void* out, int R,
                     int K, int bm, int bk, int C, int F, int blocks_dtype, int x_dtype,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm <= 0 || bm > kMaxBM) return static_cast<int>(cudaErrorInvalidValue);
  using bf = __nv_bfloat16;
  if (blocks_dtype == DT_F32 && x_dtype == DT_F32)
    return launch<float, float>(indices, blocks, x, out, R, K, bm, bk, C, F, st);
  if (blocks_dtype == DT_F32 && x_dtype == DT_BF16)
    return launch<float, bf>(indices, blocks, x, out, R, K, bm, bk, C, F, st);
  if (blocks_dtype == DT_BF16 && x_dtype == DT_F32)
    return launch<bf, float>(indices, blocks, x, out, R, K, bm, bk, C, F, st);
  if (blocks_dtype == DT_BF16 && x_dtype == DT_BF16)
    return launch<bf, bf>(indices, blocks, x, out, R, K, bm, bk, C, F, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
