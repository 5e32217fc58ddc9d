// Hopper (sm_90a) kernel of the port's blocked (flash) attention.
//
// Built by kernels/build.py into a shared library with a plain C interface
// and called through ctypes from flash_attention.py.  The launch function
// enqueues on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so that a refused launch raises in Python.
//
// ---------------------------------------------------------------------------
// flash_attention — replaces _fwd_kernel / flash_attention_bhsd
//   (src/repro/kernels/flash_attention/flash_attention.py).
//
//   Forward attention over (BH, S, d) with an online softmax: for each query
//   row, s = (q . k) * scale over the keys the mask lets through (kpos < S;
//   kpos <= qpos when causal; kpos > qpos - window with a window), masked
//   scores set to NEG_INF = -1e30 (not -inf), then per key tile
//     m_new = max(m, rowmax(s)); p = exp(s - m_new), zeroed where masked;
//     l = exp(m - m_new) * l + rowsum(p); acc = exp(m - m_new) * acc + p @ v,
//   and out = acc / max(l, 1e-30), rounded to the input dtype once.  The
//   inputs are read as f32 and everything is computed in f32.  Zeroing p
//   after the exp matters: on a tile that masks a whole row while m is
//   still -1e30, exp(0) = 1 would otherwise leak in.  A tile that the mask
//   hides entirely is skipped (its update would change nothing).
//
//   Tiling: the JAX kernel's block_q / block_k set its grid; this kernel
//   tiles 64 queries x 64 keys whatever they are (the wrapper keeps them in
//   its signature for the plain version, which follows them).  Within a key
//   tile the kernel adds p * v key by key into acc, after scaling acc, where
//   the reference adds the tile's whole p @ v; the two agree to rounding.
//
//   Bound: operations.  4*d operations per unmasked (query, key) pair
//   against 2*d bytes per row of q, k, v and out each (bf16), so a long
//   sequence is far above the ridge.  Counted at the route this work could
//   take, bf16 on the tensor cores (989 TFLOP/s), this kernel is far from
//   it: it runs f32 FMAs on the CUDA cores, simple and exact to f32.
//   wgmma / mma.sync on bf16 tiles is the redesign.
//
//   Design: one block of 256 threads per (bh, 64-query tile), query tiles
//   of a head scheduled last-first so the long causal rows start early.
//   The block holds its Q tile transposed in shared memory (f32) and loops
//   over the key tiles the mask does not hide: it stages K transposed and V
//   (f32), then each thread computes a 4-query x 4-key patch of the scores
//   (queries 4*ty.., read as one float4; keys tx + 16*j), reduces row max
//   and row sum over the 16 lanes that share its rows with shuffles, writes
//   p transposed to shared memory, and accumulates its 4 rows x (4 or 8)
//   columns of acc (V read as float4) in registers.  d may be any value up
//   to 128; V's rows are padded to a multiple of 4 with zeros.  Above 48 KB
//   of shared memory the launch raises the kernel's dynamic limit first.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;            // queries per block
constexpr int kBK = 64;            // keys per tile
constexpr int kQTS = kBQ + 4;      // row stride of Qt and Pt (float4 rows)
constexpr int kKTS = kBK + 1;      // row stride of Kt (odd: conflict-free stores)
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__host__ __device__ __forceinline__ int round4(int d) { return (d + 3) & ~3; }

// shared memory: Qt [d][kQTS], Pt [kBK][kQTS], Vs [kBK][round4(d)], Kt [d][kKTS]
__host__ __device__ __forceinline__ size_t smem_floats(int d) {
  return static_cast<size_t>(d) * kQTS + static_cast<size_t>(kBK) * kQTS +
         static_cast<size_t>(kBK) * round4(d) + static_cast<size_t>(d) * kKTS;
}

// NJ4: float4 column groups of acc per thread (1 for d <= 64, 2 up to 128)
template <typename T, int NJ4>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int S, int d, int causal, int window, float scale,
                 int n_qt) {
  extern __shared__ __align__(16) float smem[];
  const int VS = round4(d);
  float* Qt = smem;                 // Qt[kk][row]
  float* Pt = Qt + d * kQTS;        // Pt[key][row]
  float* Vs = Pt + kBK * kQTS;      // Vs[key][col]
  float* Kt = Vs + kBK * VS;        // Kt[kk][key]

  const int bh = blockIdx.x / n_qt;
  const int qt = n_qt - 1 - (blockIdx.x - bh * n_qt);
  const int q0 = qt * kBQ;
  const size_t base = static_cast<size_t>(bh) * S * d;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  for (int idx = threadIdx.x; idx < kBQ * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    Qt[c * kQTS + r] = q0 + r < S ? to_f(q[base + static_cast<size_t>(q0 + r) * d + c]) : 0.f;
  }

  float m[4], l[4], acc[4][4 * NJ4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NJ4; ++j) acc[i][j] = 0.f;
  }

  // key tiles some query of this tile can see
  const int k_end = causal ? min(S, q0 + kBQ) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_hi = (k_end + kBK - 1) / kBK;

  for (int kt = k_begin / kBK; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's Kt / Vs / Pt are read
    for (int idx = threadIdx.x; idx < kBK * d; idx += kThreads) {
      const int r = idx / d, c = idx - r * d;
      Kt[c * kKTS + r] = k0 + r < S ? to_f(k[base + static_cast<size_t>(k0 + r) * d + c]) : 0.f;
    }
    for (int idx = threadIdx.x; idx < kBK * VS; idx += kThreads) {
      const int r = idx / VS, c = idx - r * VS;
      Vs[idx] = (k0 + r < S && c < d) ? to_f(v[base + static_cast<size_t>(k0 + r) * d + c])
                                       : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < d; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[kk * kQTS + 4 * ty]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Kt[kk * kKTS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], b[j], s[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < S && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(kFull, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = corr * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * NJ4; ++j) acc[i][j] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx + 16 * j) * kQTS + 4 * ty]) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < kBK; ++key) {
      const float4 pp = *reinterpret_cast<const float4*>(&Pt[key * kQTS + 4 * ty]);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int g = 0; g < NJ4; ++g) {
        const int col = 4 * tx + 64 * g;
        if (col >= VS) continue;
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[key * VS + col]);
        const float vf[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][4 * g + e] = fmaf(pv[i], vf[e], acc[i][4 * g + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = out + base + static_cast<size_t>(row) * d;
#pragma unroll
    for (int g = 0; g < NJ4; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 64 * g + e;
        if (col < d) orow[col] = from_f<T>(acc[i][4 * g + e] / denom);
      }
  }
}

template <typename T, int NJ4>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int S, int d,
           int causal, int window, float scale, cudaStream_t st) {
  const size_t bytes = smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, NJ4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (S + kBQ - 1) / kBQ;
  flash_fwd_kernel<T, NJ4><<<bh * n_qt, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, d, causal, window, scale, n_qt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v, out: (bh, S, d) of `dtype` (DT_F32 / DT_BF16), contiguous;
// 0 < d <= 128; bh * ceil(S / 64) < 2^31; window <= 0 means none.
int flash_attention_forward(const void* q, const void* k, const void* v, void* out, int bh,
                            int S, int d, int causal, int window, float scale, int dtype,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d > kMaxD || bh <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = round4(d) > 64;
  using bf = __nv_bfloat16;
  if (dtype == DT_F32)
    return wide ? launch<float, 2>(q, k, v, out, bh, S, d, causal, window, scale, st)
                : launch<float, 1>(q, k, v, out, bh, S, d, causal, window, scale, st);
  if (dtype == DT_BF16)
    return wide ? launch<bf, 2>(q, k, v, out, bh, S, d, causal, window, scale, st)
                : launch<bf, 1>(q, k, v, out, bh, S, d, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
