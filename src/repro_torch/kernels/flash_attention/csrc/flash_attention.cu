// Hopper (sm_90a) kernels of the port's blocked (flash) attention.
//
// Built by kernels/build.py into a shared library with a plain C interface
// and called through ctypes from flash_attention.py.  Each launch function
// enqueues on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so that a refused launch raises in Python.
//
// ---------------------------------------------------------------------------
// flash_attention — replaces _fwd_kernel / flash_attention_bhsd
//   (src/repro/kernels/flash_attention/flash_attention.py:29).
//
//   Forward attention over (BH, S, d) with an online softmax: for each query
//   row, s = (q . k) * scale over the keys the mask lets through (kpos < S;
//   kpos <= qpos when causal; kpos > qpos - window with a window), masked
//   scores set to NEG_INF = -1e30 (not -inf), then per key tile
//     m_new = max(m, rowmax(s)); p = exp(s - m_new), zeroed where masked;
//     l = exp(m - m_new) * l + rowsum(p); acc = exp(m - m_new) * acc + p @ v,
//   and out = acc / max(l, 1e-30), rounded to the input dtype once.  Zeroing
//   p after the exp matters: on a tile that masks a whole row while m is
//   still -1e30, exp(0) = 1 would otherwise leak in.  A tile that the mask
//   hides entirely is skipped (its update would change nothing).
//
//   Bound: operations.  4*d per unmasked (query, key) pair (2*d for q . k,
//   2*d for p @ v) against 2*d bytes per row of q, k, v and out each, so a
//   long sequence is far above the ridge; the bound counts that work at
//   the bf16 tensor-core rate (989 TFLOP/s).
//
//   bf16 — flash_tc_kernel, on the tensor cores (FlashAttention-2's shape
//   on mma.sync.m16n8k16 bf16 with f32 accumulators):
//   * one block of 4 warps per (bh, 64-query tile), two or more blocks per
//     SM (up to 255 registers a thread), so that one block's barrier and
//     softmax overlap another's mma; query tiles of a head are scheduled
//     last-first so the long causal rows start early; each warp owns 16
//     query rows and keeps its Q fragment in registers (ldmatrix, once)
//     for the whole key loop;
//   * key tiles of 64: S = Q K^T by mma over the depth d padded with zeros
//     to DP, a multiple of 16 (80 stays 80, 120 becomes 128).  bf16 x bf16
//     products are exact in f32, so the scores are the reference's f32
//     scores up to the order of summation;
//   * the online softmax stays in the accumulator layout: each row's max
//     (of the raw q . k, whose order scale > 0 keeps) is reduced over the 4
//     lanes of a quad by shuffles, its sum is kept per lane and reduced
//     once at the end; p = 2^(s c - m c) with c = scale * log2(e), one FMA
//     and one ex2.approx each (relative error about 2^-22).  Only tiles
//     that straddle the causal diagonal, the window edge or the sequence
//     end evaluate the mask; a warp skips tiles that hide all of its rows;
//   * O += P V: the f32 accumulator fragment of two adjacent 8-key score
//     tiles is the bf16 A fragment of one 16-key product, so P never
//     touches shared memory.  P is split into p_hi = bf16(p) and p_lo =
//     bf16(p - p_hi), and both go through the mma against V (ldmatrix
//     .trans) into the same f32 accumulator: p_hi + p_lo carries p to about
//     2^-17, where one bf16 rounding (2^-9) would put an error of about
//     1e-3 x rms(out) on the output, against the reference's f32 p.  The
//     split costs 6*d tensor-core operations per pair instead of 4*d;
//   * K and V tiles come in through a 2-stage ring of 16-byte cp.async.cg
//     copies, so the next tile's copy overlaps this tile's mma; shared rows
//     are padded by 16 bytes (an odd number of 16-byte units), so ldmatrix
//     has no bank conflicts.  Shared memory: Q 64 x (DP + 8) plus 2 stages
//     of K and V, 64 x (DP + 8) each: 87,040 B at DP = 128.  Rows past S
//     and columns past d are zero-filled by the copy.  When d % 8 != 0 (or
//     a pointer is not 16-byte aligned) a row is not made of whole 16-byte
//     chunks, and the same kernel loads its tiles element by element.
//
//   f32 — flash_fwd_kernel, on the CUDA cores, exact to f32 (f32 products
//   on bf16 tensor cores would lose the reference's precision): one block
//   of 256 threads per (bh, 64-query tile); the block holds its Q tile
//   transposed in shared memory and loops over the key tiles the mask does
//   not hide: it stages K transposed and V, then each thread computes a
//   4-query x 4-key patch of the scores, reduces row max and row sum over
//   the 16 lanes that share its rows with shuffles, writes p transposed to
//   shared memory, and accumulates its 4 rows x (4 or 8) columns of acc in
//   registers.  V's rows are padded to a multiple of 4 with zeros.
//
//   Both take any 0 < d <= 128; above 48 KB of shared memory the launch
//   raises the kernel's dynamic limit first.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
using bf16 = __nv_bfloat16;

// ---- f32: CUDA cores -------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBQ = 64;            // queries per block
constexpr int kBK = 64;            // keys per tile
constexpr int kQTS = kBQ + 4;      // row stride of Qt and Pt (float4 rows)
constexpr int kKTS = kBK + 1;      // row stride of Kt (odd: conflict-free stores)

__host__ __device__ __forceinline__ int round4(int d) { return (d + 3) & ~3; }

// shared memory: Qt [d][kQTS], Pt [kBK][kQTS], Vs [kBK][round4(d)], Kt [d][kKTS]
__host__ __device__ __forceinline__ size_t smem_floats(int d) {
  return static_cast<size_t>(d) * kQTS + static_cast<size_t>(kBK) * kQTS +
         static_cast<size_t>(kBK) * round4(d) + static_cast<size_t>(d) * kKTS;
}

// NJ4: float4 column groups of acc per thread (1 for d <= 64, 2 up to 128)
template <int NJ4>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int S, int d,
                 int causal, int window, float scale, int n_qt) {
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
    Qt[c * kQTS + r] = q0 + r < S ? q[base + static_cast<size_t>(q0 + r) * d + c] : 0.f;
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
      Kt[c * kKTS + r] = k0 + r < S ? k[base + static_cast<size_t>(k0 + r) * d + c] : 0.f;
    }
    for (int idx = threadIdx.x; idx < kBK * VS; idx += kThreads) {
      const int r = idx / VS, c = idx - r * VS;
      Vs[idx] = (k0 + r < S && c < d) ? v[base + static_cast<size_t>(k0 + r) * d + c] : 0.f;
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
    float* orow = out + base + static_cast<size_t>(row) * d;
#pragma unroll
    for (int g = 0; g < NJ4; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 64 * g + e;
        if (col < d) orow[col] = acc[i][4 * g + e] / denom;
      }
  }
}

template <int NJ4>
int launch_f32(const void* q, const void* k, const void* v, void* out, int bh, int S, int d,
               int causal, int window, float scale, cudaStream_t st) {
  const size_t bytes = smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<NJ4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (S + kBQ - 1) / kBQ;
  flash_fwd_kernel<NJ4><<<bh * n_qt, kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, d, causal, window, scale,
      n_qt);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16: tensor cores ----------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcBQ = 16 * kTcWarps;   // queries per block, 16 per warp
constexpr int kTcBlocksPerSM = 2;      // one block's barrier and softmax overlap the other's mma
constexpr int kTcBK = 64;              // keys per tile: 8 mma n-tiles
constexpr int kTcPad = 8;              // bf16 of padding per shared row (16 B)

// NK = DP / 16: the padded depth in 16-wide mma k-steps
template <int NK>
struct TcShape {
  static constexpr int DP = 16 * NK;
  static constexpr int STRIDE = DP + kTcPad;                  // bf16 per shared row
  static constexpr int CHUNKS = DP / 8;                       // 16-B chunks per row
  static constexpr size_t BYTES = sizeof(bf16) * (kTcBQ + 4 * kTcBK) * STRIDE;
};

// 2^x on the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to 0, as a softmax weight that small adds nothing)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy; src_bytes = 0 zero-fills the destination and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) -> hi = bf16(x), lo = bf16(x - hi), x0 in the low half of each
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h)));
}

// rows [r0, r0 + rows) of one head's (S, d) matrix into a shared tile of
// TcShape<NK>::STRIDE per row, zero past S and past d: 16-byte cp.async
// copies when `vec`, else element by element (synchronous)
template <int NK>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src, int r0,
                                          int rows, int S, int d, bool vec) {
  using Sh = TcShape<NK>;
  if (vec) {
    for (int idx = threadIdx.x; idx < rows * Sh::CHUNKS; idx += kTcThreads) {
      const int r = idx / Sh::CHUNKS, col = 8 * (idx - r * Sh::CHUNKS);
      const bool ok = r0 + r < S && col < d;
      cp_async16(dst + r * Sh::STRIDE + col,
                 ok ? src + static_cast<size_t>(r0 + r) * d + col : src, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * Sh::DP; idx += kTcThreads) {
      const int r = idx / Sh::DP, col = idx - r * Sh::DP;
      dst[r * Sh::STRIDE + col] = r0 + r < S && col < d
                                      ? src[static_cast<size_t>(r0 + r) * d + col]
                                      : __float2bfloat16_rn(0.f);
    }
  }
}

template <int NK>
__global__ void __launch_bounds__(kTcThreads, kTcBlocksPerSM)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int S, int d, int causal,
                int window, float scale_log2, int n_qt, int vec) {
  using Sh = TcShape<NK>;
  constexpr int ST = Sh::STRIDE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = Qs + kTcBQ * ST;   // stage s: K at ring + 2 s kTcBK ST, V after it

  const int bh = blockIdx.x / n_qt;
  const int qt = n_qt - 1 - (blockIdx.x - bh * n_qt);
  const int q0 = qt * kTcBQ;
  const size_t base = static_cast<size_t>(bh) * S * d;
  const bf16* qh = q + base;
  const bf16* kh = k + base;
  const bf16* vh = v + base;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;   // mma fragment row group, lane in the quad
  const int wq0 = q0 + 16 * warp;            // the warp's first query

  // key tiles some query of this block can see
  const int k_end = causal ? min(S, q0 + kTcBQ) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_lo = k_begin / kTcBK;
  const int kt_hi = (k_end + kTcBK - 1) / kTcBK;

  load_tile<NK>(Qs, qh, q0, kTcBQ, S, d, vec);
  if (kt_lo < kt_hi) {
    load_tile<NK>(ring, kh, kt_lo * kTcBK, kTcBK, S, d, vec);
    load_tile<NK>(ring + kTcBK * ST, vh, kt_lo * kTcBK, kTcBK, S, d, vec);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // the warp's Q fragment (16 rows x DP), A operand of every S = Q K^T step
  uint32_t qf[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    ldsm_x4(qf[kk], Qs + (16 * warp + (lane & 15)) * ST + 16 * kk + 8 * (lane >> 4));

  float o[2 * NK][4];   // O: 16 rows x DP, 8 columns per n-tile
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};   // rows g and g + 8, in units of the raw q . k
  float l[2] = {0.f, 0.f};           // this lane's part of the row sums

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kTcBK;
    const bf16* Ks = ring + 2 * ((kt - kt_lo) & 1) * kTcBK * ST;
    const bf16* Vs = Ks + kTcBK * ST;
    if (kt + 1 < kt_hi) {   // the next tile into the other stage, read at kt - 1
      bf16* nxt = ring + 2 * ((kt + 1 - kt_lo) & 1) * kTcBK * ST;
      load_tile<NK>(nxt, kh, k0 + kTcBK, kTcBK, S, d, vec);
      load_tile<NK>(nxt + kTcBK * ST, vh, k0 + kTcBK, kTcBK, S, d, vec);
      cp_async_commit();
    }

    const bool hidden = wq0 >= S || (causal && k0 > wq0 + 15) ||
                        (window > 0 && k0 + kTcBK - 1 <= wq0 - window);
    if (!hidden) {
      // S = Q K^T: 8 n-tiles of 8 keys; ldmatrix.x4 gives two n-tiles' B
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldsm_x4(b, Ks + (16 * np + (lane & 7) + 8 * (lane >> 4)) * ST + 16 * kk +
                         8 * ((lane >> 3) & 1));
          mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
          mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
        }
      }

      // raw scores (scale > 0 keeps their order), the mask only where the
      // tile straddles its edges; s[j][e]: row g + 8 (e >> 1), key
      // k0 + 8 j + 2 tig + (e & 1)
      const bool full = k0 + kTcBK <= S && (!causal || k0 + kTcBK - 1 <= wq0) &&
                        (window <= 0 || k0 > wq0 + 15 - window);
      uint32_t hid = 0;   // bit 4 j + e: s[j][e] is masked
      if (!full) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * j + 2 * tig + (e & 1);
            const int qpos = wq0 + g + 8 * (e >> 1);
            const bool ok = kpos < S && (!causal || kpos <= qpos) &&
                            (window <= 0 || kpos > qpos - window);
            if (!ok) {
              s[j][e] = kNegInf;
              hid |= 1u << (4 * j + e);
            }
          }
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      float corr[2], ms[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        corr[h] = ex2((m[h] - m_new) * scale_log2);
        m[h] = m_new;
        ms[h] = m_new * scale_log2;
      }
      // p = exp(scale s - scale m) = 2^(s scale log2(e) - m scale log2(e)),
      // zeroed where masked
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = ex2(fmaf(s[j][e], scale_log2, -ms[e >> 1]));
      if (hid) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if ((hid >> (4 * j + e)) & 1u) s[j][e] = 0.f;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) rs[e >> 1] += s[j][e];
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = corr[h] * l[h] + rs[h];
#pragma unroll
      for (int n = 0; n < 2 * NK; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }

      // O += P V, 16 keys a step: score n-tiles 2 kj and 2 kj + 1 are the
      // A fragment; V's B fragments from ldmatrix.trans, two d n-tiles each
#pragma unroll
      for (int kj = 0; kj < 4; ++kj) {
        uint32_t hi[4], lo[4];
        split_bf16x2(s[2 * kj][0], s[2 * kj][1], hi[0], lo[0]);
        split_bf16x2(s[2 * kj][2], s[2 * kj][3], hi[1], lo[1]);
        split_bf16x2(s[2 * kj + 1][0], s[2 * kj + 1][1], hi[2], lo[2]);
        split_bf16x2(s[2 * kj + 1][2], s[2 * kj + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int dp = 0; dp < NK; ++dp) {
          uint32_t b[4];
          ldsm_x4_trans(b, Vs + (16 * kj + (lane & 15)) * ST + 16 * dp + 8 * (lane >> 4));
          mma_bf16(o[2 * dp], hi, b[0], b[1]);
          mma_bf16(o[2 * dp + 1], hi, b[2], b[3]);
          mma_bf16(o[2 * dp], lo, b[0], b[1]);
          mma_bf16(o[2 * dp + 1], lo, b[2], b[3]);
        }
      }
    }

    // the next tile has landed (this thread's copies, then everyone's), and
    // every warp is done with this stage before it is refilled at kt + 1
    cp_async_wait_all();
    __syncthreads();
  }

  // out = acc / max(l, 1e-30): row sums over the quad, one rounding to bf16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = wq0 + g + 8 * h;
    if (row >= S) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    bf16* orow = out + base + static_cast<size_t>(row) * d;
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n) {
      const int col = 8 * n + 2 * tig;
      const float x0 = o[n][2 * h] / denom, x1 = o[n][2 * h + 1] / denom;
      if (col + 1 < d && (d & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < d) orow[col] = __float2bfloat16_rn(x0);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

template <int NK>
int launch_tc(const void* q, const void* k, const void* v, void* out, int bh, int S, int d,
              int causal, int window, float scale, cudaStream_t st) {
  const size_t bytes = TcShape<NK>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_tc_kernel<NK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (S + kTcBQ - 1) / kTcBQ;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const int vec = d % 8 == 0 && ptrs % 16 == 0;
  const float scale_log2 = static_cast<float>(scale * 1.4426950408889634);   // log2(e)
  flash_tc_kernel<NK><<<bh * n_qt, kTcThreads, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), S, d, causal, window, scale_log2, n_qt, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v, out: (bh, S, d) f32, contiguous; 0 < d <= 128;
// bh * ceil(S / 64) < 2^31; window <= 0 means none.
int flash_attention_forward(const void* q, const void* k, const void* v, void* out, int bh,
                            int S, int d, int causal, int window, float scale,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d > kMaxD || bh <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return round4(d) > 64 ? launch_f32<2>(q, k, v, out, bh, S, d, causal, window, scale, st)
                        : launch_f32<1>(q, k, v, out, bh, S, d, causal, window, scale, st);
}

// the dynamic shared memory flash_attention_forward_tc asks for at width d
int flash_attention_tc_smem_bytes(int d) {
  switch ((d + 15) / 16) {
    case 1: return static_cast<int>(TcShape<1>::BYTES);
    case 2: return static_cast<int>(TcShape<2>::BYTES);
    case 3: return static_cast<int>(TcShape<3>::BYTES);
    case 4: return static_cast<int>(TcShape<4>::BYTES);
    case 5: return static_cast<int>(TcShape<5>::BYTES);
    case 6: return static_cast<int>(TcShape<6>::BYTES);
    case 7: return static_cast<int>(TcShape<7>::BYTES);
    default: return static_cast<int>(TcShape<8>::BYTES);
  }
}

// the same on bf16 tensors, on the tensor cores
int flash_attention_forward_tc(const void* q, const void* k, const void* v, void* out, int bh,
                               int S, int d, int causal, int window, float scale,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d > kMaxD || bh <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch ((d + 15) / 16) {
    case 1: return launch_tc<1>(q, k, v, out, bh, S, d, causal, window, scale, st);
    case 2: return launch_tc<2>(q, k, v, out, bh, S, d, causal, window, scale, st);
    case 3: return launch_tc<3>(q, k, v, out, bh, S, d, causal, window, scale, st);
    case 4: return launch_tc<4>(q, k, v, out, bh, S, d, causal, window, scale, st);
    case 5: return launch_tc<5>(q, k, v, out, bh, S, d, causal, window, scale, st);
    case 6: return launch_tc<6>(q, k, v, out, bh, S, d, causal, window, scale, st);
    case 7: return launch_tc<7>(q, k, v, out, bh, S, d, causal, window, scale, st);
    default: return launch_tc<8>(q, k, v, out, bh, S, d, causal, window, scale, st);
  }
}

}  // extern "C"
