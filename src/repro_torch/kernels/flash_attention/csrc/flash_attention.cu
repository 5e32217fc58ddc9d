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
//   the bf16 tensor-core rate (989 TFLOP/s), and in f32 as the split's
//   12*d per pair at the TF32 rate (495 TFLOP/s).
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
//   f32 — flash_f32_kernel, on the tensor cores in split TF32 (the layout
//   above, on mma.sync.m16n8k8 TF32 with f32 accumulators):
//   * every f32 operand x is split into hi = tf32(x) (round to nearest,
//     ties away, by two integer operations, as spmm_bsr.cu rounds) and
//     lo = x - hi, exact, truncated to TF32 by one AND (CUTLASS's
//     round-toward-zero conversion); each product is lo.hi + hi.lo + hi.hi
//     into one f32 accumulator, both for S = Q K^T and for O += P V.  hi.hi
//     is exact in f32 and the rest costs about 2^-21 of each term, so the
//     output keeps f32's accuracy to a few ulps (one TF32 product, 2^-11,
//     would miss the reference's 2e-5).  The split is the kernel's own:
//     torch's allow_tf32 plays no part.  The work is 12*d tensor-core
//     operations per unmasked pair against 4*d.
//   * the depth pads to DP = 8 ceil(d / 8) (120 stays 120).  The
//     instantiation fixes NKMAX, the 8-column tiles of O a thread holds (4,
//     8, 12 or 16); S = Q K^T runs DP / 8 k-steps, and P V runs all NKMAX
//     tiles, those past DP on the last tile's columns and never written: a
//     branch per tile there kept the scheduler from overlapping the tiles'
//     loads and products, and cost more than the spare ones.
//   * one block of 4 warps per (bh, 64-query tile, split), blocks ordered
//     by query tile, last first, across all heads (grouping the heads so
//     that their K and V stay in L2 delayed the long tiles of the later
//     groups, and was slower); each warp owns 16 query rows and its scores
//     stay in registers (8 n-tiles of a 64-key tile).  Q stays in shared
//     memory and is read by ldmatrix and split again at each k-step: in
//     registers, Q's hi and lo at DP = 128 would take 128 registers a
//     thread beside O's 64.  K's B fragments come by ldmatrix too (an f32
//     element is two b16 halves, so ldmatrix's non-transposed tiles are
//     TF32's A and B fragments).  Tiles the mask hides from a warp are
//     skipped, the mask is evaluated only on tiles that straddle an edge,
//     and the softmax is the bf16 kernel's (raw max, ex2).
//   * P never touches shared memory: the accumulator fragment of an 8-key
//     score n-tile holds keys (2 tig, 2 tig + 1) of rows (g, g + 8), and
//     the A fragment wants columns (tig, tig + 4).  Column tig is taken to
//     be key 2 tig and column tig + 4 key 2 tig + 1, so (c0, c2, c1, c3) is
//     the A fragment as it stands, and V's B fragment is read in the same
//     order: b0 = V[2 tig][g], b1 = V[2 tig + 1][g].  The sum over the 8
//     keys is the same sum.
//   * shared memory holds Q, one K and one V tile, 64 x (DP + 4) floats
//     each (101,376 B at DP = 128).  The + 4 makes every 32-bit fragment
//     load and every ldmatrix row conflict-free for any DP that is a
//     multiple of 8.  The copies are 16-byte cp.async.cg: V of a tile is in
//     flight while the block computes its scores, and K of the next tile
//     while it runs the softmax and P V, so two barriers a tile serve both
//     as "landed" and as "everyone is done with it".  With d % 4 != 0 or
//     an unaligned pointer the same kernel loads element by element,
//     synchronously.
//   * registers: O 4 NKMAX, the scores 32; two blocks an SM (three at
//     NKMAX 4; at 8 the cap of 170 registers spills), no spill in any
//     instantiation (-Xptxas -v; chip_smoke.py phase 2 prints them).
//   * split-KV: when bh x ceil(S / 64) blocks do not fill the card, the
//     wrapper (flash_attention.kv_splits) gives each query tile `splits`
//     blocks (at most 8), each over a contiguous share of its visible key
//     tiles, and the launch makes them one thread-block cluster.  Each
//     leaves its unnormalised (m, l, acc) in its shared memory; after a
//     cluster barrier each block merges a slice of the tile's rows from
//     all of them through distributed shared memory, out = sum(w acc) /
//     max(sum(w l), 1e-30) with w = 2^((m - max m) scale log2(e)), and a
//     second barrier keeps every block's shared memory until all have
//     read it.  An empty share leaves m = -1e30, l = 0, acc = 0, whose
//     weight is 0.  No scratch and no second launch: at the short shapes
//     that split, the host's allocation and launch cost more than the
//     kernel.
//
//   Both take any 0 < d <= 128; above 48 KB of shared memory the launch
//   raises the kernel's dynamic limit first.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
using bf16 = __nv_bfloat16;

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

// four 8 x 8 b16 matrices (an f32 element is two b16 halves)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
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

// ---- f32: split TF32 on the tensor cores -----------------------------------

constexpr int kF32Warps = 4;
constexpr int kF32Threads = 32 * kF32Warps;
constexpr int kF32BQ = 16 * kF32Warps;   // queries per block, 16 per warp
constexpr int kF32BK = 64;               // keys per tile: 8 mma n-tiles
constexpr int kF32Pad = 4;               // floats of padding per shared row (16 B)
constexpr int kMaxDevices = 64;          // devices whose shared memory limit is remembered
constexpr int kMaxSplits = 8;            // blocks of a cluster (the portable most)
static_assert(kF32BQ == kF32BK, "Q, K and V tiles have the same rows");

// floats per shared row at width d: the depth rounded up to 8, plus the pad
__host__ __device__ __forceinline__ int f32_stride(int d) { return ((d + 7) & ~7) + kF32Pad; }

// shared memory: the Q tile, one K and one V tile
__host__ __device__ __forceinline__ size_t f32_smem_bytes(int d) {
  return sizeof(float) * static_cast<size_t>(kF32BQ + 2 * kF32BK) * f32_stride(d);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cvt.rna.tf32.f32 in two integer operations, as spmm_bsr.cu rounds: half
// a TF32 ulp added to the magnitude, the 13 bits below TF32's mantissa
// cleared (round to nearest, ties away from zero)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// v -> hi = tf32(v) and lo = v - hi (exact) truncated to TF32 by one AND,
// as CUTLASS's round-toward-zero conversion truncates
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xFFFFE000u;
}

// c += a (16 x 8, row) * b (8 x 8, col), TF32 in, f32 accumulate; not
// volatile (registers only), so independent products may be interleaved
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in split TF32: lo.hi + hi.lo + hi.hi, the small terms first
__device__ __forceinline__ void mma_split(float (&c)[4], const uint32_t (&a_hi)[4],
                                          const uint32_t (&a_lo)[4], uint32_t b_hi0,
                                          uint32_t b_hi1, uint32_t b_lo0, uint32_t b_lo1) {
  mma_tf32(c, a_lo, b_hi0, b_hi1);
  mma_tf32(c, a_hi, b_lo0, b_lo1);
  mma_tf32(c, a_hi, b_hi0, b_hi1);
}

// This thread's share of a 64-row tile copy: a row of DP floats is `units`
// copies (16-byte chunks when vec, else floats); thread i copies unit
// i % units of rows i / units, i / units + step, ... (threads past step x
// units copy nothing)
struct TileCopy {
  int r, col, step;
  __device__ TileCopy(int dp, bool vec) {
    const int units = vec ? dp / 4 : dp;
    step = kF32Threads / units;
    r = threadIdx.x / units;
    col = (threadIdx.x - r * units) * (vec ? 4 : 1);
    if (r >= step) r = kF32BK;
  }
};

// rows [r0, r0 + 64) of one head's (S, d) matrix into a shared tile of ld
// floats a row, zero past S and past d: 16-byte cp.async copies when
// `vec`, else element by element (synchronous)
__device__ __forceinline__ void load_tile_f32(float* dst, const float* __restrict__ src, int r0,
                                              int S, int d, int ld, const TileCopy& tc,
                                              bool vec) {
  for (int r = tc.r; r < kF32BK; r += tc.step) {
    const bool ok = r0 + r < S && tc.col < d;
    const float* from = ok ? src + static_cast<size_t>(r0 + r) * d + tc.col : src;
    if (vec)
      cp_async16(dst + r * ld + tc.col, from, ok ? 16 : 0);
    else
      dst[r * ld + tc.col] = ok ? *from : 0.f;
  }
}

// NKMAX: the 8-column tiles of O a thread holds (4, 8, 12 or 16); S runs
// nk = ceil(d / 8) k-steps, P V all NKMAX tiles.  With splits > 1 the
// launch makes each query tile's `splits` blocks (consecutive) one cluster.
template <int NKMAX>
__global__ void __launch_bounds__(kF32Threads, NKMAX <= 4 ? 3 : 2)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int n_bh, int S,
                 int d, int causal, int window, float scale_log2, int n_qt, int splits,
                 int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nk = (d + 7) >> 3;
  const int ld = 8 * nk + kF32Pad;
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kF32BQ * ld;
  float* Vs = Ks + kF32BK * ld;

  // block -> (split, head, query tile), every head's last query tile first
  const int split = blockIdx.x % splits;
  const int rest = blockIdx.x / splits;
  const int bh = rest % n_bh;
  const int q0 = (n_qt - 1 - rest / n_bh) * kF32BQ;
  const size_t base = static_cast<size_t>(bh) * S * d;
  const float* qh = q + base;
  const float* kh = k + base;
  const float* vh = v + base;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;   // mma fragment row group, lane in the quad
  const int wq0 = q0 + 16 * warp;            // the warp's first query

  // the key tiles some query of this block can see, and this split's
  // contiguous share of them (flash_attention.split_ranges in Python)
  const int k_end = causal ? min(S, q0 + kF32BQ) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t0 = k_begin / kF32BK;
  const long long n_t = (k_end + kF32BK - 1) / kF32BK - t0;
  const int kt_lo = t0 + static_cast<int>(split * n_t / splits);
  const int kt_hi = t0 + static_cast<int>((split + 1) * n_t / splits);

  const TileCopy tc(8 * nk, vec);
  load_tile_f32(Qs, qh, q0, S, d, ld, tc, vec);
  if (kt_lo < kt_hi) load_tile_f32(Ks, kh, kt_lo * kF32BK, S, d, ld, tc, vec);
  cp_async_commit();
  if (kt_lo < kt_hi) load_tile_f32(Vs, vh, kt_lo * kF32BK, S, d, ld, tc, vec);
  cp_async_commit();
  cp_async_wait<1>();   // Q and the first K tile (this thread's copies), then everyone's
  __syncthreads();

  float o[NKMAX][4];   // O: 16 rows x 8 NKMAX, 8 columns per n-tile
#pragma unroll
  for (int n = 0; n < NKMAX; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};   // rows g and g + 8, in units of the raw q . k
  float l[2] = {0.f, 0.f};           // this lane's part of the row sums

  // ldmatrix rows: Q's A fragment (matrices 1 and 3 eight rows on, 2 and 3
  // four columns on) and two score n-tiles' B fragments of K (matrices 2
  // and 3 eight keys on, 1 and 3 four columns on); V's B fragment, rows
  // 2 tig and 2 tig + 1 of column g of each 8-key step
  const float* qa = Qs + (16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 4 * (lane >> 4);
  const float* kb = Ks + ((lane & 7) + 8 * (lane >> 4)) * ld + 4 * ((lane >> 3) & 1);
  const float* vb = Vs + 2 * tig * ld + g;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kF32BK;
    const bool hidden = wq0 >= S || (causal && k0 > wq0 + 15) ||
                        (window > 0 && k0 + kF32BK - 1 <= wq0 - window);
    float s[8][4];   // s[j][e]: row g + 8 (e >> 1), key k0 + 8 j + 2 tig + (e & 1)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if (!hidden) {
      // S = Q K^T, 8 deep a step
#pragma unroll 2
      for (int kk = 0; kk < nk; ++kk) {
        uint32_t a[4], a_hi[4], a_lo[4];
        ldsm_x4(a, qa + 8 * kk);
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[i]), a_hi[i], a_lo[i]);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4], b_hi[4], b_lo[4];
          ldsm_x4(b, kb + 16 * np * ld + 8 * kk);
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(b[i]), b_hi[i], b_lo[i]);
          mma_split(s[2 * np], a_hi, a_lo, b_hi[0], b_hi[1], b_lo[0], b_lo[1]);
          mma_split(s[2 * np + 1], a_hi, a_lo, b_hi[2], b_hi[3], b_lo[2], b_lo[3]);
        }
      }
    }

    // this tile's V has landed and every warp is done with its K: the next
    // K comes in while the softmax and P V run
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < kt_hi) load_tile_f32(Ks, kh, k0 + kF32BK, S, d, ld, tc, vec);
    cp_async_commit();

    if (!hidden) {
      // raw scores, the mask only where the tile straddles its edges
      const bool full = k0 + kF32BK <= S && (!causal || k0 + kF32BK - 1 <= wq0) &&
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
      // p = 2^(s scale log2(e) - m scale log2(e)), zeroed where masked
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
      for (int n = 0; n < NKMAX; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }

      // O += P V, one 8-key step per score n-tile: A column tig is key
      // 2 tig and column tig + 4 key 2 tig + 1, so the A fragment is
      // (s[j][0], s[j][2], s[j][1], s[j][3]) and V's rows follow suit
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t p_hi[4], p_lo[4];
        split_tf32(s[j][0], p_hi[0], p_lo[0]);
        split_tf32(s[j][2], p_hi[1], p_lo[1]);
        split_tf32(s[j][1], p_hi[2], p_lo[2]);
        split_tf32(s[j][3], p_hi[3], p_lo[3]);
        const float* vr = vb + 8 * j * ld;
#pragma unroll
        for (int n = 0; n < NKMAX; ++n) {   // n >= nk repeats the last tile, unwritten
          const int col = 8 * min(n, nk - 1);
          uint32_t b_hi0, b_lo0, b_hi1, b_lo1;
          split_tf32(vr[col], b_hi0, b_lo0);
          split_tf32(vr[ld + col], b_hi1, b_lo1);
          mma_split(o[n], p_hi, p_lo, b_hi0, b_hi1, b_lo0, b_lo1);
        }
      }
    }

    // the next K has landed and every warp is done with this V
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < kt_hi) load_tile_f32(Vs, vh, k0 + kF32BK, S, d, ld, tc, vec);
    cp_async_commit();
  }

  // row sums over the quad; then out = acc / max(l, 1e-30), or this split's
  // acc, m and l
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
  }
  if (splits == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wq0 + g + 8 * h;
      if (row >= S) continue;
      const float denom = fmaxf(l[h], 1e-30f);
      float* orow = out + (static_cast<size_t>(bh) * S + row) * d;
#pragma unroll
      for (int n = 0; n < NKMAX; ++n) {
        const int col = 8 * n + 2 * tig;
        if (n >= nk || col >= d) continue;
        const float x0 = o[n][2 * h] / denom, x1 = o[n][2 * h + 1] / denom;
        if (col + 1 < d && (d & 1) == 0) {
          *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
        } else {
          orow[col] = x0;
          if (col + 1 < d) orow[col + 1] = x1;
        }
      }
    }
    return;
  }

  // split-KV: this block's acc (over Q's tile) and (m, l) (over K's) in
  // shared memory; after the cluster's barrier each block merges its slice
  // of the 64 rows from all the cluster's blocks,
  //   out = sum_i w_i acc_i / max(sum_i w_i l_i, 1e-30),
  //   w_i = 2^((m_i - max_i m_i) scale log2(e)),
  // and waits at a second barrier until no block reads its shared memory
  float* acc_s = Qs;   // [64][ld]
  float* ml_s = Ks;    // [64][2]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h;
#pragma unroll
    for (int n = 0; n < NKMAX; ++n) {
      if (n >= nk) continue;
      acc_s[r * ld + 8 * n + 2 * tig] = o[n][2 * h];
      acc_s[r * ld + 8 * n + 2 * tig + 1] = o[n][2 * h + 1];
    }
    if (tig == 0) {
      ml_s[2 * r] = m[h];
      ml_s[2 * r + 1] = l[h];
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int r0 = split * kF32BQ / splits, r1 = (split + 1) * kF32BQ / splits;
  for (int i = threadIdx.x; i < (r1 - r0) * d; i += kF32Threads) {
    const int r = r0 + i / d, col = i - (i / d) * d;
    if (q0 + r >= S) continue;
    float mx = kNegInf;
    for (int sp = 0; sp < splits; ++sp) mx = fmaxf(mx, cluster.map_shared_rank(ml_s, sp)[2 * r]);
    float den = 0.f, acc = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const float* peer_ml = cluster.map_shared_rank(ml_s, sp);
      const float w = ex2((peer_ml[2 * r] - mx) * scale_log2);
      den += w * peer_ml[2 * r + 1];
      acc += w * cluster.map_shared_rank(acc_s, sp)[r * ld + col];
    }
    out[(static_cast<size_t>(bh) * S + q0 + r) * d + col] = acc / fmaxf(den, 1e-30f);
  }
  cluster.sync();
}

template <int NKMAX>
int launch_f32(const void* q, const void* k, const void* v, void* out, int bh, int S, int d,
               int causal, int window, float scale, int splits, cudaStream_t st) {
  // the dynamic shared memory limit, raised once per device to this
  // instantiation's widest head (an attribute call on every launch costs the
  // short cases more than their kernels)
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !raised[dev]) {
    err = cudaFuncSetAttribute(flash_f32_kernel<NKMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(f32_smem_bytes(8 * NKMAX)));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) raised[dev] = true;
  }
  const int n_qt = (S + kF32BQ - 1) / kF32BQ;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const int vec = d % 4 == 0 && ptrs % 16 == 0;
  const float scale_log2 = static_cast<float>(scale * 1.4426950408889634);   // log2(e)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bh * n_qt * splits);
  cfg.blockDim = dim3(kF32Threads);
  cfg.dynamicSmemBytes = f32_smem_bytes(d);
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];   // a query tile's splits: one cluster
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, flash_f32_kernel<NKMAX>, static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), bh, S, d, causal, window,
      scale_log2, n_qt, splits, vec));
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v, out: (bh, S, d) f32, contiguous; 0 < d <= 128; 0 < splits <= 8
// (a cluster's portable size); bh * ceil(S / 64) * splits < 2^31; window
// <= 0 means none.
int flash_attention_forward(const void* q, const void* k, const void* v, void* out, int bh,
                            int S, int d, int causal, int window, float scale, int splits,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d > kMaxD || bh <= 0 || S <= 0 || splits <= 0 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  switch ((d + 31) / 32) {
    case 1: return launch_f32<4>(q, k, v, out, bh, S, d, causal, window, scale, splits, st);
    case 2: return launch_f32<8>(q, k, v, out, bh, S, d, causal, window, scale, splits, st);
    case 3: return launch_f32<12>(q, k, v, out, bh, S, d, causal, window, scale, splits, st);
    default: return launch_f32<16>(q, k, v, out, bh, S, d, causal, window, scale, splits, st);
  }
}

// the dynamic shared memory flash_attention_forward asks for at width d
int flash_attention_f32_smem_bytes(int d) { return static_cast<int>(f32_smem_bytes(d)); }

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
