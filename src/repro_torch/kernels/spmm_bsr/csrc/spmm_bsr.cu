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
//   sum inside a block runs in another order, so the two agree to a
//   tolerance, not bitwise.
//
//   Bound: at F = 128 in f32, 2*bm*bk*F operations per block against its
//   bm*bk*4 bytes (64 per byte), above the f32 ridge of 67 TFLOP/s over
//   3.35 TB/s (20 per byte); a first design on the CUDA cores ran at 32%
//   of that rate.  On the tensor cores the split below runs three TF32
//   products, 6*bm*bk*F per block at 495 TFLOP/s, which takes about as
//   long as reading the adjacency blocks once and the gathered X blocks
//   (PERF.md: 1.32 against 1.06 ms on the port's SpMM graph).
//
//   Design: one block of 16 warps per (row block r, 128-column tile of F),
//   so at F = 128 every adjacency block is read once.  The TPU kernel's
//   sequential grid over the K slots becomes a loop inside the block, which
//   reads the slots' indices itself and skips the invalid ones.  Each
//   slot's product runs in 64-deep chunks (the A chunk, 128 x 64, and the
//   gathered X chunk, 64 x 128) through a ring of stages filled by 16-B
//   cp.async copies (element by element, synchronously, when bk or F is
//   not a multiple of 16 B): as many as fit in 210 KB of shared memory, one
//   block an SM (f32 x f32: 3 of 68 KB; bf16 x bf16: 6 of 35 KB; mixed: 4).
//   The next chunks, across slot boundaries, are in flight while one
//   multiplies; 32-deep chunks, with twice the barriers and copy issues per
//   product, were slower.  Row strides are padded (A: 64 + 4 floats,
//   64 + 8 bf16; X: 128 + 8) so that the fragment loads meet no bank
//   conflict.  Each of 16 warps owns a 32 x 32 patch of the output:
//   2 x 4 mma tiles, with the slot's partial and the output in registers
//   (8 warps of 32 x 64 patches kept too few warps on an SM to cover the
//   latencies).
//     * f32 operands (and one f32 beside a bf16 one, which the reference
//       casts to f32 before its dot): split TF32 on mma.sync.m16n8k8 —
//       hi = tf32(v), lo = tf32(v - hi) for each f32 operand (rounded to
//       nearest, ties away, by two integer operations instead of a cvt),
//       and the product A_hi X_hi + A_hi X_lo + A_lo X_hi, accumulated in
//       f32 (the
//       dropped A_lo X_lo and the rounding of lo are about 2^-22 of each
//       term).  A bf16 operand is exact in TF32: its lo is 0 and its two
//       products are not issued.
//     * bf16 x bf16: mma.sync.m16n8k16 bf16 with f32 accumulators, X's
//       fragments by ldmatrix.trans; the products are exact in f32.
//   A slot's partial starts at 0 and is added into the output (rounded
//   each time under bf16) when its last chunk is done.  Rows past bm and
//   columns past F are zero-filled in the ring; their mma tiles are not
//   issued and their outputs not written.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kBM = 128;       // rows of the block tile (bm <= kBM)
constexpr int kFT = 128;       // output columns of the block tile
constexpr int kWM = 32;        // rows of a warp's patch: 2 mma tiles of 16
constexpr int kWN = 32;        // columns of a warp's patch: kNT mma tiles of 8
constexpr int kNT = kWN / 8;
constexpr int kThreads = 32 * (kBM / kWM) * (kFT / kWN);  // 16 warps
constexpr int kKC = 64;        // depth of one staged chunk
constexpr int kRingBytes = 210 * 1024;  // shared memory the ring may take
constexpr int kMaxStages = 6;
enum { DT_F32 = 0, DT_BF16 = 1 };

// row strides (elements) of the staged A chunk (kBM x kKC) and X chunk
// (kKC x kFT): 16-B rows, conflict-free fragment loads
template <typename T>
struct Pad;
template <>
struct Pad<float> {
  static constexpr int A = kKC + 4, X = kFT + 8;
};
template <>
struct Pad<bf16> {
  static constexpr int A = kKC + 8, X = kFT + 8;
};

// the ring: as many stages as fit in kRingBytes, at most kMaxStages (f32 x
// f32: 3 stages of 69,632 B; bf16 x bf16: 6 of 35,840 B)
template <typename TA, typename TX>
struct Ring {
  static constexpr int A_BYTES = kBM * Pad<TA>::A * static_cast<int>(sizeof(TA));
  static constexpr int STAGE = A_BYTES + kKC * Pad<TX>::X * static_cast<int>(sizeof(TX));
  static constexpr int STAGES = kRingBytes / STAGE < kMaxStages ? kRingBytes / STAGE : kMaxStages;
  static constexpr int BYTES = STAGES * STAGE;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cvt.rna.tf32.f32 in two integer operations: half a TF32 ulp added to
// the magnitude, the 13 bits below TF32's mantissa cleared (round to
// nearest, ties away from zero)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// v -> hi = tf32(v), lo = tf32(v - hi)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

// c += a (16 x 8, row) * b (8 x 8, col), TF32 in, f32 accumulate; not
// volatile (registers only), so independent products may be interleaved
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// An RT x CT tile of src (row stride ld) into dst (row stride LD), zero past
// nr rows and nc columns: 16-B cp.async copies when `vec` (16-B aligned rows
// and nc a multiple of 16 B), else element by element, synchronously.
template <typename T, int RT, int CT, int LD>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src, long long ld, int nr,
                                           int nc, bool vec) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  if (vec) {
#pragma unroll
    for (int p = threadIdx.x; p < RT * CT / V; p += kThreads) {
      const int r = p / (CT / V), c = (p - r * (CT / V)) * V;
      const bool ok = r < nr && c < nc;
      cp_async16(dst + r * LD + c, ok ? src + r * ld + c : src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < RT * CT; i += kThreads) {
      const int r = i / CT, c = i - r * CT;
      dst[r * LD + c] = r < nr && c < nc ? src[r * ld + c] : from_f<T>(0.f);
    }
  }
}

// p += the staged A chunk's rows [wm, wm + kWM) times the X chunk's
// columns [wn, wn + kWN); mma tiles past `rows` or `cols` are not issued.
// Each depth step loads every fragment first, then issues the products pass
// by pass, so that 2 kNT independent mma tiles lie between two into one.
template <typename TA, typename TX>
__device__ __forceinline__ void mma_chunk(float (&p)[2][kNT][4], const TA* As, const TX* Xs,
                                          int wm, int wn, int rows, int cols) {
  constexpr int LA = Pad<TA>::A, LX = Pad<TX>::X;
  constexpr bool kA32 = std::is_same<TA, float>::value, kX32 = std::is_same<TX, float>::value;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  bool m_on[2], n_on[kNT];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) m_on[mt] = wm + mt * 16 < rows;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) n_on[nt] = wn + nt * 8 < cols;
  if constexpr (!kA32 && !kX32) {
#pragma unroll
    for (int ks = 0; ks < kKC; ks += 16) {
      uint32_t a[2][4], b[kNT][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const bf16* ap = As + (wm + mt * 16 + g) * LA + ks + 2 * t;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(ap);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(ap + 8 * LA);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(ap + 8);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(ap + 8 * LA + 8);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        if (n_on[nt]) ldsm_x2_trans(b[nt], Xs + (ks + (lane & 15)) * LX + wn + nt * 8);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          if (n_on[nt] && m_on[mt]) mma_bf16(p[mt][nt], a[mt], b[nt]);
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < kKC; ks += 8) {
      uint32_t ah[2][4], al[2][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const TA* ap = As + (wm + mt * 16 + g) * LA + ks + t;
        const float v[4] = {to_f(ap[0]), to_f(ap[8 * LA]), to_f(ap[4]), to_f(ap[8 * LA + 4])};
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(v[i], ah[mt][i], al[mt][i]);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const TX* bp = Xs + (ks + t) * LX + wn + nt * 8 + g;
        split_tf32(to_f(bp[0]), bh[nt][0], bl[nt][0]);
        split_tf32(to_f(bp[4 * LX]), bh[nt][1], bl[nt][1]);
      }
      if constexpr (kA32) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            if (n_on[nt] && m_on[mt]) mma_tf32(p[mt][nt], al[mt], bh[nt]);
      }
      if constexpr (kX32) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            if (n_on[nt] && m_on[mt]) mma_tf32(p[mt][nt], ah[mt], bl[nt]);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          if (n_on[nt] && m_on[mt]) mma_tf32(p[mt][nt], ah[mt], bh[nt]);
    }
  }
}

template <typename TA, typename TX>
__global__ void __launch_bounds__(kThreads, 1)
    spmm_kernel(const int* __restrict__ indices, const TA* __restrict__ blocks,
                const TX* __restrict__ x, TX* __restrict__ out, int K, int bm, int bk, int C,
                int F, int nft, bool a_vec, bool x_vec) {
  using R = Ring<TA, TX>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x / nft;
  const int f0 = (blockIdx.x - r * nft) * kFT;
  const int wid = threadIdx.x >> 5;
  const int wm = (wid % (kBM / kWM)) * kWM;  // the warp's first row
  const int wn = (wid / (kBM / kWM)) * kWN;  // the warp's first column of the tile
  const int* __restrict__ idx = indices + static_cast<long long>(r) * K;
  const int nkc = (bk + kKC - 1) / kKC;
  auto valid = [&](int c) { return c >= 0 && c < C; };
  // the producer: the next (slot, chunk) to stage and the slot's column
  // block; the next slot's index is read with the slot's first chunk and
  // used after its last
  int pslot = 0, pkc = 0, issued = 0, pc = -1, nraw = -1;
  while (pslot < K && !valid(pc = __ldg(idx + pslot))) ++pslot;
  auto issue = [&]() {
    if (pslot < K) {
      if (pkc == 0) nraw = pslot + 1 < K ? __ldg(idx + pslot + 1) : -1;
      unsigned char* st = smem + (issued % R::STAGES) * R::STAGE;
      const int k0 = pkc * kKC;
      stage_tile<TA, kBM, kKC, Pad<TA>::A>(
          reinterpret_cast<TA*>(st),
          blocks + (static_cast<long long>(r) * K + pslot) * bm * bk + k0, bk, bm, bk - k0,
          a_vec);
      stage_tile<TX, kKC, kFT, Pad<TX>::X>(reinterpret_cast<TX*>(st + R::A_BYTES),
                                           x + (static_cast<long long>(pc) * bk + k0) * F + f0,
                                           F, bk - k0, F - f0, x_vec);
      ++issued;
      if (++pkc == nkc) {
        pkc = 0;
        pc = nraw;
        for (++pslot; pslot < K && !valid(pc);) {
          ++pslot;
          pc = pslot < K ? __ldg(idx + pslot) : -1;
        }
      }
    }
    cp_async_commit();  // an empty group past the last chunk keeps the count
  };

  float o[2][kNT][4], p[2][kNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[mt][nt][i] = p[mt][nt][i] = 0.f;

#pragma unroll
  for (int s = 0; s < R::STAGES - 1; ++s) issue();
  int ckc = 0;
  for (int q = 0; q < issued; ++q) {
    cp_async_wait<R::STAGES - 2>();  // chunk q has landed
    __syncthreads();                 // and every warp is done with chunk q - 1
    issue();                         // into chunk q - 1's stage
    const unsigned char* st = smem + (q % R::STAGES) * R::STAGE;
    mma_chunk<TA, TX>(p, reinterpret_cast<const TA*>(st),
                      reinterpret_cast<const TX*>(st + R::A_BYTES), wm, wn, bm, F - f0);
    if (++ckc == nkc) {  // the slot's product is done: round it and add it in
      ckc = 0;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            o[mt][nt][i] = round_to<TX>(__fadd_rn(o[mt][nt][i], round_to<TX>(p[mt][nt][i])));
            p[mt][nt][i] = 0.f;
          }
    }
  }

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wm + mt * 16 + g + 8 * h;
      if (row >= bm) continue;
      TX* orow = out + (static_cast<long long>(r) * bm + row) * F;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = f0 + wn + nt * 8 + 2 * t;
        if (col < F) orow[col] = from_f<TX>(o[mt][nt][2 * h]);
        if (col + 1 < F) orow[col + 1] = from_f<TX>(o[mt][nt][2 * h + 1]);
      }
    }
}

template <typename TA, typename TX>
int launch(const void* indices, const void* blocks, const void* x, void* out, int R, int K,
           int bm, int bk, int C, int F, cudaStream_t st) {
  constexpr int bytes = Ring<TA, TX>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(spmm_kernel<TA, TX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nft = (F + kFT - 1) / kFT;
  const bool a_vec = bk % (16 / sizeof(TA)) == 0 && reinterpret_cast<uintptr_t>(blocks) % 16 == 0;
  const bool x_vec = F % (16 / sizeof(TX)) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  spmm_kernel<TA, TX><<<R * nft, kThreads, bytes, st>>>(
      static_cast<const int*>(indices), static_cast<const TA*>(blocks),
      static_cast<const TX*>(x), static_cast<TX*>(out), K, bm, bk, C, F, nft, a_vec, x_vec);
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
  if (bm <= 0 || bm > kBM || bk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks_dtype == DT_F32 && x_dtype == DT_F32)
    return launch<float, float>(indices, blocks, x, out, R, K, bm, bk, C, F, st);
  if (blocks_dtype == DT_F32 && x_dtype == DT_BF16)
    return launch<float, bf16>(indices, blocks, x, out, R, K, bm, bk, C, F, st);
  if (blocks_dtype == DT_BF16 && x_dtype == DT_F32)
    return launch<bf16, float>(indices, blocks, x, out, R, K, bm, bk, C, F, st);
  if (blocks_dtype == DT_BF16 && x_dtype == DT_BF16)
    return launch<bf16, bf16>(indices, blocks, x, out, R, K, bm, bk, C, F, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
