// Hopper (sm_90a) kernels of the graph engine's relaxation substrate.
//
// Built by build.py into a shared library with a plain C interface and
// called through ctypes from ops.py.  Every launch function enqueues on the
// stream it is given, allocates nothing (the wrapper passes outputs and
// scratch), and returns cudaGetLastError() so that a refused launch raises
// in Python.
//
// ---------------------------------------------------------------------------
// edge_relax — replaces _edge_relax_kernel / edge_relax_pallas
//   (src/repro/kernels/graph_ops/graph_ops.py).
//
//   For each edge slot e: v = src_val[src[e]]; the message is v + w (min/max),
//   v * w (add) or v alone (unweighted); it is masked to the reduction's
//   neutral by active[src[e]] (vertex mask) or valid[e] (per-slot mask) and
//   reduced into out at dst[e].  The wrapper seeds out with a copy of
//   out_init.
//
//   Bound: device-memory bytes.  Each slot streams src, dst (and w) — 8-12
//   B — and does two dependent gathers (mask/src_val at src[e]) plus a
//   read-modify-write at dst[e]; a few operations per slot, so compute is
//   nowhere near a limit.
//
//   Design: one thread per slot in a grid-stride loop, coalesced edge
//   streams.  The TPU kernel got race-free read-modify-write from its
//   sequential revisited grid; here blocks run in any order, so the
//   reduction is atomic:
//     * f32 min/max: ordered-int atomics on the float's bits.  A message with
//       the sign bit clear uses atomicMin (atomicMax for max) on the int
//       view; one with the sign bit set uses atomicMax (atomicMin) on the
//       unsigned view.  Together these realise min/max under the total order
//       of ordered_key(), in which -0.0 < +0.0 (XLA's order for signed
//       zeros) and NaNs sort by their bits, so the result is the same
//       whatever order duplicates arrive in — bitwise equal to ref.py.
//     * int32 min/max: native atomicMin/atomicMax.
//     * f32 add: atomicAdd; its order varies from run to run (allclose only).
//     * or: the byte (uint8 max, as in ref.py) is updated by an atomicCAS
//       loop on the aligned 32-bit word that holds it; the wrapper checks
//       alignment and that n_pad is a multiple of 4.
//   Before each atomic a plain read of out[dst] skips messages that cannot
//   change it (min/max/or only move one way), which removes most atomic
//   traffic once labels settle.  Masked slots of a min/max on floats still
//   take that read, so a seed beyond the neutral (+inf under min) is
//   clamped exactly as the reference's neutral message clamps it; masked
//   slots of int min/max and or are skipped (their neutral is the type's
//   extreme), and masked slots of add are skipped (adding +0.0 only turns
//   -0.0 into +0.0; add is compared allclose).
//
// ---------------------------------------------------------------------------
// advance — replaces _advance_kernel / advance_pallas
//   (src/repro/kernels/graph_ops/graph_ops.py).
//
//   Merge-path expansion of a compacted frontier into `budget` edge slots:
//   cum = inclusive scan of out_deg[f_idx] over the min(f_count, cap) live
//   slots; for each slot j, k = upper_bound(cum, j), and the slot emits
//   (u = f_idx[k], col_idx[row_ptr[u] + j - cum[k-1]], edge_w[...], j < total)
//   with the sentinel and edge m_pad-1 past total.  Every value is exact
//   int32, so the result is bitwise equal to ref.py.
//
//   Bound: device-memory bytes — the cap-long scan reads and writes cum,
//   each slot gathers row_ptr/col_idx/edge_w and writes 13 B; the binary
//   search's first levels stay in L2.
//
//   Design: the TPU kernel computed the running sum once into VMEM scratch
//   that persisted across its sequential grid.  Here cap reaches n_pad
//   (millions), so the scan is multi-block: per-tile block scans with warp
//   shuffles (advance_tile_scan), one block scanning the tile sums
//   (advance_scan_tiles, which also writes total on the device), and an
//   add-back (advance_add_offsets).  Then one thread per budget slot does
//   the binary search and writes the five outputs (advance_expand).
//   f_count and total are read on the device: no host sync.
// ---------------------------------------------------------------------------

#include <cfloat>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

enum Kind { KIND_MIN = 0, KIND_MAX = 1, KIND_ADD = 2, KIND_OR = 3 };
enum DType { DT_F32 = 0, DT_I32 = 1, DT_U8 = 2 };

constexpr int kRelaxThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kMaxBlocks = 132 * 32;

__device__ __forceinline__ int ordered_key(float x) {
  int b = __float_as_int(x);
  return b >= 0 ? b : (b ^ 0x7fffffff);
}

template <typename T, int KIND>
struct Reducer;

template <>
struct Reducer<float, KIND_MIN> {
  static constexpr bool kSkipMasked = false;
  static __device__ __forceinline__ float neutral() { return FLT_MAX; }
  static __device__ __forceinline__ void apply(float* p, float msg) {
    float cur = *reinterpret_cast<volatile float*>(p);
    if (ordered_key(msg) >= ordered_key(cur)) return;  // min only decreases
    int b = __float_as_int(msg);
    if (b >= 0) {
      atomicMin(reinterpret_cast<int*>(p), b);
    } else {
      atomicMax(reinterpret_cast<unsigned int*>(p), static_cast<unsigned int>(b));
    }
  }
};

template <>
struct Reducer<float, KIND_MAX> {
  static constexpr bool kSkipMasked = false;
  static __device__ __forceinline__ float neutral() { return -FLT_MAX; }
  static __device__ __forceinline__ void apply(float* p, float msg) {
    float cur = *reinterpret_cast<volatile float*>(p);
    if (ordered_key(msg) <= ordered_key(cur)) return;  // max only increases
    int b = __float_as_int(msg);
    if (b >= 0) {
      atomicMax(reinterpret_cast<int*>(p), b);
    } else {
      atomicMin(reinterpret_cast<unsigned int*>(p), static_cast<unsigned int>(b));
    }
  }
};

template <>
struct Reducer<float, KIND_ADD> {
  static constexpr bool kSkipMasked = true;
  static __device__ __forceinline__ float neutral() { return 0.0f; }
  static __device__ __forceinline__ void apply(float* p, float msg) { atomicAdd(p, msg); }
};

template <>
struct Reducer<int, KIND_MIN> {
  static constexpr bool kSkipMasked = true;
  static __device__ __forceinline__ int neutral() { return INT_MAX; }
  static __device__ __forceinline__ void apply(int* p, int msg) {
    if (msg >= *reinterpret_cast<volatile int*>(p)) return;
    atomicMin(p, msg);
  }
};

template <>
struct Reducer<int, KIND_MAX> {
  static constexpr bool kSkipMasked = true;
  static __device__ __forceinline__ int neutral() { return INT_MIN; }
  static __device__ __forceinline__ void apply(int* p, int msg) {
    if (msg <= *reinterpret_cast<volatile int*>(p)) return;
    atomicMax(p, msg);
  }
};

template <>
struct Reducer<uint8_t, KIND_OR> {
  static constexpr bool kSkipMasked = true;
  static __device__ __forceinline__ uint8_t neutral() { return 0; }
  static __device__ __forceinline__ void apply(uint8_t* p, uint8_t msg) {
    if (msg == 0) return;
    uintptr_t addr = reinterpret_cast<uintptr_t>(p);
    unsigned int* word = reinterpret_cast<unsigned int*>(addr & ~uintptr_t(3));
    unsigned int shift = static_cast<unsigned int>(addr & 3) * 8u;
    unsigned int old = *reinterpret_cast<volatile unsigned int*>(word);
    while (true) {
      unsigned int cur = (old >> shift) & 0xffu;
      if (cur >= msg) return;
      unsigned int repl = (old & ~(0xffu << shift)) | (static_cast<unsigned int>(msg) << shift);
      unsigned int seen = atomicCAS(word, old, repl);
      if (seen == old) return;
      old = seen;
    }
  }
};

template <typename T, int KIND, bool USE_W>
__device__ __forceinline__ T edge_message(T v, float w) {
  if constexpr (!USE_W) {
    return v;
  } else if constexpr (KIND == KIND_MIN || KIND == KIND_MAX) {
    return v + w;
  } else {
    return v * w;
  }
}

template <typename T, int KIND, bool USE_W, bool VMASK>
__global__ void edge_relax_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                                  const float* __restrict__ w,
                                  const uint8_t* __restrict__ mask,
                                  const T* __restrict__ src_val, T* out, long long m) {
  using R = Reducer<T, KIND>;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < m;
       e += stride) {
    int s = src[e];
    bool act = VMASK ? (mask[s] != 0) : (mask[e] != 0);
    T msg;
    if (act) {
      msg = edge_message<T, KIND, USE_W>(src_val[s], USE_W ? w[e] : 0.0f);
    } else {
      if (R::kSkipMasked) continue;
      msg = R::neutral();
    }
    R::apply(out + dst[e], msg);
  }
}

template <typename T, int KIND, bool USE_W>
cudaError_t launch_relax_vm(bool vmask, const int* src, const int* dst, const float* w,
                            const uint8_t* mask, const void* src_val, void* out, long long m,
                            cudaStream_t stream) {
  long long want = (m + kRelaxThreads - 1) / kRelaxThreads;
  int blocks = static_cast<int>(want < kMaxBlocks ? (want > 0 ? want : 1) : kMaxBlocks);
  const T* sv = static_cast<const T*>(src_val);
  T* o = static_cast<T*>(out);
  if (vmask) {
    edge_relax_kernel<T, KIND, USE_W, true><<<blocks, kRelaxThreads, 0, stream>>>(src, dst, w, mask, sv, o, m);
  } else {
    edge_relax_kernel<T, KIND, USE_W, false><<<blocks, kRelaxThreads, 0, stream>>>(src, dst, w, mask, sv, o, m);
  }
  return cudaGetLastError();
}

template <typename T, int KIND>
cudaError_t launch_relax_w(bool use_w, bool vmask, const int* src, const int* dst,
                           const float* w, const uint8_t* mask, const void* src_val, void* out,
                           long long m, cudaStream_t stream) {
  if (use_w) return launch_relax_vm<T, KIND, true>(vmask, src, dst, w, mask, src_val, out, m, stream);
  return launch_relax_vm<T, KIND, false>(vmask, src, dst, w, mask, src_val, out, m, stream);
}

// ---- advance --------------------------------------------------------------

__device__ __forceinline__ int warp_inclusive_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Inclusive scan over the block (blockDim.x a multiple of 32, <= 1024).
__device__ __forceinline__ int block_inclusive_scan(int x, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  x = warp_inclusive_scan(x);
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    const int nwarps = blockDim.x >> 5;
    int t = lane < nwarps ? warp_sums[lane] : 0;
    t = warp_inclusive_scan(t);
    if (lane < nwarps) warp_sums[lane] = t;
  }
  __syncthreads();
  if (wid > 0) x += warp_sums[wid - 1];
  __syncthreads();  // warp_sums may be reused by the caller
  return x;
}

__global__ void advance_tile_scan(const int* __restrict__ f_idx, const int* __restrict__ f_count,
                                  const int* __restrict__ out_deg, int cap, int* cum,
                                  int* tile_sums) {
  __shared__ int warp_sums[32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int live = min(*f_count, cap);
  const int d = i < live ? out_deg[f_idx[i]] : 0;
  const int x = block_inclusive_scan(d, warp_sums);
  if (i < cap) cum[i] = x;
  if (threadIdx.x == blockDim.x - 1) tile_sums[blockIdx.x] = x;
}

// One block: tile sums → exclusive tile offsets (in place); total on device.
__global__ void advance_scan_tiles(int* tile_sums, int ntiles, int* total) {
  __shared__ int warp_sums[32];
  __shared__ int carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < ntiles; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < ntiles ? tile_sums[i] : 0;
    const int inc = block_inclusive_scan(v, warp_sums);
    const int c = carry;
    if (i < ntiles) tile_sums[i] = c + inc - v;
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) carry = c + inc;
    __syncthreads();
  }
  if (threadIdx.x == 0) *total = carry;
}

__global__ void advance_add_offsets(int* cum, const int* __restrict__ tile_offsets, int cap) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (blockIdx.x > 0 && i < cap) cum[i] += tile_offsets[blockIdx.x];
}

__global__ void advance_expand(const int* __restrict__ f_idx, const int* __restrict__ cum, int cap,
                               const int* __restrict__ total_p, const int* __restrict__ row_ptr,
                               const int* __restrict__ col_idx, const float* __restrict__ edge_w,
                               int budget, int sentinel, int m_pad, int* out_src, int* out_dst,
                               float* out_w, uint8_t* out_valid) {
  const int total = *total_p;
  const int stride = gridDim.x * blockDim.x;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < budget; j += stride) {
    const bool valid = j < total;
    int u = sentinel;
    int e = m_pad - 1;  // padded slot → the last edge slot, as in the reference
    if (valid) {
      // k = number of cum entries <= j (searchsorted side="right")
      int lo = 0, hi = cap;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cum[mid] <= j) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      const int k = min(lo, cap - 1);
      const int prev = k > 0 ? cum[k - 1] : 0;
      u = f_idx[k];
      e = row_ptr[u] + (j - prev);
    }
    out_src[j] = u;
    out_dst[j] = col_idx[e];
    out_w[j] = edge_w[e];
    out_valid[j] = valid ? 1 : 0;
  }
}

}  // namespace

extern "C" {

const char* graph_ops_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: DT_F32 / DT_I32 / DT_U8; kind: KIND_*.  mask is bool (one byte):
// (n_pad,) when vmask, else (m,).  out already holds out_init.
int graph_ops_edge_relax(const void* src, const void* dst, const void* w, const void* mask,
                         const void* src_val, void* out, long long m, int dtype, int kind,
                         int use_weight, int vmask, void* stream) {
  const int* s = static_cast<const int*>(src);
  const int* d = static_cast<const int*>(dst);
  const float* ww = static_cast<const float*>(w);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool uw = use_weight != 0;
  const bool vm = vmask != 0;
  if (dtype == DT_F32) {
    if (kind == KIND_MIN) return launch_relax_w<float, KIND_MIN>(uw, vm, s, d, ww, mk, src_val, out, m, st);
    if (kind == KIND_MAX) return launch_relax_w<float, KIND_MAX>(uw, vm, s, d, ww, mk, src_val, out, m, st);
    if (kind == KIND_ADD) return launch_relax_w<float, KIND_ADD>(uw, vm, s, d, ww, mk, src_val, out, m, st);
  } else if (dtype == DT_I32 && !uw) {
    if (kind == KIND_MIN) return launch_relax_vm<int, KIND_MIN, false>(vm, s, d, ww, mk, src_val, out, m, st);
    if (kind == KIND_MAX) return launch_relax_vm<int, KIND_MAX, false>(vm, s, d, ww, mk, src_val, out, m, st);
  } else if (dtype == DT_U8 && !uw && kind == KIND_OR) {
    return launch_relax_vm<uint8_t, KIND_OR, false>(vm, s, d, ww, mk, src_val, out, m, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// cum_scratch: (cap,) int32; tile_scratch: (ceil(cap / 1024),) int32;
// total: (1,) int32 output; out_*: (budget,) outputs (valid is bool).
int graph_ops_advance(const void* f_idx, const void* f_count, const void* out_deg,
                      const void* row_ptr, const void* col_idx, const void* edge_w, int cap,
                      int budget, int sentinel, int m_pad, void* cum_scratch, void* tile_scratch,
                      void* total, void* out_src, void* out_dst, void* out_w, void* out_valid,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = (cap + kScanThreads - 1) / kScanThreads;
  int* cum = static_cast<int*>(cum_scratch);
  int* tiles = static_cast<int*>(tile_scratch);
  int* tot = static_cast<int*>(total);
  const int* fi = static_cast<const int*>(f_idx);

  advance_tile_scan<<<ntiles, kScanThreads, 0, st>>>(fi, static_cast<const int*>(f_count),
                                                     static_cast<const int*>(out_deg), cap, cum,
                                                     tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  advance_scan_tiles<<<1, kScanThreads, 0, st>>>(tiles, ntiles, tot);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  advance_add_offsets<<<ntiles, kScanThreads, 0, st>>>(cum, tiles, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int want = (budget + kRelaxThreads - 1) / kRelaxThreads;
  const int blocks = want < kMaxBlocks ? (want > 0 ? want : 1) : kMaxBlocks;
  advance_expand<<<blocks, kRelaxThreads, 0, st>>>(
      fi, cum, cap, tot, static_cast<const int*>(row_ptr), static_cast<const int*>(col_idx),
      static_cast<const float*>(edge_w), budget, sentinel, m_pad, static_cast<int*>(out_src),
      static_cast<int*>(out_dst), static_cast<float*>(out_w), static_cast<uint8_t*>(out_valid));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
