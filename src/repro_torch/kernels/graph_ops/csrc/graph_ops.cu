// Hopper (sm_90a) kernels of the graph engine's relaxation substrate.
//
// Built by build.py into a shared library with a plain C interface and
// called through ctypes from ops.py.  Every launch function enqueues on the
// stream it is given, allocates nothing (the wrapper passes outputs and
// scratch), and returns the first CUDA error it meets, so that a refused
// launch raises in Python.
//
// ---------------------------------------------------------------------------
// edge_relax — replaces _edge_relax_kernel / edge_relax_pallas
//   (src/repro/kernels/graph_ops/graph_ops.py).
//
//   For each edge slot e: v = src_val[src[e]]; the message is v + w (min/max),
//   v * w (add) or v alone (unweighted); it is masked to the reduction's
//   neutral by active[src[e]] (vertex mask) or valid[e] (per-slot mask) and
//   reduced into out, seeded with out_init, at dst[e].
//
//   Bound: device-memory bytes.  A slot reads src (4 B), its dst and w (8 B)
//   only when it sends a message, and the slot mask (1 B) where there is
//   one; the vertex arrays (mask, src_val, out: 4-21 MB on the web graph)
//   stay in the 50 MB L2.  A few operations per slot, far from any rate.
//   What held the first design (one thread per slot, 40% of its bound) was
//   latency: a chain of three to four dependent accesses per slot — src,
//   then mask/src_val, then a read of out[dst], then the atomic — one chain
//   in flight per thread, and every masked f32 min/max slot read out[dst].
//
//   Design: a warp takes 128 slots at a time; each lane keeps
//   four slots' chains in flight side by side — their gathers, reads of out
//   and atomics issued together.  The edge streams are read evict-first
//   (ld.global.cs) so the vertex arrays stay in L2.  The mask comes first
//   (the slot's byte, or the vertex bitmap at src): a slot that sends
//   nothing reads no dst or w.  Two layouts of the 128, chosen by the case
//   (measured: each wins on its own shape, loses on the other's):
//     * rows (push, relax_edges over CSR; relax_batch over advance's output:
//       dst random): four rows of 32 consecutive slots, 4-B loads.  A
//       warp-wide read or atomic of out then covers one stretch of the edge
//       list, whose neighbouring dsts share L2 sectors (a lane-major layout
//       was slower than the first design on these shapes), and each
//       slot's dst and w load is its own decision: relax_batch's padding
//       tail costs its 1-B mask per slot.  One resident wave of blocks
//       strides over the tiles.
//     * lanes (pull over CSC, and the reversed push: dst sorted): four
//       consecutive slots a lane, one 16-B load per stream, so runs of
//       equal dst combine in registers before the warp's scan.  A start
//       that is not 16-B aligned takes a first group of up to three slots;
//       streams not congruent mod 16 B take 4-B loads in the same kernel.
//       A lane gathers mask[s] and src_val[s] once per run of equal src
//       among its slots.  A block takes eight tiles and ends.
//   One atomic per run of equal dst.  When a warp's tile holds two adjacent
//   slots with one dst, it combines each run's messages in registers — a
//   segmented scan across the lanes by shuffles (rows: per row, the run at
//   lane 31 carried into the next row) — and the run's last slot issues one
//   atomic.  Min, max, int add and or are order-free, so the result stays
//   bitwise the plain version's; float add sums in another order
//   (allclose, as before).  Other warps send one atomic per message.
//   The reduction is atomic, blocks running in any order (the TPU got
//   race-free read-modify-write from its sequential grid):
//     * f32 min/max: ordered-int atomics on the float's bits.  A message with
//       the sign bit clear uses atomicMin (atomicMax for max) on the int
//       view; one with the sign bit set uses atomicMax (atomicMin) on the
//       unsigned view.  Together these realise min/max under the total
//       order of ordered_key(), in which -0.0 < +0.0 (XLA's order for
//       signed zeros) and NaNs sort by their bits, so the result does not
//       depend on arrival order — bitwise equal to ref.py.
//     * int32 min/max/add: native atomics (integer sums are exact and wrap
//       as the plain version's do).
//     * f32 add: atomicAdd (allclose only).
//     * or: the byte (uint8 max, as in ref.py) is updated by an atomicCAS
//       loop on the aligned 32-bit word that holds it; the wrapper checks
//       alignment and that n_pad is a multiple of 4.
//   Before an atomic of min/max/or, a read of out[dst] skips a message that
//   cannot change it (these only move one way); without it every case tried
//   was slower.
//   The clamp: the reference's neutral message for f32 min is FLT_MAX, which
//   clamps a seed beyond it (+inf) at every dst a masked slot names (max:
//   -FLT_MAX and -inf).  relax_seed, which copies out_init into out, also
//   sets a flag when any seed lies beyond the neutral.  Without the flag
//   masked slots are skipped outright; with it a masked slot sends the
//   neutral, which costs one message per run of equal dst (one per row of
//   relax_batch's tail, whose slots all name one edge) and, where dst is
//   random, one read of out per masked slot, as before.
//
//   Kernel names tell the cases apart in a profile:
//   edge_relax<Push|Pull|Batch|Edges, dtype, Min|Max|Add|Or, weighted>, the
//   case passed by the operator seam (push_dense, pull_dense and the
//   reversed push, relax_batch, relax_edges); relax_seed<dtype, kind>.
//
// ---------------------------------------------------------------------------
// advance — replaces _advance_kernel / advance_pallas
//   (src/repro/kernels/graph_ops/graph_ops.py).
//
//   Merge-path expansion of a compacted frontier into `budget` edge slots:
//   cum = inclusive scan of out_deg[f_idx] over the live = min(f_count, cap)
//   slots; for each slot j < total = cum[live - 1], k = upper_bound(cum, j),
//   and the slot emits (u = f_idx[k], col_idx[row_ptr[u] + j - cum[k-1]],
//   edge_w[...], 1); past total, the sentinel, edge m_pad - 1 and 0.  Every
//   value is exact int32, so the result is bitwise equal to ref.py.
//
//   Bound: device-memory bytes — f_idx and the degree gathers of the live
//   entries, cum written and read once, the row_ptr/col_idx/edge_w gathers
//   of the emitted slots, and 13 B written per budget slot, which dominates
//   at large budgets.
//
//   Design: the TPU kernel computed the running sum once into VMEM scratch
//   that persisted across its sequential grid.  Here:
//     * advance_scan: one pass with decoupled look-back.  Blocks take
//       2,048-entry tiles in launch order (a ticket counter), scan them with
//       warp shuffles, publish the tile's sum, then look back over the
//       predecessors' status words (flag and value in one 64-bit word),
//       32 at a time, until one holds an inclusive prefix.  cum is written
//       once; tiles at or past live exit at once (for j < total the search
//       over [0, live) finds the k the reference's search over [0, cap)
//       finds); the last live tile writes total.  The wrapper's launch
//       resets the status words and the ticket (cudaMemsetAsync).
//     * advance_expand: each block owns 1,024 consecutive output slots.  Two
//       warps find the frontier entries that cover its first and last valid
//       slot with a 32-ary search of cum (about five dependent loads for a
//       million entries); the block stages those entries' cum, f_idx and
//       row_ptr in shared memory (up to 2,048; zero-degree entries may
//       exceed that, and then each slot searches cum in the covering range
//       itself), and each thread searches its first slot in shared memory
//       and walks to its next three.  The five outputs are written with
//       16-B (4-B for valid) stores.  Blocks past total write the padding
//       slots without a search.
//   f_count and total stay on the device: no host sync.
//
// ---------------------------------------------------------------------------
// intersect — replaces _intersect_kernel / intersect_pallas
//   (src/repro/kernels/graph_ops/graph_ops.py).
//
//   Triangle counting's hot loop.  adj is the (n_rows, dmax) oriented
//   adjacency: each row sorted ascending, real ids first, the rest the
//   sentinel (n_rows - 1, which sorts last; adj[sentinel] is all
//   sentinel).  For each oriented edge i it counts the entries w of
//   adj[src[i]] with w != sentinel that occur in adj[dst[i]], and adds the
//   int32 total over the batch into *count (zeroed by the wrapper).  Any
//   correct membership test gives the reference's integer, so the result
//   is bitwise equal to ref.intersect_ref.
//
//   Bound: device-memory bytes — src and dst once (8 B an edge) plus each
//   adjacency row the batch touches, real entries only, 4 B each.  The
//   operations (one compare per probe) are far below the card's rate, but
//   the probes are dependent loads: each candidate takes about
//   log2(len_d) + 1 serial reads of the target row, so a warp waits on
//   latency unless many warps are in flight.
//
//   Design: the TPU kernel held all of adj in VMEM and carried the scalar
//   across its sequential grid.  Here adj stays in device memory and each
//   edge gathers its two rows: one warp per oriented edge (grid-stride
//   over warps).  The warp first finds the target row's real length with
//   coalesced 32-wide loads and a ballot for the first sentinel (a padded
//   edge, src == dst == sentinel, finds 0 and costs one load).  The lanes
//   then stride over the candidate row, stop at its first sentinel, and
//   binary-search the target row's real prefix; the probed row is a few
//   hundred bytes and stays in L1.  Each lane keeps its count across all
//   of its warp's edges; one shuffle reduction and one atomicAdd per warp
//   at the end.  Row indices outside [0, n_rows) contribute 0 (the
//   reference's gather clamps them to the all-sentinel last row).  The
//   oriented degree bounds every row by dmax, so one warp per edge is
//   balanced enough; merge-path balancing of skewed rows is later work.
// ---------------------------------------------------------------------------

#include <cfloat>
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

enum Kind { KIND_MIN = 0, KIND_MAX = 1, KIND_ADD = 2, KIND_OR = 3 };
enum DType { DT_F32 = 0, DT_I32 = 1, DT_U8 = 2 };
enum Case { CASE_PUSH = 0, CASE_PULL = 1, CASE_BATCH = 2, CASE_EDGES = 3 };

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxBlocks = 132 * 32;

// ---- edge_relax -------------------------------------------------------------

constexpr int kRelaxThreads = 256;
constexpr int kSlots = 4;  // slots per lane: consecutive (lanes) or 32 apart (rows)

// The case of a launch names the kernel in a profile and decides the mask
// and the layout of a warp's 128 slots: rows of 32 consecutive slots where
// dst is random (push and relax_edges over CSR, relax_batch over advance's
// output), four consecutive slots a lane where dst comes in runs (pull
// over CSC, and push over the reversed edges).
struct Push {
  static constexpr bool kVertexMask = true;
  static constexpr bool kRows = true;
};
struct Pull {
  static constexpr bool kVertexMask = true;
  static constexpr bool kRows = false;
};
struct Batch {
  static constexpr bool kVertexMask = false;
  static constexpr bool kRows = true;
};
struct Edges {
  static constexpr bool kVertexMask = false;
  static constexpr bool kRows = true;
};

// The reduction kinds.
struct Min {};
struct Max {};
struct Add {};
struct Or {};

__host__ __device__ constexpr int ordered_key_bits(int b) { return b >= 0 ? b : (b ^ 0x7fffffff); }

__device__ __forceinline__ int ordered_key(float x) { return ordered_key_bits(__float_as_int(x)); }

constexpr int kKeyFltMax = 0x7f7fffff;                          // ordered_key(FLT_MAX)
constexpr int kKeyNegFltMax = ordered_key_bits(int(0xff7fffffu));  // ordered_key(-FLT_MAX)

// Reducer<T, K>: neutral, register combine, "can this message change cur",
// the atomic, and whether masked slots clamp a seed beyond the neutral
// (kClamp) and whether a read of out[dst] comes before the atomic.
template <typename T, typename K>
struct Reducer;

template <>
struct Reducer<float, Min> {
  static constexpr bool kClamp = true;
  static constexpr bool kReadFirst = true;
  static __device__ __forceinline__ float neutral() { return FLT_MAX; }
  static __device__ __forceinline__ bool beyond(float x) { return ordered_key(x) > kKeyFltMax; }
  static __device__ __forceinline__ float combine(float a, float b) {
    return ordered_key(b) < ordered_key(a) ? b : a;
  }
  static __device__ __forceinline__ bool changes(float msg, float cur) {
    return ordered_key(msg) < ordered_key(cur);
  }
  static __device__ __forceinline__ void atomic(float* p, float msg) {
    const int b = __float_as_int(msg);
    if (b >= 0) {
      atomicMin(reinterpret_cast<int*>(p), b);
    } else {
      atomicMax(reinterpret_cast<unsigned int*>(p), static_cast<unsigned int>(b));
    }
  }
};

template <>
struct Reducer<float, Max> {
  static constexpr bool kClamp = true;
  static constexpr bool kReadFirst = true;
  static __device__ __forceinline__ float neutral() { return -FLT_MAX; }
  static __device__ __forceinline__ bool beyond(float x) { return ordered_key(x) < kKeyNegFltMax; }
  static __device__ __forceinline__ float combine(float a, float b) {
    return ordered_key(b) > ordered_key(a) ? b : a;
  }
  static __device__ __forceinline__ bool changes(float msg, float cur) {
    return ordered_key(msg) > ordered_key(cur);
  }
  static __device__ __forceinline__ void atomic(float* p, float msg) {
    const int b = __float_as_int(msg);
    if (b >= 0) {
      atomicMax(reinterpret_cast<int*>(p), b);
    } else {
      atomicMin(reinterpret_cast<unsigned int*>(p), static_cast<unsigned int>(b));
    }
  }
};

template <>
struct Reducer<float, Add> {
  static constexpr bool kClamp = false;
  static constexpr bool kReadFirst = false;
  static __device__ __forceinline__ float neutral() { return 0.0f; }
  static __device__ __forceinline__ bool beyond(float) { return false; }
  static __device__ __forceinline__ float combine(float a, float b) { return a + b; }
  static __device__ __forceinline__ bool changes(float, float) { return true; }
  static __device__ __forceinline__ void atomic(float* p, float msg) { atomicAdd(p, msg); }
};

template <>
struct Reducer<int, Min> {
  static constexpr bool kClamp = false;
  static constexpr bool kReadFirst = true;
  static __device__ __forceinline__ int neutral() { return INT_MAX; }
  static __device__ __forceinline__ bool beyond(int) { return false; }
  static __device__ __forceinline__ int combine(int a, int b) { return min(a, b); }
  static __device__ __forceinline__ bool changes(int msg, int cur) { return msg < cur; }
  static __device__ __forceinline__ void atomic(int* p, int msg) { atomicMin(p, msg); }
};

template <>
struct Reducer<int, Max> {
  static constexpr bool kClamp = false;
  static constexpr bool kReadFirst = true;
  static __device__ __forceinline__ int neutral() { return INT_MIN; }
  static __device__ __forceinline__ bool beyond(int) { return false; }
  static __device__ __forceinline__ int combine(int a, int b) { return max(a, b); }
  static __device__ __forceinline__ bool changes(int msg, int cur) { return msg > cur; }
  static __device__ __forceinline__ void atomic(int* p, int msg) { atomicMax(p, msg); }
};

template <>
struct Reducer<int, Add> {
  static constexpr bool kClamp = false;
  static constexpr bool kReadFirst = false;
  static __device__ __forceinline__ int neutral() { return 0; }
  static __device__ __forceinline__ bool beyond(int) { return false; }
  static __device__ __forceinline__ int combine(int a, int b) { return a + b; }
  static __device__ __forceinline__ bool changes(int, int) { return true; }
  static __device__ __forceinline__ void atomic(int* p, int msg) { atomicAdd(p, msg); }
};

template <>
struct Reducer<uint8_t, Or> {
  static constexpr bool kClamp = false;
  static constexpr bool kReadFirst = true;
  static __device__ __forceinline__ uint8_t neutral() { return 0; }
  static __device__ __forceinline__ bool beyond(uint8_t) { return false; }
  static __device__ __forceinline__ uint8_t combine(uint8_t a, uint8_t b) { return a > b ? a : b; }
  static __device__ __forceinline__ bool changes(uint8_t msg, uint8_t cur) { return msg > cur; }
  static __device__ __forceinline__ void atomic(uint8_t* p, uint8_t msg) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
    unsigned int* word = reinterpret_cast<unsigned int*>(addr & ~uintptr_t(3));
    const unsigned int shift = static_cast<unsigned int>(addr & 3) * 8u;
    unsigned int old = *reinterpret_cast<volatile unsigned int*>(word);
    while (true) {
      const unsigned int cur = (old >> shift) & 0xffu;
      if (cur >= msg) return;
      const unsigned int repl = (old & ~(0xffu << shift)) | (static_cast<unsigned int>(msg) << shift);
      const unsigned int seen = atomicCAS(word, old, repl);
      if (seen == old) return;
      old = seen;
    }
  }
};

template <typename T, typename K, bool USE_W>
__device__ __forceinline__ T edge_message(T v, float w) {
  if constexpr (!USE_W) {
    return v;
  } else if constexpr (std::is_same<K, Min>::value || std::is_same<K, Max>::value) {
    return v + w;
  } else {
    return v * w;
  }
}

// A read of out that may be stale: min/max/or only move one way, so a stale
// value can only let through a message that the atomic then drops.
template <typename T>
__device__ __forceinline__ T read_out(const T* p) {
  return *reinterpret_cast<const volatile T*>(p);
}

template <typename T>
__device__ __forceinline__ T shfl_up(T x, int off) {
  if constexpr (sizeof(T) == 1) {
    return static_cast<T>(__shfl_up_sync(kFull, static_cast<int>(x), off));
  } else {
    return __shfl_up_sync(kFull, x, off);
  }
}

// A group's slots [i0, i0 + n) of an int stream, read once (evict-first):
// one 16-B load when vec, else n 4-B loads; missing slots get `fill`.
__device__ __forceinline__ void load_group(const int* __restrict__ p, long long i0, int n, bool vec,
                                           int fill, int (&x)[kSlots]) {
  if (vec) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(p + i0));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) x[i] = i < n ? __ldcs(p + i0 + i) : fill;
  }
}

__device__ __forceinline__ void load_group(const float* __restrict__ p, long long i0, int n,
                                           bool vec, float (&x)[kSlots]) {
  if (vec) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p + i0));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) x[i] = i < n ? __ldcs(p + i0 + i) : 0.0f;
  }
}

// The messages of a lane's slots, each sent (has) or not, reduced into out:
// reads of out first, all of them, then the atomics.
template <typename R, typename T>
__device__ __forceinline__ void send(T* out, const int (&d)[kSlots], const bool (&has)[kSlots],
                                     const T (&msg)[kSlots]) {
  T cur[kSlots];
  if constexpr (R::kReadFirst) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) cur[i] = has[i] ? read_out(out + d[i]) : msg[i];
  }
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (has[i] && (!R::kReadFirst || R::changes(msg[i], cur[i]))) R::atomic(out + d[i], msg[i]);
  }
}

// Runs of equal dst across the warp's 128 slots (lane-major, four a lane):
// each run's messages are combined in registers and its last slot sends
// one message.  Runs inside a lane combine in place; a lane's last run is
// carried across lanes by a segmented inclusive scan of the lanes' last
// runs (a lane whose one run continues its neighbour's extends the segment).
template <typename R, typename T>
__device__ __forceinline__ void send_runs(T* out, const int (&d)[kSlots], const bool (&has)[kSlots],
                                          const T (&msg)[kSlots], int lane) {
  bool start[kSlots];
  start[0] = true;
#pragma unroll
  for (int i = 1; i < kSlots; ++i) start[i] = d[i] != d[i - 1];
  // the lane's last run
  bool th = false;
  T tv = R::neutral();
  bool full = true;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (start[i] && i > 0) {
      th = false;
      full = false;
    }
    if (has[i]) {
      tv = th ? R::combine(tv, msg[i]) : msg[i];
      th = true;
    }
  }
  const int d_prev = __shfl_up_sync(kFull, d[kSlots - 1], 1);
  const bool cont = lane > 0 && d[0] == d_prev;  // the first run continues the lane before
  const bool cont_next = __shfl_down_sync(kFull, cont, 1) && lane < 31;
  // segmented inclusive scan of (th, tv); seg: a segment head lies in the window
  bool seg = !(full && cont);
  bool sh = th;
  T sv = tv;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const bool yh = __shfl_up_sync(kFull, sh, off);
    const T yv = shfl_up(sv, off);
    const bool yseg = __shfl_up_sync(kFull, seg, off);
    if (lane >= off && !seg) {
      if (yh) sv = sh ? R::combine(yv, sv) : yv;
      sh = sh || yh;
      seg = yseg;
    }
  }
  // the run carried into this lane: the scan's value at the lane before
  const bool ph = __shfl_up_sync(kFull, sh, 1) && cont;
  const T pv = shfl_up(sv, 1);
  int ed[kSlots];
  bool eh[kSlots];
  T ev[kSlots];
  bool rh = false;
  T rv = R::neutral();
  bool first = true;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (start[i]) rh = false;
    if (has[i]) {
      rv = rh ? R::combine(rv, msg[i]) : msg[i];
      rh = true;
    }
    const bool ends = i == kSlots - 1 || start[i + 1];
    bool h = false;
    T v = rv;
    if (ends) {
      h = rh;
      if (first && ph) {
        v = h ? R::combine(pv, v) : pv;
        h = true;
      }
      if (i == kSlots - 1 && cont_next) h = false;  // the next lane carries it
      first = false;
    }
    ed[i] = d[i];
    eh[i] = h;
    ev[i] = v;
  }
  send<R>(out, ed, eh, ev);
}

// Four consecutive slots a lane (one 16-B load per stream): runs of equal
// dst combine in registers before the warp's scan.
template <typename C, typename T, typename K, bool USE_W>
__device__ __forceinline__ void relax_lanes(const int* __restrict__ src,
                                            const int* __restrict__ dst,
                                            const float* __restrict__ w,
                                            const uint8_t* __restrict__ mask,
                                            const T* __restrict__ src_val, T* out, long long m,
                                            int head, bool aligned, bool clamp) {
  using R = Reducer<T, K>;
  constexpr bool VM = C::kVertexMask;
  const int lane = threadIdx.x & 31;
  // group 0 is [0, head), the slots before the first 16-B boundary; group
  // g > 0 is [head + 4 (g - 1), head + 4 g)
  const long long ngroups = 1 + (m - head + kSlots - 1) / kSlots;
  const long long ntiles = (ngroups + 31) / 32;
  const long long nwarps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long tile = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       tile < ntiles; tile += nwarps) {
    const long long g = tile * 32 + lane;
    long long i0 = 0;
    int n = 0;
    if (g == 0) {
      n = head;
    } else if (g < ngroups) {
      i0 = head + (g - 1) * kSlots;
      n = static_cast<int>(min(static_cast<long long>(kSlots), m - i0));
    }
    const bool vec = aligned && g > 0 && n == kSlots;

    // 1. the mask, then the source and its value, once per run of equal src
    int s[kSlots];
    bool act[kSlots];
    T v[kSlots];
    bool any = false;
    if constexpr (VM) {
      load_group(src, i0, n, vec, 0, s);
      int sp = -1;
      bool a = false;
      T x = T();
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        if (i < n && s[i] != sp) {
          sp = s[i];
          a = __ldg(mask + sp) != 0;
          x = __ldg(src_val + sp);
        }
        act[i] = i < n && a;
        v[i] = x;
        any = any || act[i];
      }
    } else {
      unsigned int bytes = 0;
      if (vec) {
        bytes = __ldcs(reinterpret_cast<const unsigned int*>(mask + i0));
      } else {
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          if (i < n) bytes |= static_cast<unsigned int>(__ldcs(mask + i0 + i)) << (8 * i);
        }
      }
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        act[i] = ((bytes >> (8 * i)) & 0xffu) != 0;
        any = any || act[i];
      }
      if (any) {
        load_group(src, i0, n, vec, 0, s);
        int sp = -1;
        T x = T();
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          if (act[i] && s[i] != sp) {
            sp = s[i];
            x = __ldg(src_val + sp);
          }
          v[i] = x;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kSlots; ++i) v[i] = T();
      }
    }

    // 2. dst (and w) only for a lane with a message to send: an active slot,
    // or a masked one under the clamp
    int d[kSlots];
    float wv[kSlots] = {0.0f, 0.0f, 0.0f, 0.0f};
    const bool sends = any || (clamp && n > 0);
    if (sends) {
      load_group(dst, i0, n, vec, -1, d);
      if constexpr (USE_W) {
        if (any) load_group(w, i0, n, vec, wv);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kSlots; ++i) d[i] = -1;
    }
    bool has[kSlots];
    T msg[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      has[i] = i < n && (act[i] || clamp);
      msg[i] = act[i] ? edge_message<T, K, USE_W>(v[i], wv[i]) : R::neutral();
    }

    // 3. one atomic per run of equal dst where the warp holds such a run
    const int d_prev = __shfl_up_sync(kFull, d[kSlots - 1], 1);
    const bool h_prev = __shfl_up_sync(kFull, has[kSlots - 1], 1);
    bool pair = lane > 0 && has[0] && h_prev && d[0] == d_prev;
#pragma unroll
    for (int i = 1; i < kSlots; ++i) pair = pair || (has[i] && has[i - 1] && d[i] == d[i - 1]);
    if (__any_sync(kFull, pair)) {
      send_runs<R>(out, d, has, msg, lane);
    } else {
      send<R>(out, d, has, msg);
    }
  }
}

// Runs of equal dst in a striped tile: row i holds slots 32 i + lane.  Each
// row is a segmented inclusive scan across the lanes; the run at lane 31
// is carried into the next row's lane 0.  The last slot of a run sends it.
template <typename R, typename T>
__device__ __forceinline__ void send_runs_rows(T* out, const int (&d)[kSlots],
                                               const bool (&has)[kSlots], const T (&msg)[kSlots],
                                               int lane) {
  int cd = -2;  // the run carried from the row before: dst, has, value
  bool ch = false;
  T cv = R::neutral();
  bool eh[kSlots];
  T ev[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int up = __shfl_up_sync(kFull, d[i], 1);
    const bool head = d[i] != (lane > 0 ? up : cd);
    bool f = head;
    bool sh = has[i];
    T sv = msg[i];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const bool yh = __shfl_up_sync(kFull, sh, off);
      const T yv = shfl_up(sv, off);
      const bool yf = __shfl_up_sync(kFull, f, off);
      if (lane >= off && !f) {
        if (yh) sv = sh ? R::combine(yv, sv) : yv;
        sh = sh || yh;
        f = yf;
      }
    }
    const unsigned int heads = __ballot_sync(kFull, head);
    if (ch && (heads & ((2u << lane) - 1u)) == 0) {  // the run began in an earlier row
      sv = sh ? R::combine(cv, sv) : cv;
      sh = true;
    }
    const int down = __shfl_down_sync(kFull, d[i], 1);
    const int next_row = __shfl_sync(kFull, d[i < kSlots - 1 ? i + 1 : i], 0);
    const int next = lane < 31 ? down : (i < kSlots - 1 ? next_row : -3);
    eh[i] = sh && d[i] != next;
    ev[i] = sv;
    cd = __shfl_sync(kFull, d[i], 31);
    ch = __shfl_sync(kFull, sh, 31);
    cv = __shfl_sync(kFull, sv, 31);
  }
  send<R>(out, d, eh, ev);
}

// Rows of 32 consecutive slots (4-B loads, one stretch of the edge list per
// warp-wide access to out), each slot's dst and w read only if it sends.
template <typename C, typename T, typename K, bool USE_W>
__device__ __forceinline__ void relax_rows(const int* __restrict__ src,
                                           const int* __restrict__ dst,
                                           const float* __restrict__ w,
                                           const uint8_t* __restrict__ mask,
                                           const T* __restrict__ src_val, T* out, long long m,
                                           bool clamp) {
  using R = Reducer<T, K>;
  constexpr bool VM = C::kVertexMask;
  constexpr int kTile = 32 * kSlots;
  const int lane = threadIdx.x & 31;
  const long long ntiles = (m + kTile - 1) / kTile;
  const long long nwarps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long tile = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       tile < ntiles; tile += nwarps) {
    const long long base = tile * kTile + lane;
    int s[kSlots], d[kSlots];
    bool act[kSlots], has[kSlots];
    T v[kSlots], msg[kSlots];
    float wv[kSlots];
    // 1. the mask, then the source and its value
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const long long e = base + 32 * i;
      if constexpr (VM) {
        s[i] = e < m ? __ldcs(src + e) : -1;
      } else {
        act[i] = e < m && __ldcs(mask + e) != 0;
      }
    }
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const long long e = base + 32 * i;
      if constexpr (VM) {
        act[i] = s[i] >= 0 && __ldg(mask + s[i]) != 0;
        v[i] = s[i] >= 0 ? __ldg(src_val + s[i]) : T();
      } else {
        s[i] = act[i] ? __ldcs(src + e) : 0;
      }
    }
    if constexpr (!VM) {
#pragma unroll
      for (int i = 0; i < kSlots; ++i) v[i] = act[i] ? __ldg(src_val + s[i]) : T();
    }
    // 2. dst (and w) of the slots that send: active ones, and masked ones
    // under the clamp
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const long long e = base + 32 * i;
      has[i] = e < m && (act[i] || clamp);
      d[i] = has[i] ? __ldcs(dst + e) : -1;
      wv[i] = USE_W && act[i] ? __ldcs(w + e) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      msg[i] = act[i] ? edge_message<T, K, USE_W>(v[i], wv[i]) : R::neutral();
    }
    // 3. one atomic per run of equal dst where the warp holds such a run
    bool pair = false;
    int last = -2;  // dst of the slot before row i's lane 0: the row before's lane 31
    bool last_h = false;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int up = __shfl_up_sync(kFull, d[i], 1);
      const bool up_h = __shfl_up_sync(kFull, has[i], 1);
      const int pd = lane > 0 ? up : last;
      const bool ph = lane > 0 ? up_h : last_h;
      pair = pair || (has[i] && ph && d[i] == pd);
      last = __shfl_sync(kFull, d[i], 31);
      last_h = __shfl_sync(kFull, has[i], 31);
    }
    if (__any_sync(kFull, pair)) {
      send_runs_rows<R>(out, d, has, msg, lane);
    } else {
      send<R>(out, d, has, msg);
    }
  }
}

template <typename C, typename T, typename K, bool USE_W>
__global__ void __launch_bounds__(kRelaxThreads)
    edge_relax(const int* __restrict__ src, const int* __restrict__ dst, const float* __restrict__ w,
               const uint8_t* __restrict__ mask, const T* __restrict__ src_val, T* out, long long m,
               int head, bool aligned, const int* __restrict__ beyond) {
  bool clamp = false;
  if constexpr (Reducer<T, K>::kClamp) clamp = *beyond != 0;
  if constexpr (C::kRows) {
    relax_rows<C, T, K, USE_W>(src, dst, w, mask, src_val, out, m, clamp);
  } else {
    relax_lanes<C, T, K, USE_W>(src, dst, w, mask, src_val, out, m, head, aligned, clamp);
  }
}

// out = out_init; flags (beyond = 1) a seed beyond the reduction's neutral.
template <typename T, typename K>
__global__ void __launch_bounds__(kRelaxThreads)
    relax_seed(const T* __restrict__ in, T* __restrict__ out, long long n, int* beyond) {
  using R = Reducer<T, K>;
  bool any = false;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T x = in[i];
    out[i] = x;
    any = any || R::beyond(x);
  }
  if (__any_sync(kFull, any) && (threadIdx.x & 31) == 0) *beyond = 1;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

template <typename C, typename T, typename K, bool USE_W>
cudaError_t launch_relax(const int* src, const int* dst, const float* w, const uint8_t* mask,
                         const void* src_val, const void* out_init, void* out, long long m,
                         long long n_pad, int* flag, cudaStream_t st) {
  using R = Reducer<T, K>;
  const T* sv = static_cast<const T*>(src_val);
  T* o = static_cast<T*>(out);
  cudaError_t err;
  if constexpr (R::kClamp) {
    err = cudaMemsetAsync(flag, 0, sizeof(int), st);
    if (err != cudaSuccess) return err;
    const long long want = (n_pad + kRelaxThreads - 1) / kRelaxThreads;
    const int blocks = static_cast<int>(want < kMaxBlocks ? (want > 0 ? want : 1) : kMaxBlocks);
    relax_seed<T, K><<<blocks, kRelaxThreads, 0, st>>>(static_cast<const T*>(out_init), o, n_pad,
                                                       flag);
  } else {
    cudaMemcpyAsync(out, out_init, n_pad * sizeof(T), cudaMemcpyDeviceToDevice, st);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || m <= 0) return err;
  // the first group ends at src's first 16-B boundary; the vector loads need
  // every stream to reach that boundary at the same slot
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  int head = static_cast<int>(((16 - (a & 15)) & 15) / 4);
  if (head > m) head = static_cast<int>(m);
  const bool aligned = (a & 3) == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == (a & 15) &&
                       (!USE_W || (reinterpret_cast<uintptr_t>(w) & 15) == (a & 15)) &&
                       (C::kVertexMask || ((reinterpret_cast<uintptr_t>(mask) + head) & 3) == 0);
  if (!aligned) head = 0;
  // rows: one resident wave, grid-stride over the tiles; lanes: a block per
  // eight tiles (each measured faster on its own layout, slower on the other)
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, edge_relax<C, T, K, USE_W>,
                                                  kRelaxThreads, 0);
    if (per_sm <= 0) per_sm = 1;
  }
  const long long tiles = C::kRows ? (m + 32 * kSlots - 1) / (32 * kSlots)
                                   : (1 + (m - head + kSlots - 1) / kSlots + 31) / 32;
  const long long want = (tiles + kRelaxThreads / 32 - 1) / (kRelaxThreads / 32);
  const long long most = C::kRows ? static_cast<long long>(per_sm) * sm_count() : INT_MAX;
  const int blocks = static_cast<int>(want < most ? want : most);
  edge_relax<C, T, K, USE_W><<<blocks, kRelaxThreads, 0, st>>>(src, dst, w, mask, sv, o, m, head,
                                                              aligned, flag);
  return cudaGetLastError();
}

template <typename T, typename K, bool USE_W>
cudaError_t launch_relax_case(int relax_case, const int* src, const int* dst, const float* w,
                              const uint8_t* mask, const void* src_val, const void* out_init,
                              void* out, long long m, long long n_pad, int* flag,
                              cudaStream_t st) {
  switch (relax_case) {
    case CASE_PUSH:
      return launch_relax<Push, T, K, USE_W>(src, dst, w, mask, src_val, out_init, out, m, n_pad, flag, st);
    case CASE_PULL:
      return launch_relax<Pull, T, K, USE_W>(src, dst, w, mask, src_val, out_init, out, m, n_pad, flag, st);
    case CASE_BATCH:
      return launch_relax<Batch, T, K, USE_W>(src, dst, w, mask, src_val, out_init, out, m, n_pad, flag, st);
    case CASE_EDGES:
      return launch_relax<Edges, T, K, USE_W>(src, dst, w, mask, src_val, out_init, out, m, n_pad, flag, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, typename K>
cudaError_t launch_relax_w(bool use_w, int relax_case, const int* src, const int* dst,
                           const float* w, const uint8_t* mask, const void* src_val,
                           const void* out_init, void* out, long long m, long long n_pad, int* flag,
                           cudaStream_t st) {
  if (use_w) {
    return launch_relax_case<T, K, true>(relax_case, src, dst, w, mask, src_val, out_init, out, m,
                                         n_pad, flag, st);
  }
  return launch_relax_case<T, K, false>(relax_case, src, dst, w, mask, src_val, out_init, out, m,
                                        n_pad, flag, st);
}

// ---- advance ------------------------------------------------------------------

constexpr int kScanThreads = 256;
constexpr int kScanItems = 8;
constexpr int kScanTile = kScanThreads * kScanItems;  // frontier entries per tile
constexpr unsigned long long kAggregate = 1ull << 32;  // status: the tile's own sum
constexpr unsigned long long kPrefix = 2ull << 32;     // status: the inclusive prefix
constexpr int kExpandThreads = 256;
constexpr int kExpandTile = kExpandThreads * 4;  // output slots per block
constexpr int kStage = 2048;                     // frontier entries staged per block

__device__ __forceinline__ int warp_inclusive_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// One pass: cum = inclusive scan of out_deg[f_idx[i]] over i < live, by
// tiles in ticket order with decoupled look-back; the last live tile
// writes total (tile 0 writes 0 when live is 0).
__global__ void __launch_bounds__(kScanThreads)
    advance_scan(const int* __restrict__ f_idx, const int* __restrict__ f_count,
                 const int* __restrict__ out_deg, int cap, bool aligned, int* __restrict__ cum,
                 unsigned long long* status, unsigned int* ticket, int* __restrict__ total) {
  __shared__ int tile_s;
  __shared__ int excl_s;
  __shared__ int warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_s = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  const int t = tile_s;
  const int live = min(*f_count, cap);
  const long long base = static_cast<long long>(t) * kScanTile;
  if (base >= live) {
    if (t == 0 && threadIdx.x == 0) *total = 0;
    return;
  }
  const int i0 = static_cast<int>(base) + threadIdx.x * kScanItems;
  const bool vec = aligned && i0 + kScanItems <= live;
  int x[kScanItems];
  if (vec) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(f_idx + i0));
    const int4 b = __ldg(reinterpret_cast<const int4*>(f_idx + i0 + 4));
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) x[k] = i0 + k < live ? __ldg(f_idx + i0 + k) : -1;
  }
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) x[k] = x[k] >= 0 && i0 + k < live ? __ldg(out_deg + x[k]) : 0;
#pragma unroll
  for (int k = 1; k < kScanItems; ++k) x[k] += x[k - 1];
  const int mine = x[kScanItems - 1];
  const int incl = warp_inclusive_scan(mine);
  if (lane == 31) warp_sums[wid] = incl;
  __syncthreads();
  int before = 0, agg = 0;
#pragma unroll
  for (int i = 0; i < kScanThreads / 32; ++i) {
    const int s = warp_sums[i];
    before += i < wid ? s : 0;
    agg += s;
  }
  if (wid == 0) {
    int excl = 0;
    if (t == 0) {
      if (lane == 0) atomicExch(status, kPrefix | static_cast<unsigned int>(agg));
    } else {
      if (lane == 0) atomicExch(status + t, kAggregate | static_cast<unsigned int>(agg));
      // look back 32 predecessors at a time until one holds its prefix
      for (int pred = t - 1;; pred -= 32) {
        const int idx = pred - lane;
        unsigned long long st = kPrefix;  // before tile 0: an empty prefix
        do {
          if (idx >= 0) st = *reinterpret_cast<volatile unsigned long long*>(status + idx);
        } while (__any_sync(kFull, (st >> 32) == 0));
        const unsigned int done = __ballot_sync(kFull, (st >> 32) == 2);
        const int last = done ? __ffs(done) - 1 : 31;
        excl += warp_sum(lane <= last ? static_cast<int>(static_cast<unsigned int>(st)) : 0);
        if (done) break;
      }
      if (lane == 0) atomicExch(status + t, kPrefix | static_cast<unsigned int>(excl + agg));
    }
    if (lane == 0) excl_s = excl;
  }
  __syncthreads();
  const int off = excl_s + before + incl - mine;
  if (vec) {
    *reinterpret_cast<int4*>(cum + i0) = make_int4(off + x[0], off + x[1], off + x[2], off + x[3]);
    *reinterpret_cast<int4*>(cum + i0 + 4) =
        make_int4(off + x[4], off + x[5], off + x[6], off + x[7]);
  } else {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      if (i0 + k < live) cum[i0 + k] = off + x[k];
    }
  }
  if (base + kScanTile >= live && threadIdx.x == 0) *total = excl_s + agg;
}

// The warp's upper bound of key in cum[0, n): the first index whose value
// exceeds key (n if none), by 32-ary search.
__device__ __forceinline__ int warp_upper_bound(const int* __restrict__ cum, int n, int key) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const long long span = hi - lo;
    const int q = lo + static_cast<int>((lane + 1) * span / 32) - 1;
    const unsigned int gt = __ballot_sync(kFull, __ldg(cum + q) > key);
    if (gt == 0) return hi;
    const int f = __ffs(gt) - 1;
    const int qf = lo + static_cast<int>((f + 1) * span / 32) - 1;
    const int qp = f > 0 ? lo + static_cast<int>(f * span / 32) - 1 : lo - 1;
    lo = qp + 1;
    hi = qf;
  }
  const int q = lo + lane;
  const unsigned int gt = __ballot_sync(kFull, q < hi && __ldg(cum + q) > key);
  return gt ? lo + __ffs(gt) - 1 : hi;
}

__global__ void __launch_bounds__(kExpandThreads)
    advance_expand(const int* __restrict__ f_idx, const int* __restrict__ cum,
                   const int* __restrict__ f_count, int cap, const int* __restrict__ total_p,
                   const int* __restrict__ row_ptr, const int* __restrict__ col_idx,
                   const float* __restrict__ edge_w, int budget, int sentinel, int m_pad,
                   bool vec_out, int* __restrict__ out_src, int* __restrict__ out_dst,
                   float* __restrict__ out_w, uint8_t* __restrict__ out_valid) {
  __shared__ int s_cum[kStage];
  __shared__ int s_u[kStage];
  __shared__ int s_row[kStage];
  __shared__ int s_k[2];
  const int total = *total_p;
  const int j0 = blockIdx.x * kExpandTile;
  const int jt = j0 + threadIdx.x * 4;
  int u[4], dd[4];
  float ww[4];
  bool ok[4];
  if (j0 >= total) {
    // padding slots: the sentinel and edge m_pad - 1, no search
    const int pd = __ldg(col_idx + m_pad - 1);
    const float pw = __ldg(edge_w + m_pad - 1);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      u[i] = sentinel;
      dd[i] = pd;
      ww[i] = pw;
      ok[i] = false;
    }
  } else {
    const int live = min(*f_count, cap);
    const int wid = threadIdx.x >> 5;
    if (wid < 2) {
      const int key = wid == 0 ? j0 : min(j0 + kExpandTile, min(total, budget)) - 1;
      const int k = warp_upper_bound(cum, live, key);
      if ((threadIdx.x & 31) == 0) s_k[wid] = k;
    }
    __syncthreads();
    const int k0 = s_k[0];
    const int nk = s_k[1] - k0 + 1;
    const bool staged = nk <= kStage;
    if (staged) {
      for (int i = threadIdx.x; i < nk; i += kExpandThreads) {
        const int uu = __ldg(f_idx + k0 + i);
        s_cum[i] = __ldg(cum + k0 + i);
        s_u[i] = uu;
        s_row[i] = __ldg(row_ptr + uu);
      }
    }
    const int prev0 = k0 > 0 ? __ldg(cum + k0 - 1) : 0;
    __syncthreads();
    int e[4];
    int k = -1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = jt + i;
      ok[i] = j < total && j < budget;
      u[i] = sentinel;
      e[i] = m_pad - 1;
      if (!ok[i]) continue;
      if (staged) {
        if (k < 0) {  // upper bound of j in s_cum[0, nk)
          int lo = 0, hi = nk - 1;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (s_cum[mid] <= j) {
              lo = mid + 1;
            } else {
              hi = mid;
            }
          }
          k = lo;
        }
        while (s_cum[k] <= j) ++k;  // zero-degree entries repeat cum
        const int prev = k > 0 ? s_cum[k - 1] : prev0;
        u[i] = s_u[k];
        e[i] = s_row[k] + (j - prev);
      } else {
        int lo = k0, hi = k0 + nk - 1;  // the answer lies in [k0, k1]
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (__ldg(cum + mid) <= j) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        const int prev = lo > 0 ? __ldg(cum + lo - 1) : 0;
        u[i] = __ldg(f_idx + lo);
        e[i] = __ldg(row_ptr + u[i]) + (j - prev);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dd[i] = __ldg(col_idx + e[i]);
      ww[i] = __ldg(edge_w + e[i]);
    }
  }
  if (vec_out && jt + 4 <= budget) {
    *reinterpret_cast<int4*>(out_src + jt) = make_int4(u[0], u[1], u[2], u[3]);
    *reinterpret_cast<int4*>(out_dst + jt) = make_int4(dd[0], dd[1], dd[2], dd[3]);
    *reinterpret_cast<float4*>(out_w + jt) = make_float4(ww[0], ww[1], ww[2], ww[3]);
    *reinterpret_cast<unsigned int*>(out_valid + jt) =
        (ok[0] ? 1u : 0u) | (ok[1] ? 1u << 8 : 0u) | (ok[2] ? 1u << 16 : 0u) |
        (ok[3] ? 1u << 24 : 0u);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (jt + i < budget) {
        out_src[jt + i] = u[i];
        out_dst[jt + i] = dd[i];
        out_w[jt + i] = ww[i];
        out_valid[jt + i] = ok[i] ? 1 : 0;
      }
    }
  }
}

// ---- intersect ------------------------------------------------------------

constexpr int kIntersectThreads = 256;

__global__ void intersect_kernel(const int* __restrict__ adj, int n_rows, int dmax,
                                 const int* __restrict__ src, const int* __restrict__ dst,
                                 long long e, int sentinel, int* count) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  int hits = 0;
  for (long long i = warp; i < e; i += nwarps) {
    const int s = src[i];
    const int d = dst[i];
    if (s < 0 || s >= n_rows || d < 0 || d >= n_rows) continue;  // warp-uniform
    const int* rs = adj + static_cast<long long>(s) * dmax;
    const int* rd = adj + static_cast<long long>(d) * dmax;
    // real length of the target row: index of its first sentinel
    int len_d = dmax;
    for (int base = 0; base < dmax; base += 32) {
      const int j = base + lane;
      const unsigned at_end = __ballot_sync(full, j < dmax && rd[j] == sentinel);
      if (at_end) {
        len_d = base + __ffs(at_end) - 1;
        break;
      }
    }
    if (len_d == 0) continue;
    // candidates: the lanes stride over the source row up to its first sentinel
    for (int base = 0; base < dmax; base += 32) {
      const int j = base + lane;
      const int w = j < dmax ? rs[j] : sentinel;
      const bool live = w != sentinel;
      if (live) {
        int lo = 0, hi = len_d;  // lower bound of w in rd[0, len_d)
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (rd[mid] < w) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        hits += (lo < len_d && rd[lo] == w) ? 1 : 0;
      }
      if (__ballot_sync(full, !live)) break;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) hits += __shfl_down_sync(full, hits, o);
  if (lane == 0 && hits != 0) atomicAdd(count, hits);
}

}  // namespace

extern "C" {

const char* graph_ops_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype: DT_F32 / DT_I32 / DT_U8; kind: KIND_*; relax_case: CASE_* (push
// and pull take a vertex mask, batch and edges a per-slot one).  mask is
// bool (one byte): (n_pad,) for a vertex mask, else (m,).  out (n_pad,)
// receives out_init reduced with the messages; flag: (1,) int32 scratch.
int graph_ops_edge_relax(const void* src, const void* dst, const void* w, const void* mask,
                         const void* src_val, const void* out_init, void* out, long long m,
                         long long n_pad, int dtype, int kind, int use_weight, int relax_case,
                         void* flag, void* stream) {
  const int* s = static_cast<const int*>(src);
  const int* d = static_cast<const int*>(dst);
  const float* ww = static_cast<const float*>(w);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  int* f = static_cast<int*>(flag);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool uw = use_weight != 0;
  const int c = relax_case;
  if (dtype == DT_F32) {
    if (kind == KIND_MIN) return launch_relax_w<float, Min>(uw, c, s, d, ww, mk, src_val, out_init, out, m, n_pad, f, st);
    if (kind == KIND_MAX) return launch_relax_w<float, Max>(uw, c, s, d, ww, mk, src_val, out_init, out, m, n_pad, f, st);
    if (kind == KIND_ADD) return launch_relax_w<float, Add>(uw, c, s, d, ww, mk, src_val, out_init, out, m, n_pad, f, st);
  } else if (dtype == DT_I32 && !uw) {
    if (kind == KIND_MIN) return launch_relax_case<int, Min, false>(c, s, d, ww, mk, src_val, out_init, out, m, n_pad, f, st);
    if (kind == KIND_MAX) return launch_relax_case<int, Max, false>(c, s, d, ww, mk, src_val, out_init, out, m, n_pad, f, st);
    if (kind == KIND_ADD) return launch_relax_case<int, Add, false>(c, s, d, ww, mk, src_val, out_init, out, m, n_pad, f, st);
  } else if (dtype == DT_U8 && !uw && kind == KIND_OR) {
    return launch_relax_case<uint8_t, Or, false>(c, s, d, ww, mk, src_val, out_init, out, m, n_pad, f, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// cum_scratch: (cap,) int32; tile_scratch: (2 * ceil(cap / 2048) + 2,)
// int32, 8-byte aligned (the tiles' status words and the ticket, reset
// here); total: (1,) int32 output; out_*: (budget,) outputs (valid is bool).
int graph_ops_advance(const void* f_idx, const void* f_count, const void* out_deg,
                      const void* row_ptr, const void* col_idx, const void* edge_w, int cap,
                      int budget, int sentinel, int m_pad, void* cum_scratch, void* tile_scratch,
                      void* total, void* out_src, void* out_dst, void* out_w, void* out_valid,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = (cap + kScanTile - 1) / kScanTile;
  unsigned long long* status = static_cast<unsigned long long*>(tile_scratch);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(status + ntiles);
  int* cum = static_cast<int*>(cum_scratch);
  int* tot = static_cast<int*>(total);
  const int* fi = static_cast<const int*>(f_idx);
  cudaError_t err = cudaMemsetAsync(tile_scratch, 0, (ntiles + 1) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned = ((reinterpret_cast<uintptr_t>(fi) | reinterpret_cast<uintptr_t>(cum)) & 15) == 0;
  advance_scan<<<ntiles, kScanThreads, 0, st>>>(fi, static_cast<const int*>(f_count),
                                                static_cast<const int*>(out_deg), cap, aligned, cum,
                                                status, ticket, tot);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec_out = ((reinterpret_cast<uintptr_t>(out_src) | reinterpret_cast<uintptr_t>(out_dst) |
                         reinterpret_cast<uintptr_t>(out_w)) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(out_valid) & 3) == 0;
  const int blocks = (budget + kExpandTile - 1) / kExpandTile;
  advance_expand<<<blocks, kExpandThreads, 0, st>>>(
      fi, cum, static_cast<const int*>(f_count), cap, tot, static_cast<const int*>(row_ptr),
      static_cast<const int*>(col_idx), static_cast<const float*>(edge_w), budget, sentinel, m_pad,
      vec_out, static_cast<int*>(out_src), static_cast<int*>(out_dst), static_cast<float*>(out_w),
      static_cast<uint8_t*>(out_valid));
  return static_cast<int>(cudaGetLastError());
}

// adj: (n_rows, dmax) int32, rows sorted, sentinel-padded; src, dst: (e,)
// int32, e > 0; count: (1,) int32, zeroed by the caller, receives the sum.
int graph_ops_intersect(const void* adj, int n_rows, int dmax, const void* src, const void* dst,
                        long long e, int sentinel, void* count, void* stream) {
  const long long warps_per_block = kIntersectThreads / 32;
  const long long want = (e + warps_per_block - 1) / warps_per_block;
  const int blocks = static_cast<int>(want < kMaxBlocks ? (want > 0 ? want : 1) : kMaxBlocks);
  intersect_kernel<<<blocks, kIntersectThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(adj), n_rows, dmax, static_cast<const int*>(src),
      static_cast<const int*>(dst), e, sentinel, static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
