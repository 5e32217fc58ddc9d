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
//   The gate: an optional 0-d int32 on the device (null: none).  When it
//   holds 0 the launch's result is out_init: out is seeded as always, and
//   every block of the relax reads the gate first and returns.  The sharded
//   sparse round (core/sharded.py) launches, per shard, the sparse relax of
//   its advance gated on the shard not escalating and the dense relax of its
//   masked edges gated on it escalating: a captured round cannot branch on
//   the host, and running both under masks would sweep every shard's edges
//   each round.  The plain version is torch.where(gate, relaxed, out_init).
//
//   Kernel names tell the cases apart in a profile:
//   edge_relax<Push|Pull|Batch|Edges, dtype, Min|Max|Add|Or, weighted>, the
//   case passed by the operator seam (push_dense, pull_dense and the
//   reversed push, relax_batch, relax_edges); relax_seed<dtype, kind>.
//
// ---------------------------------------------------------------------------
// edge_relax_lanes — replaces _edge_relax_kernel under jax.vmap over B lanes
//   (src/repro/kernels/graph_ops/graph_ops.py, vmapped by the multi-source
//   operators at src/repro/core/operators.py:349-358 and :383-392).
//
//   The multi-source relax: B label lanes share one edge list.  src_val,
//   out_init and the frontier are (B, n_pad) row-major; for each edge slot e
//   and lane b, the message of src_val[b, src[e]] (edge_relax's) is sent
//   into out[b, dst[e]] when active[b, src[e]] (and, for a batch, valid[e]),
//   else the reduction's neutral, as ref.batched_push_ref /
//   batched_relax_ref compute it.  Per lane this is edge_relax's function,
//   with the same reductions (ordered-int f32 min/max, native int32, f32
//   atomicAdd, the byte CAS for 'or'), so min/max/int/or rows are bitwise
//   the plain version's and f32 add allclose.
//
//   Bound: device-memory bytes.  A slot reads src (4 B) and its lane word
//   (a vertex array); dst and w only when some lane sends; each sending
//   lane gathers src_val[b, s] and reads and updates out[b, d].  The
//   vmapped TPU kernel read every slot B times; the point of the lanes is
//   one read of each slot for all B (the MS-BFS amortisation).
//
//   Design.  The first version was a seed pass that copied all of out_init
//   into out, packed the words and found the clamped lanes, then one slot a
//   thread over the list.  What held it (PERF.md): on the serving path the seed copy, an
//   O(B n_pad) pass on every round however sparse, and the caller's compare
//   of both matrices for the changed lanes; on a dense push, each message
//   an atomic at a random out[b, d] of a matrix larger than L2.  Now one
//   launch takes up to 32 lanes (the wrapper splits B > 32 into groups of
//   32, one launch each) in two passes:
//     * lanes_prep packs the lane word of each vertex (bit b: active[b, v];
//       the MS-BFS bit field) and, given a seed, copies it into out there:
//       at every vertex (the out-of-place route; a full seed also finds the
//       lanes with a seed beyond the neutral, relax_seed's flag per lane),
//       or only at the vertices the caller lists and the sentinel column (a
//       sparse round's reseed: the round's two label buffers differ only
//       where the last round changed a label, which is this round's
//       frontier; a valid batch slot reads no other word).  In place and
//       without a list it packs the words and copies nothing.
//     * the relax (push over the CSR, or a batch over advance's output:
//       dst random): one slot a thread, grid-stride; word = words[src] (an
//       invalid batch slot reads neither), a slot with no lane to send
//       reads no dst and no w, else it loops over the word's set bits, each
//       gathering src_val[b * n_pad + s] (lane-major) and sending its
//       message.  The clamp: the plain version's masked slots send the
//       neutral, which clamps a seed beyond it (+inf under f32 min) at the
//       dst they name; a lane whose seeds may lie beyond (a full seed found
//       one, or the caller says so) joins every slot's lanes, sending the
//       neutral where the slot is masked in it (an active slot sends its own
//       message, which may itself be +inf).  A pass of its own before the
//       relax, which let the relax visit only set lanes, was slower
//       (PERF.md): it read src, the words and dst of every slot again and
//       still read out once per masked slot, and a full seed, which cannot
//       tell the host whether a lane clamps, always launched it.  A route
//       over the CSC mirror (dst sorted: each lane's runs of equal dst
//       combined in registers, out swept nearly in order) was slower too
//       (PERF.md): the CSC order makes every lane word and src_val gather
//       random, where the CSR's sorted src reads them in order and only out
//       is random; so was an L2 persisting window on the lane words.  A read
//       of out first skips what cannot change it (min/max/or), as in
//       edge_relax.
//     * changed lanes (min, max, or; optional): an atomic that moved out[b,
//       d] returns the value before it, and the thread sets changed[b, d]
//       when the two compare unequal as T.  The values out[b, d] takes form
//       a chain of strictly lower (higher) keys; the float compare differs
//       from the key order only between -0.0 and +0.0, which are adjacent
//       keys, so some step of the chain compares unequal exactly when the
//       last value compares unequal to the seed: the mask is the caller's
//       `new != old` for every seed but NaN (which compares unequal to
//       itself, moved or not).  The sentinel column is never set.  The mask
//       must be all False before the call (only set bits are written).
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
//   adj[src[i]] with w != sentinel that occur in adj[dst[i]], and adds
//   them into the int32 partial of edge i's chunk.  Any correct
//   membership test gives the reference's integer, so the result is
//   bitwise equal to ref.intersect_ref.
//
//   Bound: device-memory bytes — src and dst once (8 B an edge) plus each
//   adjacency row the batch touches, real entries only, 4 B each.  The
//   operations (one compare per probe) are far below the card's rate; what
//   costs is latency: a membership test is a chain of dependent loads.
//
//   Design: the TPU kernel held all of adj in VMEM and carried the scalar
//   across its sequential grid.  A first port gave each edge one warp,
//   which left most lanes idle (the web graph's oriented rows average 12.5)
//   and chained every probe to device memory.  Here the work is the
//   candidates (edge i, j < row_len[src[i]]), spread evenly over threads:
//     * intersect_scan: advance_scan's single pass (scan_tiles) over the
//       candidate mass row_len[src[i]] of each edge (0 when an endpoint is
//       not a row of adj, as for the padding edges, whose row is the
//       sentinel's: empty).  row_len comes from the wrapper (one pass over
//       adj a call; tc_count makes one call), so no warp looks for a row's
//       first sentinel.  The scan
//       also writes each edge's target-row length (tlen), records, for
//       every tile of kITile = 2,048 candidates, the edge that holds its
//       first (tile_k), and zeroes the partial counts.
//     * intersect_count: one resident wave of blocks strides over the
//       tiles.  A tile's edges are tile_k[t] .. tile_k[t + 1] (every real
//       edge holds a candidate, so at most 2,049); up to kIEdges = 1,024 of
//       them are staged in shared memory with a block scan of their tlen,
//       and those rows are copied in, warp by warp with neighbouring lanes
//       on neighbouring entries, until kIRows = 6,144 entries are full.  A
//       warp takes 256 consecutive candidates, each lane 8 of them 32
//       apart, so neighbouring lanes load neighbouring entries of a source
//       row and, on a long row, bisect the same target row.  A lane finds
//       its first candidate's edge by bisecting the staged scan and loads
//       its 8 candidates before the rows are copied, so both loads share
//       one wait; then it bisects each candidate's row, in the stage or,
//       for a row past it (or a tile of more than kIEdges edges), in
//       device memory.  A block reads its next tile's tile_k during this
//       one.  Each of these steps removed a dependent round of
//       device-memory loads from a tile (PERF.md §6).  Measured and not
//       built: a thread taking 8 consecutive candidates, each bisected from
//       where the last of the same edge ended (5-11% slower on the whole
//       web and kron lists), a lockstep (fixed-trip) bisection, and a
//       forward merge of a thread's candidates through their rows.
//     * The launch covers many chunks of tc_count's edge list: every
//       ``chunk`` edges own one int32 partial.  A warp adds its tile's hits
//       into the partial of the tile's first edge with one atomic; a hit
//       in an edge of a later chunk goes to that chunk's partial alone.
//       Integer sums in any order are exact, so each partial, and the
//       total, is bitwise the plain version's.
//   Row indices outside [0, n_rows) contribute 0 (the reference's gather
//   clamps them to the all-sentinel last row).  The wrapper keeps
//   e * dmax below 2^31, so every candidate index is an int32.
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
// (kClamp) and whether a read of out[dst] comes before the atomic
// (kReadFirst: the kinds that only move one way).  Those kinds also have
// moved(): the atomic, returning whether it moved *p to a value that
// compares unequal (as T) to the one before it.
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
  static __device__ __forceinline__ bool moved(float* p, float msg) {
    const int b = __float_as_int(msg);
    const float prev =
        b >= 0 ? __int_as_float(atomicMin(reinterpret_cast<int*>(p), b))
               : __uint_as_float(atomicMax(reinterpret_cast<unsigned int*>(p),
                                           static_cast<unsigned int>(b)));
    return changes(msg, prev) && msg != prev;
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
  static __device__ __forceinline__ bool moved(float* p, float msg) {
    const int b = __float_as_int(msg);
    const float prev =
        b >= 0 ? __int_as_float(atomicMax(reinterpret_cast<int*>(p), b))
               : __uint_as_float(atomicMin(reinterpret_cast<unsigned int*>(p),
                                           static_cast<unsigned int>(b)));
    return changes(msg, prev) && msg != prev;
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
  static __device__ __forceinline__ bool moved(int* p, int msg) { return atomicMin(p, msg) > msg; }
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
  static __device__ __forceinline__ bool moved(int* p, int msg) { return atomicMax(p, msg) < msg; }
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
  static __device__ __forceinline__ void atomic(uint8_t* p, uint8_t msg) { moved(p, msg); }
  static __device__ __forceinline__ bool moved(uint8_t* p, uint8_t msg) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
    unsigned int* word = reinterpret_cast<unsigned int*>(addr & ~uintptr_t(3));
    const unsigned int shift = static_cast<unsigned int>(addr & 3) * 8u;
    unsigned int old = *reinterpret_cast<volatile unsigned int*>(word);
    while (true) {
      const unsigned int cur = (old >> shift) & 0xffu;
      if (cur >= msg) return false;
      const unsigned int repl = (old & ~(0xffu << shift)) | (static_cast<unsigned int>(msg) << shift);
      const unsigned int seen = atomicCAS(word, old, repl);
      if (seen == old) return true;
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
               int head, bool aligned, const int* __restrict__ beyond,
               const int* __restrict__ gate) {
  if (gate != nullptr && *gate == 0) return;  // out keeps the seed: out_init
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

constexpr int kDevices = 64;  // devices whose SM count is kept

// the current device's SM count, looked up once per device
int sm_count() {
  static int by_dev[kDevices] = {};
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < kDevices && by_dev[dev] > 0) return by_dev[dev];
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (n <= 0) n = 132;
  if (dev >= 0 && dev < kDevices) by_dev[dev] = n;
  return n;
}

template <typename C, typename T, typename K, bool USE_W>
cudaError_t launch_relax(const int* src, const int* dst, const float* w, const uint8_t* mask,
                         const void* src_val, const void* out_init, void* out, long long m,
                         long long n_pad, int* flag, const int* gate, cudaStream_t st) {
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
                                                              aligned, flag, gate);
  return cudaGetLastError();
}

template <typename T, typename K, bool USE_W>
cudaError_t launch_relax_case(int relax_case, const int* src, const int* dst, const float* w,
                              const uint8_t* mask, const void* src_val, const void* out_init,
                              void* out, long long m, long long n_pad, int* flag, const int* gate,
                              cudaStream_t st) {
  switch (relax_case) {
    case CASE_PUSH:
      return launch_relax<Push, T, K, USE_W>(src, dst, w, mask, src_val, out_init, out, m, n_pad, flag, gate, st);
    case CASE_PULL:
      return launch_relax<Pull, T, K, USE_W>(src, dst, w, mask, src_val, out_init, out, m, n_pad, flag, gate, st);
    case CASE_BATCH:
      return launch_relax<Batch, T, K, USE_W>(src, dst, w, mask, src_val, out_init, out, m, n_pad, flag, gate, st);
    case CASE_EDGES:
      return launch_relax<Edges, T, K, USE_W>(src, dst, w, mask, src_val, out_init, out, m, n_pad, flag, gate, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, typename K>
cudaError_t launch_relax_w(bool use_w, int relax_case, const int* src, const int* dst,
                           const float* w, const uint8_t* mask, const void* src_val,
                           const void* out_init, void* out, long long m, long long n_pad, int* flag,
                           const int* gate, cudaStream_t st) {
  if (use_w) {
    return launch_relax_case<T, K, true>(relax_case, src, dst, w, mask, src_val, out_init, out, m,
                                         n_pad, flag, gate, st);
  }
  return launch_relax_case<T, K, false>(relax_case, src, dst, w, mask, src_val, out_init, out, m,
                                        n_pad, flag, gate, st);
}

// ---- edge_relax_lanes -----------------------------------------------------------

constexpr int kLanes = 32;  // lanes a launch takes: the bits of a lane word

// The prep pass: words[v] = the lanes active at v (bit b: active[b, v]) and,
// with a seed, out = seed at v in every lane.  AT: at the listed vertices
// and the sentinel column (v = n - 1) only; else at every vertex, where a
// seed also sets bit b of *far when a seed of lane b lies beyond the
// reduction's neutral (relax_seed's flag, one bit a lane).
template <typename T, typename K, bool AT, bool SEED>
__global__ void __launch_bounds__(kRelaxThreads)
    lanes_prep(const uint8_t* __restrict__ active, const int* __restrict__ at, long long n_at,
               const T* __restrict__ seed, T* __restrict__ out, unsigned int* __restrict__ words,
               long long n, int lanes, unsigned int* __restrict__ far) {
  using R = Reducer<T, K>;
  unsigned int beyond = 0;
  const long long count = AT ? n_at + 1 : n;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; t < count;
       t += stride) {
    const long long v = AT ? (t < n_at ? static_cast<long long>(__ldg(at + t)) : n - 1) : t;
    unsigned int word = 0;
    for (int b = 0; b < lanes; ++b) {
      const long long i = b * n + v;
      if constexpr (SEED) {
        const T x = seed[i];
        out[i] = x;
        if constexpr (!AT && R::kClamp) {
          if (R::beyond(x)) beyond |= 1u << b;
        }
      }
      if (active[i]) word |= 1u << b;
    }
    words[v] = word;
  }
  if constexpr (!AT && SEED && R::kClamp) {
    beyond = __reduce_or_sync(kFull, beyond);
    if (beyond != 0 && (threadIdx.x & 31) == 0) atomicOr(far, beyond);
  }
}

// The lanes flagged in a (lanes,) byte mask, as a lane word.
__device__ __forceinline__ unsigned int lane_word(const uint8_t* __restrict__ bytes, int lanes) {
  unsigned int word = 0;
  for (int b = 0; b < lanes; ++b) {
    if (bytes[b] != 0) word |= 1u << b;
  }
  return word;
}

// Reduce msg into *p, a read first skipping what cannot change it
// (min/max/or).  CH: set *flag (the changed byte, or null in the sentinel
// column) when the atomic moved *p to a value unequal to the one before.
template <typename R, bool CH, typename T>
__device__ __forceinline__ void relax_one(T* p, T msg, uint8_t* flag) {
  if (R::kReadFirst && !R::changes(msg, read_out(p))) return;
  if constexpr (CH) {
    if (R::moved(p, msg) && flag != nullptr) *flag = 1;
  } else {
    R::atomic(p, msg);
  }
}

// The clamp word of a launch: *far (a full seed's), else the caller's
// (lanes,) byte mask of lanes whose seeds may lie beyond the neutral, else 0.
template <typename R>
__device__ __forceinline__ unsigned int clamp_word(const unsigned int* __restrict__ far,
                                                   const uint8_t* __restrict__ beyond,
                                                   int lanes) {
  if constexpr (!R::kClamp) return 0u;
  if (far != nullptr) return *far;
  return beyond != nullptr ? lane_word(beyond, lanes) : 0u;
}

// The relax (push over the CSR, or a batch over advance's output: dst
// random): one slot a thread, grid-stride over a resident wave.  word =
// words[src[e]] (an invalid batch slot reads neither src nor its word); a
// slot with no lane to send reads no dst and no w, else it reads them once
// and loops over the set bits of word | clamp: a set lane gathers
// src_val[b * n + s] (lane-major) and sends its message, a clamped lane in
// which the slot is masked sends the neutral.
template <typename C, typename T, typename K, bool USE_W, bool CH>
__global__ void __launch_bounds__(kRelaxThreads)
    edge_relax_lanes(const int* __restrict__ src, const int* __restrict__ dst,
                     const float* __restrict__ w, const uint8_t* __restrict__ valid,
                     const unsigned int* __restrict__ words, const T* __restrict__ src_val, T* out,
                     uint8_t* changed, long long m, long long n,
                     const unsigned int* __restrict__ far, const uint8_t* __restrict__ beyond,
                     int lanes) {
  using R = Reducer<T, K>;
  const unsigned int clamp = clamp_word<R>(far, beyond, lanes);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < m;
       e += stride) {
    int s = 0;
    unsigned int word = 0;
    if constexpr (!C::kVertexMask) {
      const bool ok = __ldcs(valid + e) != 0;
      if (!ok && clamp == 0) continue;
      if (ok) {
        s = __ldcs(src + e);
        word = __ldg(words + s);
      }
    } else {
      s = __ldcs(src + e);
      word = __ldg(words + s);
    }
    const unsigned int send = word | clamp;
    if (send == 0) continue;
    const int d = __ldcs(dst + e);
    const float wt = USE_W && word != 0 ? __ldcs(w + e) : 0.0f;
    for (unsigned int left = send; left != 0; left &= left - 1) {
      const int b = __ffs(left) - 1;
      const long long row = static_cast<long long>(b) * n;
      const T msg = (word >> b) & 1u ? edge_message<T, K, USE_W>(__ldg(src_val + row + s), wt)
                                     : R::neutral();
      T* p = out + row + d;
      relax_one<R, CH>(p, msg, CH && d != n - 1 ? changed + row + d : nullptr);
    }
  }
}

// One launch's arguments (one group of up to 32 lanes).
struct Lanes {
  const int* src;
  const int* dst;
  const float* w;
  const uint8_t* valid;   // the batch's slot mask, or null: a push
  const uint8_t* active;  // (lanes, n) frontier
  const void* src_val;
  const void* seed;       // copied into out first (at `at` only, with `at`), or null
  void* out;
  long long m;
  long long n;
  int lanes;
  const int* at;          // the vertices whose words the slots read, or null: every vertex
  long long n_at;
  uint8_t* changed;       // (lanes, n) bytes, or null
  const uint8_t* beyond;  // (lanes,) bytes: lanes whose seeds may lie beyond the neutral
  unsigned int* words;    // (n,) scratch
  unsigned int* far;      // (1,) scratch: the seed pass's beyond word
  cudaStream_t st;
  const unsigned int* clamp_far;  // far once a full seed has filled it, else null
};

template <typename C, typename T, typename K, bool USE_W, bool CH>
cudaError_t launch_lanes_relax(const Lanes& a) {
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, edge_relax_lanes<C, T, K, USE_W, CH>,
                                                  kRelaxThreads, 0);
    if (per_sm <= 0) per_sm = 1;
  }
  const long long want = (a.m + kRelaxThreads - 1) / kRelaxThreads;
  const long long most = static_cast<long long>(per_sm) * sm_count();
  const int blocks = static_cast<int>(want < most ? want : most);
  edge_relax_lanes<C, T, K, USE_W, CH><<<blocks, kRelaxThreads, 0, a.st>>>(
      a.src, a.dst, a.w, a.valid, a.words, static_cast<const T*>(a.src_val),
      static_cast<T*>(a.out), a.changed, a.m, a.n, a.clamp_far, a.beyond, a.lanes);
  return cudaGetLastError();
}

template <typename C, typename T, typename K, bool USE_W>
cudaError_t launch_lanes_changed(const Lanes& a) {
  if (a.changed == nullptr) return launch_lanes_relax<C, T, K, USE_W, false>(a);
  if constexpr (Reducer<T, K>::kReadFirst) {
    return launch_lanes_relax<C, T, K, USE_W, true>(a);
  } else {
    return cudaErrorInvalidValue;  // add: a sum has no changed lanes to report
  }
}

// the prep pass, then the relax (a push without valid, else a batch)
template <typename T, typename K, bool USE_W>
cudaError_t launch_lanes(Lanes a) {
  using R = Reducer<T, K>;
  const bool batch = a.valid != nullptr;
  if (a.lanes < 1 || a.lanes > kLanes || a.n <= 0 || (a.at != nullptr && !batch)) {
    return cudaErrorInvalidValue;
  }
  const T* seed = static_cast<const T*>(a.seed);
  T* o = static_cast<T*>(a.out);
  cudaError_t err;
  const long long count = a.at != nullptr ? a.n_at + 1 : a.n;
  const long long want = (count + kRelaxThreads - 1) / kRelaxThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  a.clamp_far = nullptr;
  if (a.at != nullptr) {
    if (seed != nullptr) {
      lanes_prep<T, K, true, true><<<blocks, kRelaxThreads, 0, a.st>>>(
          a.active, a.at, a.n_at, seed, o, a.words, a.n, a.lanes, a.far);
    } else {
      lanes_prep<T, K, true, false><<<blocks, kRelaxThreads, 0, a.st>>>(
          a.active, a.at, a.n_at, seed, o, a.words, a.n, a.lanes, a.far);
    }
  } else if (seed != nullptr) {
    if constexpr (R::kClamp) {
      err = cudaMemsetAsync(a.far, 0, sizeof(unsigned int), a.st);
      if (err != cudaSuccess) return err;
      a.clamp_far = a.far;
    }
    lanes_prep<T, K, false, true><<<blocks, kRelaxThreads, 0, a.st>>>(
        a.active, a.at, a.n_at, seed, o, a.words, a.n, a.lanes, a.far);
  } else {
    lanes_prep<T, K, false, false><<<blocks, kRelaxThreads, 0, a.st>>>(
        a.active, a.at, a.n_at, seed, o, a.words, a.n, a.lanes, a.far);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || a.m <= 0) return err;
  if (batch) return launch_lanes_changed<Batch, T, K, USE_W>(a);
  return launch_lanes_changed<Push, T, K, USE_W>(a);
}

template <typename T, typename K>
cudaError_t launch_lanes_w(bool use_w, const Lanes& a) {
  if (use_w) return launch_lanes<T, K, true>(a);
  return launch_lanes<T, K, false>(a);
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

// One pass: cum = inclusive scan of the entries' masses over i < live, by
// tiles in ticket order with decoupled look-back; the last live tile
// writes total (tile 0 writes 0 when live is 0).  ``mass.load`` reads a
// thread's kScanItems consecutive masses (0 at or past live; ``vec``: the
// run is whole and 16-B aligned); ``mass.emit`` sees each entry's inclusive
// prefix after the scan.
template <class Mass>
__device__ __forceinline__ void scan_tiles(const Mass& mass, int live, bool aligned,
                                           int* __restrict__ cum, unsigned long long* status,
                                           unsigned int* ticket, int* __restrict__ total) {
  __shared__ int tile_s;
  __shared__ int excl_s;
  __shared__ int warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_s = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  const int t = tile_s;
  const long long base = static_cast<long long>(t) * kScanTile;
  if (base >= live) {
    if (t == 0 && threadIdx.x == 0) *total = 0;
    return;
  }
  const int i0 = static_cast<int>(base) + threadIdx.x * kScanItems;
  const bool vec = aligned && i0 + kScanItems <= live;
  int x[kScanItems];
  mass.load(i0, live, vec, x);
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
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) x[k] += off;
  if (vec) {
    *reinterpret_cast<int4*>(cum + i0) = make_int4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<int4*>(cum + i0 + 4) = make_int4(x[4], x[5], x[6], x[7]);
  } else {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      if (i0 + k < live) cum[i0 + k] = x[k];
    }
  }
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    if (i0 + k < live) mass.emit(i0 + k, k > 0 ? x[k - 1] : off, x[k]);
  }
  if (base + kScanTile >= live && threadIdx.x == 0) *total = excl_s + agg;
}

// advance's masses: out_deg[f_idx[i]]
struct AdvanceMass {
  const int* __restrict__ f_idx;
  const int* __restrict__ out_deg;
  __device__ __forceinline__ void load(int i0, int live, bool vec, int (&x)[kScanItems]) const {
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
    for (int k = 0; k < kScanItems; ++k)
      x[k] = x[k] >= 0 && i0 + k < live ? __ldg(out_deg + x[k]) : 0;
  }
  __device__ __forceinline__ void emit(int, int, int) const {}
};

__global__ void __launch_bounds__(kScanThreads)
    advance_scan(const int* __restrict__ f_idx, const int* __restrict__ f_count,
                 const int* __restrict__ out_deg, int cap, bool aligned, int* __restrict__ cum,
                 unsigned long long* status, unsigned int* ticket, int* __restrict__ total) {
  scan_tiles(AdvanceMass{f_idx, out_deg}, min(*f_count, cap), aligned, cum, status, ticket,
             total);
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

constexpr int kIThreads = 256;
constexpr int kIItems = 8;                      // consecutive candidates a thread takes
constexpr int kITile = kIThreads * kIItems;     // candidates a block takes at a time
constexpr int kIEdges = 1024;                   // edges a block stages
constexpr int kIRows = 6144;                    // target-row entries a block stages
constexpr int kCopy = 8;                        // row entries a lane loads at once

// intersect's masses: the source row's real length of each oriented edge
// whose endpoints are rows of adj (0 otherwise), with its target row's
// length beside it in tlen; emit records, for every tile of kITile
// candidates, the edge that holds its first candidate.
struct IntersectMass {
  const int* __restrict__ src;
  const int* __restrict__ dst;
  const int* __restrict__ row_len;
  int n_rows;
  int* __restrict__ tile_k;
  int* __restrict__ tlen;  // each edge's target-row length (0 without candidates)
  __device__ __forceinline__ void load(int i0, int live, bool vec, int (&x)[kScanItems]) const {
    int s[kScanItems], d[kScanItems];
    if (vec) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(src + i0));
      const int4 b = __ldg(reinterpret_cast<const int4*>(src + i0 + 4));
      const int4 c = __ldg(reinterpret_cast<const int4*>(dst + i0));
      const int4 e = __ldg(reinterpret_cast<const int4*>(dst + i0 + 4));
      s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w; s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
      d[0] = c.x; d[1] = c.y; d[2] = c.z; d[3] = c.w; d[4] = e.x; d[5] = e.y; d[6] = e.z; d[7] = e.w;
    } else {
#pragma unroll
      for (int k = 0; k < kScanItems; ++k) {
        s[k] = i0 + k < live ? __ldg(src + i0 + k) : -1;
        d[k] = i0 + k < live ? __ldg(dst + i0 + k) : -1;
      }
    }
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const bool ok = i0 + k < live && static_cast<unsigned>(s[k]) < static_cast<unsigned>(n_rows) &&
                      static_cast<unsigned>(d[k]) < static_cast<unsigned>(n_rows);
      x[k] = ok ? __ldg(row_len + s[k]) : 0;
      if (i0 + k < live) tlen[i0 + k] = ok ? __ldg(row_len + d[k]) : 0;
    }
  }
  __device__ __forceinline__ void emit(int i, int before, int incl) const {
    for (long long t = (static_cast<long long>(before) + kITile - 1) / kITile; t * kITile < incl;
         ++t)
      tile_k[t] = i;
  }
};

// cum, tlen and tile_k of a launch's edges; also zeroes the nch partial counts
__global__ void __launch_bounds__(kScanThreads)
    intersect_scan(const int* __restrict__ src, const int* __restrict__ dst,
                   const int* __restrict__ row_len, int n_rows, int e, bool aligned,
                   int* __restrict__ cum, unsigned long long* status, unsigned int* ticket,
                   int* __restrict__ total, int* __restrict__ tile_k, int* __restrict__ tlen,
                   int* __restrict__ partial, int nch) {
  for (int p = blockIdx.x * kScanThreads + threadIdx.x; p < nch; p += gridDim.x * kScanThreads)
    partial[p] = 0;
  scan_tiles(IntersectMass{src, dst, row_len, n_rows, tile_k, tlen}, e, aligned, cum, status,
             ticket, total);
}

// A lane's candidates c = cw + 32 i (i < kIItems, c < c_end) of a tile
// whose edges are k0 .. k0 + nk - 1 (tile-local k; prev0 is cum before
// edge k0): a warp takes 32 * kIItems consecutive candidates, so
// neighbouring lanes load neighbouring entries of a source row and, on a
// long row, bisect the same target row.  kStaged: the tile's cum, src, dst
// and row offsets are in shared memory, and rows that end at or before
// ``fit`` are staged in s_rows; else every read goes to device memory.
// resolve_lane finds each candidate's edge (kk, -1 past the tile) and
// loads it; probe_lane bisects each candidate's target row and returns the
// hits in edges below ``boundary``, adding the others to their own
// chunk's partial.
struct Run {
  const int* __restrict__ adj;
  int dmax;
  const int* __restrict__ src;
  const int* __restrict__ dst;
  const int* __restrict__ cum;
  const int* __restrict__ tlen;
  int k0, nk, prev0;
  const int* s_cum;
  const int* s_src;
  const int* s_dst;
  const int* s_off;
  const int* s_rows;
};

template <bool kStaged>
__device__ __forceinline__ int cum_at(const Run& r, int k) {
  return kStaged ? r.s_cum[k] : __ldg(r.cum + r.k0 + k);
}

template <bool kStaged>
__device__ __forceinline__ void resolve_lane(const Run& r, int cw, int c_end, int (&w)[kIItems],
                                             int (&kk)[kIItems]) {
  int lo = 0, hi = r.nk - 1;  // the edge that holds cw: upper bound of cw in cum
  while (cw < c_end && lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cum_at<kStaged>(r, mid) <= cw) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int k = lo;
#pragma unroll
  for (int i = 0; i < kIItems; ++i) {
    const int c = cw + 32 * i;
    w[i] = 0;
    kk[i] = -1;
    if (c < c_end) {
      while (cum_at<kStaged>(r, k) <= c) ++k;
      const int prev = k > 0 ? cum_at<kStaged>(r, k - 1) : r.prev0;
      const int s = kStaged ? r.s_src[k] : __ldg(r.src + r.k0 + k);
      w[i] = __ldg(r.adj + static_cast<long long>(s) * r.dmax + (c - prev));
      kk[i] = k;
    }
  }
}

template <bool kGlobal>
__device__ __forceinline__ int lower_bound_in(const int* row, int len, int w) {
  int pos = 0, hi = len;
  while (pos < hi) {
    const int mid = (pos + hi) >> 1;
    const int v = kGlobal ? __ldg(row + mid) : row[mid];
    if (v < w) {
      pos = mid + 1;
    } else {
      hi = mid;
    }
  }
  return pos;
}

template <bool kStaged>
__device__ __forceinline__ int probe_lane(const Run& r, int fit, const int (&w)[kIItems],
                                          const int (&kk)[kIItems], long long boundary,
                                          int chunk, int* partial) {
  int hits = 0;
#pragma unroll
  for (int i = 0; i < kIItems; ++i) {
    const int k = kk[i];
    if (k < 0) break;  // the lane's later candidates lie past the tile too
    bool hit;
    if (kStaged && r.s_off[k + 1] <= fit) {
      const int off = r.s_off[k];
      const int len = r.s_off[k + 1] - off;
      const int pos = lower_bound_in<false>(r.s_rows + off, len, w[i]);
      hit = pos < len && r.s_rows[off + pos] == w[i];
    } else {
      const int d = kStaged ? r.s_dst[k] : __ldg(r.dst + r.k0 + k);
      const int len = __ldg(r.tlen + r.k0 + k);
      const int* grow = r.adj + static_cast<long long>(d) * r.dmax;
      const int pos = lower_bound_in<true>(grow, len, w[i]);
      hit = pos < len && __ldg(grow + pos) == w[i];
    }
    if (hit) {
      if (r.k0 + k < boundary) {
        ++hits;
      } else {
        atomicAdd(partial + (r.k0 + k) / chunk, 1);
      }
    }
  }
  return hits;
}

// Blocks take tiles of kITile consecutive candidates (blockIdx.x, then
// every gridDim.x-th); a tile's edges run from tile_k[t] to tile_k[t + 1]
// (to the edge of the last candidate for the last tile).  A block reads
// the next tile's tile_k while it works on this one, and issues its
// candidates' loads before it copies the target rows, so that a tile waits
// on three rounds of device memory: its edges, then the rows and the
// candidates together, then what probes miss the stage.
__global__ void __launch_bounds__(kIThreads)
    intersect_count(const int* __restrict__ adj, int dmax, const int* __restrict__ src,
                    const int* __restrict__ dst, const int* __restrict__ tlen, int e,
                    const int* __restrict__ cum, const int* __restrict__ total_p,
                    const int* __restrict__ tile_k, int chunk, int* __restrict__ partial) {
  __shared__ int s_cum[kIEdges];
  __shared__ int s_src[kIEdges];
  __shared__ int s_dst[kIEdges];
  __shared__ int s_off[kIEdges + 1];
  __shared__ int s_rows[kIRows];
  __shared__ int s_warp[kIThreads / 32];
  __shared__ int s_last;
  __shared__ int s_fit;
  constexpr int kWarps = kIThreads / 32;
  constexpr int kPer = kIEdges / kIThreads;  // edges a thread stages
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int total = *total_p;
  const int ntiles = static_cast<int>((static_cast<long long>(total) + kITile - 1) / kITile);
  const int t0 = static_cast<int>(blockIdx.x);
  int next0 = t0 < ntiles ? __ldg(tile_k + t0) : 0;
  int next1 = t0 + 1 < ntiles ? __ldg(tile_k + t0 + 1) : 0;
  for (int t = t0; t < ntiles; t += gridDim.x) {
    const int c0 = t * kITile;
    const int c_end = c0 + min(total - c0, kITile);
    const int k0 = next0;
    int k1 = next1;
    const int tn = t + gridDim.x;  // this block's next tile
    if (tn < ntiles) next0 = __ldg(tile_k + tn);
    if (tn + 1 < ntiles) next1 = __ldg(tile_k + tn + 1);
    if (t + 1 >= ntiles) {  // the last tile: the edge of the last candidate
      if (wid == 0) {
        const int k = k0 + warp_upper_bound(cum + k0, e - k0, total - 1);
        if (lane == 0) s_last = k;
      }
      __syncthreads();
      k1 = s_last;
    }
    const int nk = k1 - k0 + 1;
    const int prev0 = k0 > 0 ? __ldg(cum + k0 - 1) : 0;
    const long long boundary = (static_cast<long long>(k0) / chunk + 1) * chunk;
    const int cw = c0 + wid * (32 * kIItems) + lane;  // this lane's first candidate
    Run r{adj, dmax, src, dst, cum, tlen, k0, nk, prev0, s_cum, s_src, s_dst, s_off, s_rows};
    int w[kIItems], kk[kIItems];
    int hits;
    if (nk <= kIEdges) {
      // stage the tile's edges, kPer consecutive a thread, with a scan of
      // their target rows' lengths (0 for an edge without candidates)
      if (threadIdx.x == 0) s_fit = INT_MAX;
      const int i0 = threadIdx.x * kPer;
      int ln[kPer];
      int prev = i0 == 0 ? prev0 : (i0 < nk ? __ldg(cum + k0 + i0 - 1) : 0);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        ln[j] = 0;
        if (i0 + j < nk) {
          const int k = k0 + i0 + j;
          const int c = __ldg(cum + k);
          s_cum[i0 + j] = c;
          s_src[i0 + j] = __ldg(src + k);
          s_dst[i0 + j] = __ldg(dst + k);
          ln[j] = c > prev ? __ldg(tlen + k) : 0;
          prev = c;
        }
      }
      int mine = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) mine += ln[j];
      const int incl = warp_inclusive_scan(mine);
      if (lane == 31) s_warp[wid] = incl;
      __syncthreads();
      // the candidates' loads go out now, and land while the rows copy
      resolve_lane<true>(r, cw, c_end, w, kk);
      int off = incl - mine, all = 0;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        off += i < wid ? s_warp[i] : 0;
        all += s_warp[i];
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (i0 + j < nk) {
          s_off[i0 + j] = off;
          if (off <= kIRows && off + ln[j] > kIRows) s_fit = off;  // the first row that overflows
          off += ln[j];
        }
      }
      if (threadIdx.x == 0) s_off[nk] = all;
      __syncthreads();
      // copy the rows that fit: each warp a segment, its lanes side by side,
      // kCopy loads in flight at a time
      const int fit = min(s_fit, all);
      const int seg = (fit + kWarps - 1) / kWarps;
      const int end = min(fit, (wid + 1) * seg);
      int idx = wid * seg + lane;
      if (idx < end) {
        int lo = 0, hi = nk;  // the last edge whose row starts at or before idx
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (s_off[mid] <= idx) {
            lo = mid;
          } else {
            hi = mid - 1;
          }
        }
        int i = lo;
        for (; idx < end; idx += 32 * kCopy) {
          int v[kCopy];
#pragma unroll
          for (int j = 0; j < kCopy; ++j) {
            const int at = min(idx + 32 * j, end - 1);
            while (s_off[i + 1] <= at) ++i;
            v[j] = __ldg(adj + static_cast<long long>(s_dst[i]) * dmax + (at - s_off[i]));
          }
#pragma unroll
          for (int j = 0; j < kCopy; ++j) {
            if (idx + 32 * j < end) s_rows[idx + 32 * j] = v[j];
          }
        }
      }
      __syncthreads();
      hits = probe_lane<true>(r, fit, w, kk, boundary, chunk, partial);
    } else {
      resolve_lane<false>(r, cw, c_end, w, kk);
      hits = probe_lane<false>(r, 0, w, kk, boundary, chunk, partial);
    }
    hits = warp_sum(hits);
    if (lane == 0 && hits != 0) atomicAdd(partial + k0 / chunk, hits);
    __syncthreads();  // the next tile restages
  }
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
// gate, or null: a device int32; 0 leaves out = out_init (the relax's blocks
// return at once).
int graph_ops_edge_relax(const void* src, const void* dst, const void* w, const void* mask,
                         const void* src_val, const void* out_init, void* out, long long m,
                         long long n_pad, int dtype, int kind, int use_weight, int relax_case,
                         void* flag, const void* gate, void* stream) {
  const int* s = static_cast<const int*>(src);
  const int* d = static_cast<const int*>(dst);
  const float* ww = static_cast<const float*>(w);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  int* f = static_cast<int*>(flag);
  const int* gt = static_cast<const int*>(gate);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool uw = use_weight != 0;
  const int c = relax_case;
  if (dtype == DT_F32) {
    if (kind == KIND_MIN) return launch_relax_w<float, Min>(uw, c, s, d, ww, mk, src_val, out_init, out, m, n_pad, f, gt, st);
    if (kind == KIND_MAX) return launch_relax_w<float, Max>(uw, c, s, d, ww, mk, src_val, out_init, out, m, n_pad, f, gt, st);
    if (kind == KIND_ADD) return launch_relax_w<float, Add>(uw, c, s, d, ww, mk, src_val, out_init, out, m, n_pad, f, gt, st);
  } else if (dtype == DT_I32 && !uw) {
    if (kind == KIND_MIN) return launch_relax_case<int, Min, false>(c, s, d, ww, mk, src_val, out_init, out, m, n_pad, f, gt, st);
    if (kind == KIND_MAX) return launch_relax_case<int, Max, false>(c, s, d, ww, mk, src_val, out_init, out, m, n_pad, f, gt, st);
    if (kind == KIND_ADD) return launch_relax_case<int, Add, false>(c, s, d, ww, mk, src_val, out_init, out, m, n_pad, f, gt, st);
  } else if (dtype == DT_U8 && !uw && kind == KIND_OR) {
    return launch_relax_case<uint8_t, Or, false>(c, s, d, ww, mk, src_val, out_init, out, m, n_pad, f, gt, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The multi-source relax of `lanes` (<= 32) rows into out, in place: src_val,
// seed and out are (lanes, n_pad) row-major, active the (lanes, n_pad) bool
// frontier, valid the (m,) bool slot mask of a batch or null for a push.
// seed, or null: copied into out first, at every vertex (the out-of-place
// route, or a full reseed) or, with at, at the n_at listed vertices and the
// sentinel column; at: null, or the vertices every valid slot's src is
// among (the lane words are packed there only).  changed, or null: (lanes,
// n_pad) bytes, set where the relax moved out to a value unequal to its seed
// (not in the sentinel column; min, max and or).  beyond, or null: (lanes,)
// bytes, lanes whose seeds may lie beyond the neutral (f32 min/max; a full
// seed finds its own).  words: (n_pad,) int32 scratch; flag: (1,) int32
// scratch.
int graph_ops_edge_relax_lanes(const void* src, const void* dst, const void* w,
                               const void* valid, const void* active, const void* src_val,
                               const void* seed, void* out, long long m, long long n_pad,
                               int lanes, int dtype, int kind, int use_weight, const void* at,
                               long long n_at, void* changed, const void* beyond, void* words,
                               void* flag, void* stream) {
  const Lanes a{static_cast<const int*>(src), static_cast<const int*>(dst),
                static_cast<const float*>(w), static_cast<const uint8_t*>(valid),
                static_cast<const uint8_t*>(active), src_val, seed, out, m, n_pad, lanes,
                static_cast<const int*>(at), n_at, static_cast<uint8_t*>(changed),
                static_cast<const uint8_t*>(beyond), static_cast<unsigned int*>(words),
                static_cast<unsigned int*>(flag), static_cast<cudaStream_t>(stream), nullptr};
  const bool uw = use_weight != 0;
  if (dtype == DT_F32) {
    if (kind == KIND_MIN) return launch_lanes_w<float, Min>(uw, a);
    if (kind == KIND_MAX) return launch_lanes_w<float, Max>(uw, a);
    if (kind == KIND_ADD) return launch_lanes_w<float, Add>(uw, a);
  } else if (dtype == DT_I32 && !uw) {
    if (kind == KIND_MIN) return launch_lanes<int, Min, false>(a);
    if (kind == KIND_MAX) return launch_lanes<int, Max, false>(a);
    if (kind == KIND_ADD) return launch_lanes<int, Add, false>(a);
  } else if (dtype == DT_U8 && !uw && kind == KIND_OR) {
    return launch_lanes<uint8_t, Or, false>(a);
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

// The int32 scratch of one intersect launch over e edges: the scan's
// status words and ticket, its total, cum and tlen (e each) and tile_k.
long long graph_ops_intersect_scratch(long long e, int dmax) {
  const long long ntiles = (e + kScanTile - 1) / kScanTile;
  return 2 * (ntiles + 1) + 4 + 2 * ((e + 3) / 4 * 4) + (e * dmax + kITile - 1) / kITile + 1;
}

// adj: (n_rows, dmax) int32, rows sorted, sentinel-padded; src, dst: (e,)
// int32, 0 < e and e * dmax + kITile < 2^31; row_len: (n_rows,) int32, the
// rows' real lengths; scratch: graph_ops_intersect_scratch(e, dmax) int32,
// 16-B aligned; partial: (nch,) int32, nch = ceil(e / chunk), receives the
// count of each chunk of ``chunk`` edges.
int graph_ops_intersect(const void* adj, int n_rows, int dmax, const void* src, const void* dst,
                        const void* row_len, int e, int chunk, void* scratch, void* partial,
                        int nch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = (e + kScanTile - 1) / kScanTile;
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(status + ntiles);
  const int head = 2 * (ntiles + 1);  // the status words' int32s
  int* total = static_cast<int*>(scratch) + head;
  int* cum = static_cast<int*>(scratch) + (head + 4) / 4 * 4;
  int* tlen = cum + (e + 3) / 4 * 4;
  int* tile_k = tlen + (e + 3) / 4 * 4;
  const int* s = static_cast<const int*>(src);
  const int* d = static_cast<const int*>(dst);
  const int* rl = static_cast<const int*>(row_len);
  const int* a = static_cast<const int*>(adj);
  int* p = static_cast<int*>(partial);
  cudaError_t err = cudaMemsetAsync(scratch, 0, (ntiles + 1) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned = ((reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d) |
                         reinterpret_cast<uintptr_t>(cum)) & 15) == 0;
  intersect_scan<<<ntiles, kScanThreads, 0, st>>>(s, d, rl, n_rows, e, aligned, cum, status,
                                                  ticket, total, tile_k, tlen, p, nch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // one resident wave, at most one block per tile
  static int per_sm = 0;
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, intersect_count, kIThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int res = per_sm * sm_count();
  const long long tiles = (static_cast<long long>(e) * dmax + kITile - 1) / kITile;
  const int blocks = static_cast<int>(tiles < res ? (tiles > 0 ? tiles : 1) : res);
  intersect_count<<<blocks, kIThreads, 0, st>>>(a, dmax, s, d, tlen, e, cum, total, tile_k,
                                                 chunk, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
