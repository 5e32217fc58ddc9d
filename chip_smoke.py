#!/usr/bin/env python3
"""Drive the torch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                  # the full-size run
    python3 chip_smoke.py --communities 8  # a short build-and-check run

Phases, in order; any mismatch or exception ends the script with a
non-zero exit before its last line:

1. environment: the card's name and power limit, torch, CUDA and nvcc;
2. build: every kernel library (``src/repro_torch/kernels/*/csrc/*.cu``:
   graph_ops, flash_attention, spmm_bsr, embedding_bag), one ``nvcc`` each,
   all at once, into the git-ignored ``build/repro_torch``; then, for each
   instantiation of the two tensor-core kernels (the bf16 flash-attention
   kernel ``flash_tc_kernel`` and ``spmm_kernel``), its registers, spills
   and shared memory from ``-Xptxas -v`` (no spills allowed) and, where
   the toolkit has ``cuobjdump``, the count of ``HMMA`` (tensor-core)
   instructions in its SASS (none is a failure);
3. graph: ``web_crawl_like(512, 13, 16, 3)`` with random weights (about
   4.19 M vertices and 57 M edges), built as CSR+CSC and symmetrized
   (CSR+CSC, for cc and pagerank) on the card;
4. kernels: each kernel against its plain torch version on the card, at
   the main path's shapes — bitwise except float add: push, relax and
   pull of each kind, then the shapes the main path gives edge_relax
   besides — relax_batch on an advance output whose budget is about 4x
   its total, pull over the symmetrized CSC (int32 min, and pr_pull's
   f32 add), relax_edges under a delta-stepping edge mask, +inf seeds
   (the clamp), unaligned slices (odd start and length) — and advance at
   a small rung (with and without a hub's overflow), at cap = n_pad and
   at f_count = 0;
5. small: the quickstart graph on the card against the plain version on
   the CPU (which the CPU tests hold against the JAX package);
6. main path: bfs_dd_sparse (fused and per-round), sssp_delta,
   cc_pointer_jump, cc_dd_sparse, pr_push and pr_pull under the "cuda"
   substrate (launch counts set to 0 just before, read just after), then
   under the plain "torch" substrate on the card; labels and RunStats must
   agree; then the path once more under "cuda" and ``torch.profiler``
   (CUDA activity), one line per kernel from ``key_averages()`` — calls,
   total and mean device ms — and each family's total (where the profiler
   records no device time, CUDA events around each graph_ops wrapper call
   instead, and the line names that route);
7. suite kernels: edge_relax's int32 add (kcore's decrements) under both
   masks at the symmetrized graph's shapes, bitwise; then the low-diameter
   input ``kron(20, 16, seed=1)`` (``table3_suite(10)["kron30"]``, built as
   ``examples/paper_suite.py`` builds it) and ``intersect`` on a chunk of
   each graph's oriented edge list and on a tail chunk of padding, each
   equal to its plain version exactly; then on each whole oriented list,
   one call (as ``tc_count`` makes it) against a launch per chunk, every
   chunk's count equal to the plain version's, with what the list's
   candidates meet in the kernel's tiles (``intersect_work``);
8. paper suite on the web graph: kcore_peel, kcore_dd_sparse (k = 3, and
   k = 64 fused and per-round), core_numbers, bc_brandes and tc_count
   under "cuda" (counts set to 0 just before, read just after), then
   "torch"; the quickstart graph on the card against the CPU first; then
   kcore_dd_sparse(k=64), core_numbers and tc_count under the profile of
   phase 6;
9. paper suite on kron: the seven calls of ``paper_suite.run_input``
   under both substrates, the same way;
9a. fetches per stretch: bfs_dd_sparse on ``path(65,536)``, fused, with
   every blocking sync counted (torch's sync debug mode, its warnings
   caught) and the engine's ``fetch`` calls: at most 3 each;
   sssp_dd_sparse on the web graph, 2 x stretches <= rounds; bfs_dd_sparse
   fused and per-round walls on the web graph, twice each (printed, no
   target; the rung loops of the first fused run are kept with the graph
   and replayed by the second, and each fused run prints its captures);
   then the device loop (``kernels/device_loop``: a captured
   round replayed by a CUDA graph's WHILE node) against its plain Python
   do-while on 2,000 rounds of the path's stretch and on the web graph's
   first stretch, state and round count bitwise, both timed;
9b. deterministic add: pr_push, pr_pull and bc_brandes under
   ``deterministic_add_scope`` on the web graph, bitwise equal across the
   substrates; on phase 5's quickstart graph the card against the CPU:
   pr_push's raw rank and residual and bc bitwise, pr_pull within PR_TOL
   (its per-round sums are plain torch reductions, in another order on
   the CPU);
9c. out of core: both web graphs cut with ``tier_graph(nshards=16,
   resident_shards=2, build_csc=True)`` (pinned host shards; the CSR 8
   times the pool); edge_relax on the shards as the streamed path gives
   them (push over a middle and the partial last CSR shard, pull over a
   CSC shard, the reversed push), bitwise; then bfs_dd_sparse (fused,
   per-round, and fused under "torch"), sssp_dd_sparse and bfs_dirop
   (CSC streamed) on the weighted graph, from the vertex whose reach
   crosses the most shards (a reversed max and min push of each vertex's
   shard to a fixed point; the hub's reach stays in one shard), each
   streaming more shards than the pool holds, and cc_dd_sparse, pr_push
   (``OOC_PR_ITERS`` = 20 rounds; cc_dd_sparse ``OOC_CC_ROUNDS`` = 50) and pr_pull on the
   symmetrized one, every run from an empty pool:
   labels bitwise equal to
   the resident runs, ranks within PR_TOL, ``h2d_bytes == shards_streamed
   x shard_bytes``, edges_touched equal for bfs_dirop and pr_pull; pr_push
   under deterministic add at pools of 2 and 16 and eager, bitwise; each
   run prints its wall, H2D GB/s, io_wait_us, buffer hits, the device's
   kernel and copy busy shares (a second, profiled call) and its time per
   edge touched against the resident run's; then the weighted graph
   through the store (``save_graph`` under ``build/``, ``open_graph``
   with ``verify="open"``, bfs equal, then a reversed push and a pull
   over every shard through the pinned staging ring, bitwise to the
   resident relaxes; the store is kept for 9f);
9d. the memory tiers on the card (``benchmarks/memtier.py``): HBM copy,
   pinned and pageable H2D, D2H, and 4-byte copy latencies;
9e. the paper's figure suites (``benchmarks/{frameworks,algo_classes,
   granularity}.py``) at full width, warm-up 1 and one timed call:
   frameworks on the web graph and on kron, algo_classes on both, every
   row printed with its counters and, where phase 6, 8 or 9 ran the same
   call on the same container, its labels and RunStats equal to that run
   (pagerank within PR_TOL, bc within BC_TOL, tc by count); on each graph
   every bfs, sssp and cc row bitwise to algo_classes' dd_sparse, delta
   and pointer_jump row, and the two k = 4 kcore peels keeping the same
   vertices; granularity on ``web_crawl_like(64, 13, 16, 3)`` (an eighth
   of the communities: it builds its graph at three block sizes),
   distances equal across them;
9f. resume: the kill drill on 9c's store (``open_graph``): streamed
   bfs_dd_sparse from the far source at a pool of 2 and det-add pr_push
   (OOC_PR_ITERS rounds) at a pool of 16, each run uninterrupted here,
   then in a child process (``--resume-child``, which imports only the
   port) killed at a quarter of its rounds (``faultio.kill``, exit 7) with
   a committed snapshot, then in a child that resumes: bitwise equal to
   the uninterrupted run; then web bfs_dd_sparse on the resident graph
   stopped half way with a snapshot at each stretch boundary and resumed
   twice in this process (from the last snapshot, then the one before),
   bitwise;
9g. dynamic graphs (``benchmarks/dynamic.py``) on the symmetrized web
   graph saved at 16 shards and opened with ``open_dynamic``: 6 seeded
   batches of 65,536 inserts between existing vertices (symmetrized),
   incremental bfs and cc bitwise to the from-scratch runs after each,
   pr_incremental's det-add replay over the first batch allclose to
   scratch (atol scaled to the mean rank 1/n) at a pool of 16 and, cut to
   DYN_DET_ITERS rounds a solve, bitwise across pools of 16 and 4 (every
   handle checking its CRCs as shards stream), compaction, the v3 round
   trip and one batch after compaction: every flag of the suite's rows 1;
   then, on the store the suite leaves (base and six logs), a cold and a
   warm pr_incremental under plain float add on both substrates, within
   PR_TOL (the cuda side's edge_relax over the log shards against the
   plain push);
10. the other kernels at full width, each against its plain version on the
   card: bf16 flash attention against ``flash_attention_plain`` and
   ``attention_ref`` within rtol 8e-3 (one bf16 ulp) + 1e-3 x rms(want),
   since all three keep f32 sums and round once (the bf16 kernel's p as
   bf16 hi + lo keeps it so): flash attention at the attention
   layers of h2o-danube-3-4b (32 heads, d_head 120, window 4096, S = 8192,
   and once more at S = 32,768 against 256 sampled query rows per head)
   and stablelm-3b (32 heads, d_head 80, causal, S = 4096), and at two
   small shapes (bh 4, S 200, d 36, window 48: the element-wise tile loads
   and the mask on edge tiles; bh 2, S 300, d 64, bidirectional), each
   through the tensor cores
   (``tc_launches`` must rise); ``spmm_bsr`` on
   ``web_crawl_like(16, 13, 16, 3)`` in block-ELL (the port's ``to_bsr``),
   F = 128, f32 against the plain version (2e-4) and the edge list (4e-4),
   then bf16 x bf16 and both mixed dtypes against the plain version
   (``SPMM_BF16_TOL`` where out is bf16, ``SPMM_TOL`` where it is f32);
   ``embedding_bag`` on MIND's 2^23 x 64 f32 item table under its
   serve_bulk (262,144 x 50) and serve_p99 (512 x 50) batches, sum and
   mean, bitwise;
11. the layer: ``layers.attention`` at h2o-danube-3-4b's full width (d_model
   3840, B = 1, S = 8192, bf16), the flash branch (counts set to 0 just
   before, read just after; its flash launches on the tensor cores)
   against the plain softmax branch, within
   8e-3 x |plain| + 5e-2 x the rms of the query row (the plain branch
   rounds its probabilities and head outputs to bf16);
12. the entry point: first each kernel on ``kernels_bench``'s own inputs
   (f32 flash at d = 64, f32 SpMM at n = 512, the bag at D = 128, and in
   bf16 and at D = 256) against its plain version (f32 within 2e-5, bags
   bitwise);
   then ``repro_torch.benchmarks.kernels_bench.run()`` (counts set to 0
   just before, read just after): the JAX suite's rows, the cuda BFS row
   on the cuda substrate, all six kernels launched.

Agreement: labels, alive masks, core numbers and triangle counts bitwise;
pagerank rtol 1e-4 / atol 1e-10; bc rtol 1e-3 / atol 1e-4 (its sigma and
delta sums are float atomicAdds in an order that changes from run to run;
the tolerance is the suite's own oracle check, and the largest error seen
is printed beside it); RunStats equal except ``substrate`` and, in phase
9, pagerank's round count, which may differ by one round: its
residual-threshold exit reads float sums taken in another order (seen on
kron: 143 rounds under "cuda", 142 under "torch").  Its rounds are all
dense then, each charging m, and that is checked on both sides.

The device loop (no TPU kernel: the graph that replaces the reference's
stretch ``while_loop``) has a line of its own before the kernels line,
``{"device_loop": {...}}``: its graph launches on the main path, and 2,000
rounds of the path's stretch timed through the graph (``ms``) and through
the plain Python loop (``plain_ms``), with the largest difference of their
labels (``max_abs_err``).  A kernel's ``launches`` sum its cuda launches
on every path (phases 6, 8, 9, 9c, 9e-9g, 11, 12; in 9f those of this
process, not of its children) and count the rounds a loop
replays: a capture launches nothing, and each loop adds its captured
round's launches for every round after its eager first one
(``StretchGraphs.settle``).

Each kernel row prints ``ms`` (CUDA events, 5 reps after a warm-up; an
intersect row also ``device_ms``, the profiler's device time of a call,
since a single call's events mostly time the host's launches),
``plain_ms``, ``library_ms`` (one PyTorch call for the same function, timed
as a yardstick only) and ``bound_ms`` / ``bound_by``: bytes over 3.35 TB/s
against operations over 67 TFLOP/s f32, or 989 TFLOP/s for bf16 attention,
whose work could take the tensor cores.  The graph kernels' bytes are what
the inputs need: edge_relax reads src for each slot (each active one
under a slot mask), dst for each slot that sends and w for each active
one (``bound_all_slots_ms`` counts every slot's, the formula of earlier
runs); advance reads the live entries' f_idx, degree and row_ptr.  A bf16 flash row also prints
``tflops`` (those 4 d operations per unmasked pair over the kernel's
time), ``tc_flops`` (the 6 d per pair the kernel runs: p @ v twice, for
p's bf16 hi and lo halves) and ``route``.

It prints the kernels line (one JSON object) and, last, the device line.
It exits non-zero without a result when no CUDA device is present or when
the repository's sources are not beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
import warnings
from collections import namedtuple
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12     # float32 outside the tensor cores
H100_BF16_TC_OPS_PER_S = 989e12  # bf16 on the tensor cores, dense
ADD_RTOL_OF_ABS_SUM = 1e-5     # float add: |kernel - plain| <= 1e-5 * sum|terms|
PR_TOL = (1e-4, 1e-10)         # (rtol, atol)
BC_TOL = (1e-3, 1e-4)          # float atomicAdd order in sigma and delta
INTERSECT_CHUNK = 32_768       # tc_count's edge_chunk
# the rows of the JAX package's kernels suite (benchmarks/kernels_bench.py),
# its substrates "jnp" / "pallas" named by the port's "torch" / "cuda"
KERNELS_BENCH_ROWS = (
    "kern/flash_attn_256", "kern/spmm_bsr_512", "kern/embedding_bag_32x10",
    *(f"kern/graph_{op}[{sub}]" for sub in ("torch", "cuda")
      for op in ("push", "pull", "advance_relax", "intersect", "bfs_e2e")))

# one run of a path: ``fn() -> (labels, stats)``; ``tol`` is (rtol, atol)
# for float scores, None for bitwise; ``dense_m`` is the graph's m for a
# run of dense rounds only whose round count may differ by one between the
# substrates (pagerank's residual exit reads float sums)
Run = namedtuple("Run", "fn tol dense_m", defaults=(None, None))


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def sh(cmd):
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(torch, fn, reps=5):
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up,
    from CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled(torch, fn):
    """Call ``fn`` under ``torch.profiler`` (CUDA activity) and return
    ``(key_averages(), None)``, or ``(None, error)`` where the profiler
    itself fails to start or to stop.  What ``fn`` raises, a failed launch
    or a CUDA fault at the synchronize, is not caught."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA])
    try:
        prof.start()
    except (RuntimeError, AssertionError) as err:
        return None, err
    fn()
    torch.cuda.synchronize()
    try:
        prof.stop()
        return prof.key_averages(), None
    except (RuntimeError, AssertionError) as err:
        return None, err


def device_ms(torch, fn, reps=5):
    """Device time of one call of ``fn`` (every kernel, memset and copy it
    launches), from ``torch.profiler`` over ``reps`` calls after a warm-up;
    None where the profiler fails or records no device time.  Unlike
    ``cuda_ms`` it leaves out the gaps in which the card waits for the
    host."""
    fn()
    torch.cuda.synchronize()
    events, _ = profiled(torch, lambda: [fn() for _ in range(reps)])
    us = sum(getattr(ev, "self_device_time_total", 0) or 0 for ev in events or ())
    return us / 1e3 / reps if us > 0 else None


def bound_ms(nbytes, nops, ops_per_s=H100_F32_OPS_PER_S):
    """Least time for the work: the larger of bytes over the memory rate
    and operations over the rate of their route (float32 by default)."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bits(torch, t):
    """Integer view for bitwise comparison (-0.0 and +0.0 differ)."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.to(torch.int32) if t.dtype == torch.bool else t


# ---- phase 4: kernels against their plain versions ---------------------------


def edge_relax_cases(torch, g, gsym, gk, fr, gen):
    """(name, kwargs of ops.edge_relax) at the main path's shapes: the graph's
    edge arrays, random vertex data with negatives and signed zeros; then
    the shapes the main path gives the kernel besides: relax_batch on an
    advance output whose budget is about 4x its total, pull over the
    symmetrized graph's CSC (cc's int32 min, pr_pull's f32 add),
    relax_edges under a delta-stepping edge mask, and unaligned slices
    (odd start and length).  The first case is the kernel's table case."""
    dev = g.device
    n_pad, m_pad = g.n_pad, g.m_pad

    def signed(n, inf=0.0):
        x = torch.randn(n, generator=gen, device=dev) * 4
        pick = torch.rand(n, generator=gen, device=dev)
        x = torch.where(pick < 0.05, torch.tensor(-0.0, device=dev), x)
        x = torch.where((pick >= 0.05) & (pick < 0.1), torch.tensor(0.0, device=dev), x)
        if inf:   # unreached vertices: seeds beyond the neutral, clamped to FLT_MAX
            x = torch.where(torch.rand(n, generator=gen, device=dev) < inf,
                            torch.tensor(float("inf"), device=dev), x)
        return x

    vmask = torch.rand(n_pad, generator=gen, device=dev) < 0.5
    vmask[g.sentinel] = False
    smask = torch.rand(m_pad, generator=gen, device=dev) < 0.5
    w_signed = signed(m_pad)
    labels = torch.randint(-2**30, 2**30, (n_pad,), generator=gen, device=dev,
                           dtype=torch.int32)
    flags = torch.rand(n_pad, generator=gen, device=dev) < 0.3
    seen = torch.rand(n_pad, generator=gen, device=dev) < 0.1
    csr = dict(src=g.src_idx, dst=g.col_idx)
    csc = dict(src=g.in_col_idx, dst=g.in_src_idx)
    sym_csc = dict(src=gsym.in_col_idx, dst=gsym.in_src_idx, w=gsym.in_edge_w)
    # an advance output: 2% of the vertices, a budget of 4x their mass (a
    # padding tail of 3x the valid slots)
    front = torch.rand(n_pad, generator=gen, device=dev) < 0.02
    front[g.sentinel] = False
    f = fr.compact(front, fr.pick_capacity(int(front.sum()), fr.ladder_capacities(
        n_pad, g.block_size)), g.sentinel)
    budget = -(-4 * int(g.budget_edge_mass(front)) // g.block_size) * g.block_size
    bsrc, bdst, bw, bvalid, _ = gk.advance_frontier(
        f.idx, f.count, g.out_deg, g.row_ptr, g.col_idx, g.edge_w, budget=budget,
        sentinel=g.sentinel, m_pad=m_pad)
    batch = dict(src=bsrc, dst=bdst, w=bw, mask=bvalid)
    # delta-stepping: the light edges of a bucket's vertices (sssp_delta, delta 4)
    bucket = torch.rand(n_pad, generator=gen, device=dev) < 0.05
    bucket[g.sentinel] = False
    light = bucket[g.src_idx] & (g.edge_w <= 4.0)
    valid = g.valid_vertex_mask()
    cut = slice(3, m_pad - 6)      # odd start, odd length
    return [
        ("push f32 min weighted vertex-mask", dict(
            **csr, w=w_signed, mask=vmask, src_val=signed(n_pad),
            out_init=signed(n_pad), kind="min", use_weight=True, vertex_mask=True)),
        ("relax f32 min weighted slot-mask", dict(
            **csr, w=w_signed, mask=smask, src_val=signed(n_pad),
            out_init=signed(n_pad), kind="min", use_weight=True, vertex_mask=False)),
        ("push f32 max weighted vertex-mask", dict(
            **csr, w=w_signed, mask=vmask, src_val=signed(n_pad),
            out_init=signed(n_pad), kind="max", use_weight=True, vertex_mask=True)),
        ("relax f32 max weighted slot-mask", dict(
            **csr, w=w_signed, mask=smask, src_val=signed(n_pad),
            out_init=signed(n_pad), kind="max", use_weight=True, vertex_mask=False)),
        ("push i32 min unweighted vertex-mask", dict(
            **csr, w=g.edge_w, mask=vmask, src_val=labels, out_init=labels,
            kind="min", use_weight=False, vertex_mask=True)),
        ("push f32 add weighted vertex-mask", dict(
            **csr, w=g.edge_w, mask=vmask, src_val=signed(n_pad),
            out_init=signed(n_pad), kind="add", use_weight=True, vertex_mask=True)),
        ("push or unweighted vertex-mask", dict(
            **csr, w=g.edge_w, mask=vmask, src_val=flags, out_init=seen,
            kind="or", use_weight=False, vertex_mask=True)),
        ("pull f32 min weighted vertex-mask (CSC)", dict(
            **csc, w=g.in_edge_w, mask=vmask, src_val=signed(n_pad),
            out_init=signed(n_pad), kind="min", use_weight=True, vertex_mask=True,
            case="pull")),
        ("push f32 min weighted vertex-mask, +inf seeds (bfs/sssp)", dict(
            **csr, w=g.edge_w, mask=vmask, src_val=signed(n_pad),
            out_init=signed(n_pad, inf=0.3), kind="min", use_weight=True,
            vertex_mask=True)),
        (f"relax_batch f32 min on advance output (total {int(bvalid.sum())}, "
         f"budget {budget}), +inf seeds", dict(
            **batch, src_val=signed(n_pad), out_init=signed(n_pad, inf=0.3), kind="min",
            use_weight=True, vertex_mask=False, case="batch")),
        ("relax_batch i32 add unweighted on advance output (kcore)", dict(
            **batch, src_val=torch.ones(n_pad, dtype=torch.int32, device=dev),
            out_init=torch.zeros(n_pad, dtype=torch.int32, device=dev), kind="add",
            use_weight=False, vertex_mask=False, case="batch")),
        ("pull i32 min unweighted vertex-mask (sym CSC, cc)", dict(
            **sym_csc, mask=vmask, src_val=labels, out_init=labels, kind="min",
            use_weight=False, vertex_mask=True, case="pull")),
        ("pull f32 add weighted all-valid (sym CSC, pr_pull)", dict(
            **sym_csc, mask=valid, src_val=torch.where(valid, torch.rand(
                n_pad, generator=gen, device=dev) / g.n, 0.0),
            out_init=torch.zeros(n_pad, device=dev), kind="add", use_weight=True,
            vertex_mask=True, case="pull")),
        ("relax_edges f32 min under a delta-stepping edge mask, +inf seeds", dict(
            **csr, w=g.edge_w, mask=light, src_val=signed(n_pad, inf=0.5),
            out_init=signed(n_pad, inf=0.5), kind="min", use_weight=True,
            vertex_mask=False, case="edges")),
        ("push f32 min unaligned slice [3, m_pad - 6), +inf seeds", dict(
            src=g.src_idx[cut], dst=g.col_idx[cut], w=g.edge_w[cut], mask=vmask,
            src_val=signed(n_pad), out_init=signed(n_pad, inf=0.3), kind="min",
            use_weight=True, vertex_mask=True)),
        ("relax_edges f32 min unaligned slice [3, m_pad - 6)", dict(
            src=g.src_idx[cut], dst=g.col_idx[cut], w=g.edge_w[cut], mask=smask[cut],
            src_val=signed(n_pad), out_init=signed(n_pad, inf=0.3), kind="min",
            use_weight=True, vertex_mask=False, case="edges")),
    ]


def beyond_neutral(torch, x, kind):
    """Seeds a masked f32 min (max) slot clamps: above FLT_MAX (below
    -FLT_MAX) in the ordered-int order."""
    if x.dtype != torch.float32 or kind not in ("min", "max"):
        return torch.zeros_like(x, dtype=torch.bool)
    b = x.view(torch.int32)
    key = torch.where(b >= 0, b, b ^ 0x7FFFFFFF)
    return key > 0x7F7FFFFF if kind == "min" else key < -0x7F800000


def run_edge_relax_case(torch, gk, name, kw):
    kind, use_w, vm = kw["kind"], kw["use_weight"], kw["vertex_mask"]
    args = (kw["src"], kw["dst"], kw["w"], kw["mask"], kw["src_val"], kw["out_init"])
    case = {"case": kw["case"]} if "case" in kw else {}

    def kernel():
        return gk.edge_relax(*args, kind=kind, use_weight=use_w, vertex_mask=vm, **case)

    def plain():
        if vm:
            return gk.push_ref(args[0], args[1], args[2], args[4], args[3],
                               args[5], kind, use_w)
        return gk.relax_ref(*args, kind, use_w)

    before = gk.edge_relax.launches
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    check(gk.edge_relax.launches == before + 1, f"{name}: no launch counted")
    float_add = kind == "add" and args[5].dtype == torch.float32
    if float_add:
        src, dst = args[0], args[1]
        act = args[3][src] if vm else args[3]
        terms = torch.where(act, gk.edge_message(args[4][src], args[2], kind, use_w), 0.0)
        scale = torch.zeros_like(want).index_add_(0, dst, terms.abs()) + args[5].abs()
        err = (got - want).abs()
        check(bool((err <= ADD_RTOL_OF_ABS_SUM * scale + 1e-30).all()),
              f"{name}: add outside tolerance (max err {float(err.max())})")
        max_err = float(err.max())
    else:
        same = torch.equal(bits(torch, got), bits(torch, want))
        check(same, f"{name}: kernel and plain version differ bitwise")
        max_err = 0.0   # bitwise equal (inf - inf would read NaN)

    # library yardstick: one scatter_reduce_ over the ready, masked messages
    src, dst = args[0], args[1]
    keep = args[3][src] if vm else args[3]
    msg = gk.edge_message(args[4][src], args[2], kind, use_w)
    if kind == "or":
        msg, buf = msg.to(torch.uint8), args[5].to(torch.uint8).clone()
        reduce = "amax"
    else:
        buf = args[5].clone()
        reduce = {"min": "amin", "max": "amax", "add": "sum"}[kind]
    msg = torch.where(keep, msg.to(buf.dtype), gk.neutral_for(kind, buf.dtype).item())
    dst64 = dst.long()

    t_k = cuda_ms(torch, kernel)
    t_p = cuda_ms(torch, plain)
    t_l = cuda_ms(torch, lambda: buf.scatter_reduce_(0, dst64, msg, reduce))
    # bound: what these inputs need read — src for every slot (for the
    # active ones under a slot mask), the mask, dst for each slot that sends
    # (the active ones, and every masked one when a seed lies beyond the
    # neutral), w for the active ones — and the vertex arrays once
    m, n_pad = src.shape[0], args[5].shape[0]
    s = args[5].element_size()
    n_act = int(keep.sum())
    clamp = bool(beyond_neutral(torch, args[5], kind).any())
    n_send = m if clamp else n_act
    nbytes = ((4 * m if vm else 4 * n_act) + (n_pad if vm else m) + 4 * n_send
              + (4 * n_act if use_w else 0) + 3 * n_pad * s)
    b_ms, b_by = bound_ms(nbytes, m)
    all_slots_ms, _ = bound_ms(m * (4 + 4 + (4 if use_w else 0) + (0 if vm else 1))
                               + n_pad * ((1 if vm else 0) + 3 * s), m)
    return dict(case=name, ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=max_err,
                compare="allclose" if float_add else "bitwise", slots=m, active=n_act,
                clamp=clamp, bound_all_slots_ms=all_slots_ms)


def advance_cases(torch, g, fr, gen):
    """(name, mask, capacity, budget): a small rung whose budget a hub
    overflows, cap = n_pad with the largest sparse budget (the kernel's
    table case), an empty frontier, and a small rung whose budget covers
    its mass."""
    dev = g.device
    hubs = torch.topk(g.out_deg, 16).indices
    lad_b = fr.ladder_capacities(g.m_pad, g.block_size)
    cap_lad = fr.ladder_capacities(g.n_pad, g.block_size)
    largest = fr.pick_capacity(lad_b[-1] // 2, lad_b)
    small = torch.zeros(g.n_pad, dtype=torch.bool, device=dev)
    pick = torch.randint(0, g.n, (1500,), generator=gen, device=dev)
    small[pick] = True
    leaves = small.clone()
    small[hubs[:4]] = True
    big = torch.rand(g.n_pad, generator=gen, device=dev) < 0.25
    big[hubs] = True
    empty = torch.zeros(g.n_pad, dtype=torch.bool, device=dev)
    leaves[hubs] = False
    fits = fr.pick_capacity(int(g.budget_edge_mass(leaves)), lad_b)
    return [("small rung, hub overflow", small, cap_lad[1], lad_b[2]),
            ("cap = n_pad, largest sparse budget", big, g.n_pad, largest),
            ("f_count = 0", empty, cap_lad[1], lad_b[1]),
            ("small rung, budget covers the mass", leaves, cap_lad[1], fits)]


def run_advance_case(torch, gk, fr, g, name, mask, cap, budget):
    f = fr.compact(mask, cap, g.sentinel)
    args = (f.idx, f.count, g.out_deg, g.row_ptr, g.col_idx, g.edge_w)
    kw = dict(budget=budget, sentinel=g.sentinel, m_pad=g.m_pad)

    def kernel():
        return gk.advance_frontier(*args, **kw)

    def plain():
        return gk.advance_ref(*args, **kw)

    before = gk.advance_frontier.launches
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    check(gk.advance_frontier.launches == before + 1, f"{name}: no launch counted")
    for fld, a, b in zip(("src", "dst", "w", "valid", "total"), got, want):
        check(a.dtype == b.dtype and torch.equal(bits(torch, a), bits(torch, b)),
              f"advance {name}: {fld} differs")
    total = int(want[4])
    live = min(int(f.count), cap)
    # library yardstick: one searchsorted over a ready running degree sum
    deg = torch.where(f.valid_slots(), g.out_deg[f.idx], 0)
    cum = torch.cumsum(deg, 0, dtype=torch.int32)
    j = torch.arange(budget, dtype=torch.int32, device=g.device)
    t_k = cuda_ms(torch, kernel)
    t_p = cuda_ms(torch, plain)
    t_l = cuda_ms(torch, lambda: torch.searchsorted(cum, j, right=True, out_int32=True))
    emitted = min(total, budget)
    # f_count; f_idx, the degree and row_ptr gathers of the live entries;
    # col_idx and edge_w of the emitted slots; 13 B written per slot; total
    nbytes = 4 + 12 * live + 8 * emitted + 13 * budget + 4
    b_ms, b_by = bound_ms(nbytes, cap + budget * max(1, cap.bit_length()))
    return dict(case=name, ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=0.0, compare="bitwise",
                count=int(f.count), total=total, budget=budget, cap=cap)


# ---- the profile of a path by kernel -----------------------------------------

# the profile's families: a fragment of a kernel's name -> its family
PROFILE_FAMILIES = (("edge_relax", "edge_relax"), ("relax_seed", "edge_relax"),
                    ("advance_", "advance"), ("intersect_", "intersect"))


def kernel_label(name):
    """A kernel's name without its namespaces, return type and arguments."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            name = name[:i]
            break
    return name if len(name) <= 160 else name[:157] + "..."


def profile_by_kernel(torch, gk, runs):
    """Run each ``name: Run`` once more on the card and split its device
    time by kernel.  Returns ``(route, rows, wall_ms)``, rows
    ``{kernel, family, calls, total_ms, mean_ms}`` by total time.  The route
    is ``torch.profiler`` (CUDA activity, ``key_averages()``: every kernel,
    memset and copy); where that records no device time, the runs go again
    with CUDA events around each graph_ops wrapper call (the graph kernels
    only, each with its seed copy or scan), and the route says so."""
    rows = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events, err = profiled(torch, lambda: [run.fn() for run in runs.values()])
    wall = (time.perf_counter() - t0) * 1e3
    failure = "no device time" if err is None else f"{type(err).__name__}: {err}"
    for ev in events or ():
        ms = (getattr(ev, "self_device_time_total", 0) or 0) / 1e3
        if ms <= 0:
            continue
        label = kernel_label(ev.key)
        fam = next((f for frag, f in PROFILE_FAMILIES if frag in label), "other")
        row = rows.setdefault(label, dict(kernel=label, family=fam, calls=0, total_ms=0.0))
        row["calls"] += ev.count
        row["total_ms"] += ms
    route = "torch.profiler"
    if not rows:
        route = f"cuda events around each graph_ops wrapper call (profiler: {failure})"
        rows, wall = event_profile(torch, gk, runs)
    out = sorted(rows.values(), key=lambda r: -r["total_ms"])
    for row in out:
        row["mean_ms"] = row["total_ms"] / row["calls"]
    return route, out, wall


def event_profile(torch, gk, runs):
    """The runs with a CUDA event pair around each call of a graph_ops
    wrapper (the operator seam looks them up on the package at each call);
    rows by case, dtype and kind."""
    names = ("edge_relax", "advance_frontier", "intersect_count")
    saved = {n: getattr(gk, n) for n in names}
    marks = []

    def label(name, args, kw):
        if name != "edge_relax":
            return name
        vm = kw.get("vertex_mask", True)
        case = kw.get("case") or ("push" if vm else "edges")
        dtype = str(args[5].dtype).removeprefix("torch.")
        weighted = "weighted" if kw.get("use_weight", True) else "unweighted"
        return f"edge_relax[{case}, {dtype}, {kw.get('kind', 'min')}, {weighted}]"

    def timed(name, fn):
        def call(*args, **kw):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            marks.append((label(name, args, kw), a, b))
            return out
        return call

    for n, fn in saved.items():
        setattr(gk, n, timed(n, fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for run in runs.values():
            run.fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for n, fn in saved.items():
            setattr(gk, n, fn)
    rows = {}
    for lab, a, b in marks:
        fam = next((f for frag, f in PROFILE_FAMILIES if frag in lab), lab.split("_")[0])
        row = rows.setdefault(lab, dict(kernel=lab, family=fam, calls=0, total_ms=0.0))
        row["calls"] += 1
        row["total_ms"] += a.elapsed_time(b)
    return rows, wall


def print_profile(torch, gk, label, runs, wall_ms):
    """Profile ``runs`` and print one line per kernel, then the families'
    totals and the device's busy share: its time over ``wall_ms``, the
    same runs' wall time without the profiler (which slows the host)."""
    route, rows, profiled_wall = profile_by_kernel(torch, gk, runs)
    fams = {}
    for row in rows:
        fams[row["family"]] = fams.get(row["family"], 0.0) + row["total_ms"]
    for row in rows:
        print(f"  profile {label} " + json.dumps(row), flush=True)
    device = sum(fams.values())
    print(f"profile {label}: route={route} device_ms={device} wall_ms={wall_ms} "
          f"device_busy_share={device / wall_ms} (profiled wall {profiled_wall} ms) "
          f"families={json.dumps(fams)}", flush=True)


# ---- phases 5 and 6: small check and the main path --------------------------


def run_path(torch, runs, substrate, ops):
    """Run each ``name: Run`` of ``runs`` under ``substrate``; returns
    {name: (labels, stats, wall_ms, peak_bytes)}.  stats is None for a
    utility without counters."""
    out = {}
    with ops.substrate_scope(substrate):
        for name, run in runs.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            labels, stats = run.fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated()
            if stats is not None:
                check(stats.substrate == substrate,
                      f"{name}: RunStats.substrate {stats.substrate!r} under {substrate!r}")
            out[name] = (labels, stats, wall, peak)
            counters = ("" if stats is None else
                        f" rounds={stats.rounds} edges_touched={stats.edges_touched}")
            print(f"  {substrate:5s} {name:28s} wall_ms={wall}{counters} "
                  f"peak_bytes={peak}", flush=True)
    return out


def main_path_runs(algos, g, gsym, source):
    bfs, sssp, cc, pagerank = algos
    return {
        "bfs_dd_sparse": Run(lambda: bfs.bfs_dd_sparse(g, source)),
        "bfs_dd_sparse(fused=False)": Run(lambda: bfs.bfs_dd_sparse(g, source,
                                                                    fused=False)),
        "sssp_delta": Run(lambda: sssp.sssp_delta(g, source, delta=4.0)),
        "cc_pointer_jump": Run(lambda: cc.cc_pointer_jump(gsym)),
        "cc_dd_sparse": Run(lambda: cc.cc_dd_sparse(gsym)),
        "pr_push": Run(lambda: pagerank.pr_push(gsym), PR_TOL),
        # on the unweighted symmetrized graph: pr_pull relaxes with
        # use_weight=True, as the reference does, so weights would scale it
        "pr_pull": Run(lambda: pagerank.pr_pull(gsym), PR_TOL),
    }


def compare_runs(torch, name, a, b, tol=None, dense_m=None):
    """Labels bitwise when ``tol`` is None, else non-finite at the same
    places and allclose within ``tol = (rtol, atol)``, printing the largest
    errors seen; then RunStats equal but for ``substrate``.  With
    ``dense_m`` the rounds may differ by one, each side's rounds must all be
    dense and charge ``dense_m`` edges, and the other counters are equal."""
    (la, sa, _, _), (lb, sb, _, _) = a, b
    if isinstance(la, int):
        check(la == lb, f"{name}: counts differ ({la} vs {lb})")
    else:
        la, lb = la.cpu(), lb.cpu()
        check(la.shape == lb.shape and la.dtype == lb.dtype,
              f"{name}: shape/dtype differ")
        if tol is None:
            check(torch.equal(bits(torch, la), bits(torch, lb)),
                  f"{name}: labels differ bitwise")
        else:
            rtol, atol = tol
            fa, fb = torch.isfinite(la), torch.isfinite(lb)
            check(torch.equal(fa, fb), f"{name}: non-finite at different places")
            check(torch.allclose(la, lb, rtol=rtol, atol=atol, equal_nan=True),
                  f"{name}: scores outside rtol={rtol} atol={atol}")
            err = (la[fa].double() - lb[fa].double()).abs()
            ref = lb[fa].double().abs()
            big = ref > atol
            rel = float((err[big] / ref[big]).max()) if bool(big.any()) else 0.0
            print(f"  {name}: max_abs_err={float(err.max()) if err.numel() else 0.0} "
                  f"max_rel_err={rel} (where |torch| > atol) against rtol={rtol} "
                  f"atol={atol}", flush=True)
    if sa is None:
        check(sb is None, f"{name}: stats on one side only")
        return
    da, db = sa.as_dict(), sb.as_dict()
    da.pop("substrate"), db.pop("substrate")
    if dense_m is not None and da != db:
        ra, rb = da["rounds"], db["rounds"]
        print(f"  {name}: rounds {ra} vs {rb}, edges_touched "
              f"{da['edges_touched']} vs {db['edges_touched']}", flush=True)
        check(abs(ra - rb) <= 1, f"{name}: rounds differ by more than one")
        for d in (da, db):
            check(d["dense_rounds"] == d["rounds"] and d["sparse_rounds"] == 0
                  and d["edges_touched"] == d["dense_rounds"] * dense_m,
                  f"{name}: rounds not all dense, each charging m = {dense_m}")
            for k in ("rounds", "dense_rounds", "edges_touched"):
                d.pop(k)
    check(da == db, f"{name}: RunStats differ: {da} vs {db}")


def small_check(torch, np, tc, algos, gen_mod):
    """The quickstart graph on the card (kernels) against the plain version
    on the CPU, which the CPU tests hold against the JAX package."""
    bfs, sssp, cc, pagerank = algos
    src, dst, n = gen_mod.web_crawl_like(16, 5, 8, 2, seed=0)
    w = gen_mod.random_weights(len(src), seed=1)
    source = int(np.argmax(np.bincount(src, minlength=n)))
    res = {}
    for dev in ("cuda", "cpu"):
        g = tc.from_coo(src, dst, n, w, build_csc=True, device=dev)
        gs = tc.from_coo(src, dst, n, symmetrize=True, device=dev)
        res[dev] = [bfs.bfs_dd_sparse(g, source), sssp.sssp_delta(g, source, delta=4.0),
                    cc.cc_pointer_jump(gs), pagerank.pr_push(gs)]
    for i, name in enumerate(("bfs", "sssp", "cc", "pr")):
        (la, sa), (lb, sb) = res["cuda"][i], res["cpu"][i]
        compare_runs(torch, f"small {name}", (la, sa, 0, 0), (lb, sb, 0, 0),
                     PR_TOL if name == "pr" else None)


# ---- phases 7-9: the paper suite's kernels and algorithms -------------------


def int_add_cases(torch, gsym, gen):
    """edge_relax's int32 add, unweighted, as kcore's decrements run it on
    the symmetrized graph: vertex mask (push) and per-slot mask (relax)."""
    dev = gsym.device
    ones = torch.ones(gsym.n_pad, dtype=torch.int32, device=dev)
    zeros = torch.zeros(gsym.n_pad, dtype=torch.int32, device=dev)
    vmask = torch.rand(gsym.n_pad, generator=gen, device=dev) < 0.5
    vmask[gsym.sentinel] = False
    smask = torch.rand(gsym.m_pad, generator=gen, device=dev) < 0.5
    csr = dict(src=gsym.src_idx, dst=gsym.col_idx, w=gsym.edge_w, src_val=ones,
               out_init=zeros, kind="add", use_weight=False)
    return [("push i32 add unweighted vertex-mask (sym)", dict(**csr, mask=vmask,
                                                               vertex_mask=True)),
            ("relax i32 add unweighted slot-mask (sym)", dict(**csr, mask=smask,
                                                              vertex_mask=False))]


def oriented_chunks(torch, tri, g):
    """The oriented adjacency of ``g`` on the card, its edge list padded to
    whole chunks, and each chunk's candidate mass (row lengths of its
    sources)."""
    adj, osrc, odst = tri.oriented_adjacency(g)
    ne = osrc.shape[0]
    pad = -ne % INTERSECT_CHUNK
    fill = torch.full((pad,), g.sentinel, dtype=torch.int32, device=g.device)
    osrc, odst = torch.cat([osrc, fill]), torch.cat([odst, fill])
    row_len = (adj != g.sentinel).sum(1, dtype=torch.int64)
    work = row_len[osrc.long()].view(-1, INTERSECT_CHUNK).sum(1)
    return adj, osrc, odst, row_len, work, ne


def intersect_cases(torch, label, g, adj, osrc, odst, row_len, work, ne):
    """(name, adj, src, dst, row_len, sentinel) on one graph's oriented list:
    the web graph's median chunk by candidate mass and a tail chunk of its
    last 1,024 edges padded with sentinels, or kron's heaviest chunk (its
    hubs)."""
    if label == "web":
        c = int(torch.argsort(work)[work.shape[0] // 2])
        name = f"web chunk {c} (median candidate mass)"
    else:
        c = int(torch.argmax(work))
        name = f"kron chunk {c} (heaviest: hubs)"
    sl = slice(c * INTERSECT_CHUNK, (c + 1) * INTERSECT_CHUNK)
    cases = [(name, adj, osrc[sl], odst[sl], row_len, g.sentinel)]
    if label == "web":
        k = min(ne, 1024)
        fill = torch.full((INTERSECT_CHUNK - k,), g.sentinel, dtype=torch.int32,
                          device=g.device)
        cases.append(("web tail (1,024 edges, 31,744 padding)", adj,
                      torch.cat([osrc[ne - k:ne], fill]),
                      torch.cat([odst[ne - k:ne], fill]), row_len, g.sentinel))
    return cases


def intersect_bytes(torch, src, dst, row_len, sentinel):
    """What one chunk must read: src and dst once, each row it touches (its
    real entries) once, and the count written."""
    rows = torch.unique(torch.cat([src, dst]).long())
    rows = rows[rows != sentinel]
    return 8 * src.shape[0] + 4 * int(row_len[rows].sum()) + 4


def run_intersect_case(torch, gk, name, adj, src, dst, row_len, sentinel):
    def kernel():
        return gk.intersect_count(adj, src, dst, sentinel=sentinel)

    def plain():
        return gk.intersect_ref(adj, src, dst, sentinel)

    before = gk.intersect_count.launches
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    check(gk.intersect_count.launches == before + 1, f"{name}: no launch counted")
    check(got.dtype == want.dtype == torch.int32 and got.shape == (),
          f"intersect {name}: dtype/shape")
    count = int(want)
    check(int(got) == count, f"intersect {name}: kernel {int(got)} != plain {count}")
    # library yardstick: the search step alone, on the ready gathered rows
    nu, nv = adj[src.long()], adj[dst.long()]
    t_k = cuda_ms(torch, kernel)
    t_dev = device_ms(torch, kernel)
    t_p = cuda_ms(torch, plain)
    t_l = cuda_ms(torch, lambda: torch.searchsorted(nv, nu))
    del nu, nv
    # bound: src/dst once, each touched row's real entries once, the count;
    # operations: one compare per probe of each candidate's search
    nbytes = intersect_bytes(torch, src, dst, row_len, sentinel)
    ls, ld = row_len[src.long()], row_len[dst.long()]
    probes = int((ls * torch.ceil(torch.log2(ld.double() + 1)).long()).sum())
    b_ms, b_by = bound_ms(nbytes, probes)
    return dict(case=name, ms=t_k, device_ms=t_dev, plain_ms=t_p, library_ms=t_l,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=abs(int(got) - count),
                compare="bitwise", count=count, edges=int((src != sentinel).sum()),
                candidates=int(ls.sum()), dmax=adj.shape[1], bytes=nbytes, probes=probes)


# the intersect kernel's tile: candidates a block takes at a time, edges and
# target-row entries it stages (graph_ops.cu kITile, kIEdges, kIRows)
INTERSECT_TILE, INTERSECT_EDGES, INTERSECT_ROWS = 2048, 1024, 6144


def intersect_work(torch, osrc, odst, row_len):
    """What the intersect kernel's tiles meet on a whole list, by its own
    rules: candidates (each edge's source-row length), tiles, the share of
    candidates whose target row is staged in shared memory, lies past the
    row stage, or sits in a tile of too many edges to stage; the target-row
    entries staged per candidate; and the mean bisection steps
    (ceil(log2(len + 1)) of the target row) of a candidate, overall and of
    those that probe device memory.  Candidate-weighted mean lengths of the
    source and target rows say how full a warp would be under one edge a
    warp, a lane a candidate."""
    ls = row_len[osrc.long()]
    lt = row_len[odst.long()]
    cum = torch.cumsum(ls, 0)
    total = int(cum[-1])
    tiles = -(-total // INTERSECT_TILE)
    c0 = torch.arange(tiles, device=ls.device, dtype=torch.int64) * INTERSECT_TILE
    k0 = torch.searchsorted(cum, c0, right=True)
    k1 = torch.cat([k0[1:], torch.searchsorted(cum, cum.new_tensor([total - 1]), right=True)])
    nk = k1 - k0 + 1
    # one (tile, edge) pair for each edge of each tile
    t = torch.repeat_interleave(torch.arange(tiles, device=ls.device), nk)
    first = torch.cumsum(nk, 0) - nk
    k = k0[t] + torch.arange(t.shape[0], device=ls.device) - first[t]
    del first
    cands = (torch.minimum(cum[k], c0[t] + INTERSECT_TILE) -
             torch.maximum(cum[k] - ls[k], c0[t])).clamp_min(0)
    ln = torch.where(ls[k] > 0, lt[k], 0)
    ends = torch.cumsum(ln, 0)
    tile_base = (ends - ln)[torch.cumsum(nk, 0) - nk]
    off_end = ends - tile_base[t]
    staged_tile = (nk <= INTERSECT_EDGES)[t]
    in_stage = staged_tile & (off_end <= INTERSECT_ROWS)
    past = staged_tile & ~in_stage
    steps = torch.ceil(torch.log2(lt[k].double() + 1))
    staged_entries = float(torch.where(staged_tile & (off_end <= INTERSECT_ROWS), ln, 0).sum())
    out = dict(candidates=total, tiles=tiles,
               staged_tile_share=float((nk <= INTERSECT_EDGES).double().mean()),
               candidates_in_staged_rows=float(cands[in_stage].sum()) / total,
               candidates_past_row_stage=float(cands[past].sum()) / total,
               candidates_in_unstaged_tiles=float(cands[~staged_tile].sum()) / total,
               staged_entries_per_candidate=staged_entries / total,
               mean_steps=float((cands * steps).sum()) / total,
               mean_steps_device_memory=float((cands * steps)[~in_stage].sum()) /
               max(float(cands[~in_stage].sum()), 1.0),
               mean_edges_per_tile=float(nk.double().mean()),
               source_len_by_candidate=float((ls.double() * ls).sum()) / total,
               target_len_by_candidate=float((ls.double() * lt).sum()) / total)
    del ls, lt, cum, t, k, cands, ln, ends, off_end, staged_tile, in_stage, past, steps
    return out


def intersect_whole_list(torch, gk, label, adj, osrc, odst, row_len, sentinel):
    """tc_count's intersections on one graph's whole padded list: one call
    (one launch per int32 group of chunks) against a launch per chunk, each
    chunk's count bitwise equal to the plain version's; the bound sums
    every chunk's bytes."""
    ch = INTERSECT_CHUNK
    want = gk.intersect_chunks_ref(adj, osrc, odst, sentinel, ch)

    def one():
        return gk.intersect_count(adj, osrc, odst, sentinel=sentinel, chunk=ch)

    def per_chunk():
        return torch.stack([gk.intersect_count(adj, osrc[c:c + ch], odst[c:c + ch],
                                               sentinel=sentinel)
                            for c in range(0, osrc.shape[0], ch)])

    before = gk.intersect_count.launches
    got = one()
    torch.cuda.synchronize()
    launches = gk.intersect_count.launches - before
    check(launches >= 1, f"intersect whole {label} list: no launch counted")
    check(torch.equal(got, want),
          f"intersect whole {label} list: chunk counts differ from the plain version's")
    check(torch.equal(per_chunk(), want),
          f"intersect whole {label} list: the per-chunk route differs")
    nbytes = sum(intersect_bytes(torch, osrc[c:c + ch], odst[c:c + ch], row_len, sentinel)
                 for c in range(0, osrc.shape[0], ch))
    b_ms, b_by = bound_ms(nbytes, 0)
    row = dict(case=f"{label} whole list ({want.shape[0]} chunks of {ch})",
               launches=launches, ms=cuda_ms(torch, one, reps=3),
               device_ms=device_ms(torch, one, reps=3),
               ms_per_chunk_launches=cuda_ms(torch, per_chunk, reps=2),
               bound_ms=b_ms, bound_by=b_by, bytes=nbytes, count=int(want.sum()),
               max_abs_err=0, compare="bitwise, every chunk")
    row.update(intersect_work(torch, osrc, odst, row_len))
    if row["device_ms"] is not None:
        row["device_ps_per_candidate"] = row["device_ms"] * 1e9 / row["candidates"]
    return row


def small_suite_check(torch, np, tc, suite, gen_mod):
    """kcore, bc and tc on the quickstart graph on the card against the
    plain version on the CPU, which the CPU tests hold against the JAX
    package."""
    kcore, bc, tri = suite
    src, dst, n = gen_mod.web_crawl_like(16, 5, 8, 2, seed=0)
    w = gen_mod.random_weights(len(src), seed=1)
    source = int(np.argmax(np.bincount(src, minlength=n)))
    res = {}
    for dev in ("cuda", "cpu"):
        g = tc.from_coo(src, dst, n, w, build_csc=True, device=dev)
        gs = tc.from_coo(src, dst, n, symmetrize=True, device=dev)
        res[dev] = {"kcore_peel": kcore.kcore_peel(gs, 3),
                    "kcore_dd_sparse": kcore.kcore_dd_sparse(gs, 3),
                    "core_numbers": (kcore.core_numbers(gs, 16), None),
                    "bc": bc.bc_brandes(g, source),
                    "tc": tri.tc_count(gs)}
    for name in res["cuda"]:
        (la, sa), (lb, sb) = res["cuda"][name], res["cpu"][name]
        compare_runs(torch, f"small {name}", (la, sa, 0, 0), (lb, sb, 0, 0),
                     BC_TOL if name == "bc" else None)


def web_suite_runs(suite, g, gsym, source):
    kcore, bc, tri = suite
    return {
        "kcore_peel(k=3)": Run(lambda: kcore.kcore_peel(gsym, 3)),
        "kcore_dd_sparse(k=3)": Run(lambda: kcore.kcore_dd_sparse(gsym, 3)),
        "kcore_dd_sparse(k=64)": Run(lambda: kcore.kcore_dd_sparse(gsym, 64)),
        "kcore_dd_sparse(k=64,fused=False)":
            Run(lambda: kcore.kcore_dd_sparse(gsym, 64, fused=False)),
        "core_numbers(k_max=64)": Run(lambda: (kcore.core_numbers(gsym, 64), None)),
        "bc_brandes": Run(lambda: bc.bc_brandes(g, source), BC_TOL),
        "tc_count": Run(lambda: tri.tc_count(gsym)),
    }


def kron_suite_runs(algos, suite, g, g_unw, gsym, source):
    """The seven calls of ``examples/paper_suite.py:run_input``."""
    bfs, sssp, cc, pagerank = algos
    kcore, bc, tri = suite
    return {
        "bfs_dd_sparse": Run(lambda: bfs.bfs_dd_sparse(g_unw, source)),
        "sssp_delta": Run(lambda: sssp.sssp_delta(g, source)),
        "cc_pointer_jump": Run(lambda: cc.cc_pointer_jump(gsym)),
        "pr_push": Run(lambda: pagerank.pr_push(gsym), PR_TOL, dense_m=gsym.m),
        "kcore_peel(k=3)": Run(lambda: kcore.kcore_peel(gsym, 3)),
        "bc_brandes": Run(lambda: bc.bc_brandes(g, source), BC_TOL),
        "tc_count": Run(lambda: tri.tc_count(gsym)),
    }


def run_suite_both(torch, gk, ops, label, runs, expect):
    """One path: "cuda" with the counts set to 0 just before and read just
    after, then "torch"; compares every run.  Returns the cuda launches."""
    gk.reset_launches()
    cuda_runs = run_path(torch, runs, "cuda", ops)
    launches = gk.launch_counts()
    print(f"{label} launches: {json.dumps(launches)}", flush=True)
    for k in expect:
        check(launches[k] > 0, f"{label}: kernel {k} was not launched")
    torch_runs = run_path(torch, runs, "torch", ops)
    check(gk.launch_counts() == launches, f"{label}: the torch substrate launched a kernel")
    for name, run in runs.items():
        compare_runs(torch, f"{label} {name}", cuda_runs[name], torch_runs[name],
                     run.tol, run.dense_m)
    return launches, cuda_runs, torch_runs


def bc_hazard(torch, ops, bc_mod, g, source, runs_by_sub):
    """bc's sigma is f32 path counts: print the non-finite entries of
    sigma and of the scores under each substrate."""
    for sub, runs in runs_by_sub.items():
        with ops.substrate_scope(sub):
            levels, _, sigma = bc_mod.brandes_forward(g, source)
        score = runs["bc_brandes"][0]
        print(f"  bc {sub}: levels={levels} sigma_nonfinite="
              f"{int((~torch.isfinite(sigma)).sum())} sigma_max={float(sigma.max())} "
              f"bc_nonfinite={int((~torch.isfinite(score)).sum())} "
              f"bc_max={float(score[torch.isfinite(score)].max())}", flush=True)


# ---- phases 9a-9d: fetches per stretch, det add, out of core, memtier --------

LOOP_ROUNDS = 2_000            # the timed device-loop case's stretch, in rounds
OOC_CC_ROUNDS = 50             # cc_dd_sparse's rounds out of core (depth cut from its
                               # 326 to keep the run in its time; both sides stop there)
OOC_PR_ITERS = 20              # pr_push's rounds out of core (depth cut from the JAX
                               # outofcore suite's 50: every round streams the graph)


def sync_count(torch, fn):
    """``(fn(), blocking syncs it made)``: torch's sync debug mode warns on
    each synchronizing CUDA call; the warnings are caught and counted."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in seen if "synchroniz" in str(w.message)]
    return out, len(syncs)


def fetch_counted(eng, fn):
    before = eng.fetch.calls
    out = fn()
    return out, eng.fetch.calls - before


def device_loop_case(torch, eng, fr, dl, bfs, label, g, source, limit):
    """The device loop against its plain version (a Python do-while that
    reads the band flag after each round) on ``limit`` rounds of the first
    sparse stretch of bfs from ``source``: state and round count bitwise,
    then both timed."""
    e = eng.SparseLadderEngine(g, bfs._sparse_step, bfs._dense_step)
    mask = bfs._source_mask(g, source)
    state = (bfs._init_dist(g, source), mask, fr.round_scalars(g, mask))
    _, cap_need, mass_med, _ = state[2].tolist()
    cap, budget, dense = e._pick(cap_need, mass_med)
    check(not dense, f"device loop {label}: the first round is not sparse")
    one_round = eng._sparse_round(
        g, step=bfs._sparse_step, capacity=cap, budget=budget,
        lo_cap=fr.ladder_below(cap, e.cap_ladder),
        lo_budget=fr.ladder_below(budget, e.budget_ladder), cutoff=e.sparse_cutoff)
    with dl.StretchGraphs() as graphs:
        before = dl.do_while.launches
        (lab, msk, sc), k = dl.do_while(one_round, state, limit, graphs=graphs, key=label)
        k = int(k)
        graphs.settle(k)
        check(dl.do_while.launches == before + 1, f"device loop {label}: no launch counted")
        (plab, pmsk, psc), pk = dl.do_while_plain(one_round, state, limit)
        check(k == pk and torch.equal(bits(torch, lab), bits(torch, plab))
              and torch.equal(msk, pmsk) and torch.equal(sc, psc),
              f"device loop {label}: differs from its plain version ({k} vs {pk} rounds)")
        err = float((lab.double() - plab.double()).abs().max())
        t_k = cuda_ms(torch, lambda: dl.do_while(one_round, state, limit, graphs=graphs,
                                                 key=label))
        t_p = cuda_ms(torch, lambda: dl.do_while_plain(one_round, state, limit))
    return dict(case=f"{label}: {k} rounds of rung (cap {cap}, budget {budget})", rounds=k,
                ms=t_k, plain_ms=t_p, max_abs_err=err, compare="bitwise")


def fetch_phase(torch, np, tc, gen_mod, eng, fr, dl, bfs, sssp, g, source):
    """9a: blocking fetches per stretch.  BFS on path(65,536), fused, with
    every blocking sync on the card counted (at most 3); sssp_dd_sparse on
    the web graph, 2 x stretches <= rounds; bfs_dd_sparse's fused and
    per-round walls on the web graph (printed, no target); then the device
    loop against its plain version, on the path and on the web graph."""
    src, dst, n = gen_mod.path(65_536)
    gp = tc.from_coo(src, dst, n)
    bfs.bfs_dd_sparse(gp, 0, max_rounds=8)          # warm every kernel of it up
    t0 = time.perf_counter()
    ((dist, st), fetches), syncs = sync_count(
        torch, lambda: fetch_counted(eng, lambda: bfs.bfs_dd_sparse(gp, 0)))
    wall = (time.perf_counter() - t0) * 1e3
    check(int((dist < 1e30).sum()) == n and float(dist[n - 1]) == n - 1,
          "path bfs: wrong distances")
    print(f"fetches: path(65536) bfs_dd_sparse fused: rounds={st.rounds} fetches={fetches} "
          f"blocking_syncs={syncs} wall_ms={wall}", flush=True)
    check(syncs <= 3 and fetches <= 3, f"path bfs: {syncs} blocking syncs, {fetches} fetches")
    (dist_s, st_s), fetches = fetch_counted(eng, lambda: sssp.sssp_dd_sparse(g, source))
    stretches = fetches - 1
    print(f"fetches: web sssp_dd_sparse: rounds={st_s.rounds} stretches={stretches} "
          f"(sparse {st_s.sparse_rounds}, dense {st_s.dense_rounds})", flush=True)
    check(1 <= stretches and 2 * stretches <= st_s.rounds,
          f"web sssp: {stretches} stretches for {st_s.rounds} rounds")
    walls = {}
    for fused in (True, False, True, False):
        torch.cuda.synchronize()
        caps, cap_s = dl.do_while.captures, dl.do_while.capture_s
        t0 = time.perf_counter()
        (d, s), f = fetch_counted(eng, lambda: bfs.bfs_dd_sparse(g, source, fused=fused))
        torch.cuda.synchronize()
        walls.setdefault(fused, []).append((time.perf_counter() - t0) * 1e3)
        walls[f"fetches {fused}"] = f
        if fused:
            walls.setdefault("captures", []).append(
                (dl.do_while.captures - caps, (dl.do_while.capture_s - cap_s) * 1e3))
    print(f"fetches: web bfs_dd_sparse walls_ms fused={walls[True]} per_round={walls[False]} "
          f"fetches fused={walls['fetches True']} per_round={walls['fetches False']}; "
          f"the fused runs' (captures, ms of host time) {walls['captures']}", flush=True)
    rows = [device_loop_case(torch, eng, fr, dl, bfs, "path(65536)", gp, 0, LOOP_ROUNDS),
            device_loop_case(torch, eng, fr, dl, bfs, "web", g, source, 10**6)]
    for row in rows:
        print("  device_loop " + json.dumps(row), flush=True)
    return rows


def det_phase(torch, np, tc, gen_mod, ops, pagerank, bc, g, gsym, source):
    """9b: deterministic add on the card: pr_push, pr_pull and bc under
    ``deterministic_add_scope`` on the web graph, bitwise equal across the
    two substrates; on phase 5's quickstart graph, pr_push's raw rank and
    residual and bc's scores bitwise equal to the CPU's, pr_pull within
    PR_TOL (its per-round sums are plain torch reductions)."""
    src, dst, n = gen_mod.web_crawl_like(16, 5, 8, 2, seed=0)
    w = gen_mod.random_weights(len(src), seed=1)
    small_source = int(np.argmax(np.bincount(src, minlength=n)))
    small = {dev: (tc.from_coo(src, dst, n, w, build_csc=True, device=dev),
                   tc.from_coo(src, dst, n, symmetrize=True, build_csc=True, device=dev))
             for dev in ("cuda", "cpu")}
    with ops.deterministic_add_scope(True):
        raw = [pagerank._pr_push_raw(small[dev][1], 0.85, 1e-9, 10_000)
               for dev in ("cuda", "cpu")]
        check(all(torch.equal(bits(torch, x.cpu()), bits(torch, y)) for x, y in
                  zip(raw[0][:2], raw[1][:2])) and raw[0][2] == raw[1][2],
              "det pr_push small: raw rank and residual differ between card and cpu")
        for name, fn in (("pr_push", lambda gw, gs, s: pagerank.pr_push(gs)),
                         ("pr_pull", lambda gw, gs, s: pagerank.pr_pull(gs)),
                         ("bc_brandes", lambda gw, gs, s: bc.bc_brandes(gw, s))):
            res = {}
            for sub in ("cuda", "torch"):
                with ops.substrate_scope(sub):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res[sub] = fn(g, gsym, source)
                    torch.cuda.synchronize()
                    res[sub + " ms"] = (time.perf_counter() - t0) * 1e3
            compare_runs(torch, f"det {name} web", (*res["cuda"], 0, 0),
                         (*res["torch"], 0, 0))
            a, b = (fn(*small[dev], small_source) for dev in ("cuda", "cpu"))
            # pr_pull's dangling mass and residual are plain torch sums,
            # taken in another order on the CPU: allclose there
            compare_runs(torch, f"det {name} small card/cpu", (*a, 0, 0), (*b, 0, 0),
                         PR_TOL if name == "pr_pull" else None)
            check(bool(torch.isfinite(res["cuda"][0]).all()), f"det {name}: non-finite")
            print(f"det add {name}: web bitwise across substrates (cuda {res['cuda ms']} ms, "
                  f"torch {res['torch ms']} ms), quickstart graph bitwise card == cpu",
                  flush=True)


def shard_relax_cases(torch, tg, rng):
    """edge_relax on the web graph's shards as the streamed path gives them
    (``tiered._shard_relax`` / ``_shard_pull``): the push case over a
    middle CSR shard and the last, partial one (sentinel padding), the pull
    case over a CSC shard, and the reversed push over a CSR shard (src
    unsorted), f32 min under a vertex mask."""
    dev = tg.device
    n_pad = tg.n_pad
    mask = torch.rand(n_pad, generator=rng, device=dev) < 0.3
    mask[n_pad - 1] = False
    val = torch.rand(n_pad, generator=rng, device=dev) * 100.0
    init = torch.full((n_pad,), 50.0, device=dev)

    def shard(host, sid):
        s, d, w = host[sid]
        return tuple(torch.from_numpy(x).to(dev) for x in (s, d, w))

    mid, last = tg.nshards // 2, tg.nshards - 1
    out = []
    for name, (s, d, w), case in (
            (f"shard push f32 min, CSR shard {mid}", shard(tg._host, mid), "push"),
            (f"shard push f32 min, last CSR shard {last} "
             f"({int(tg.shard_sizes[last])} of {tg.epd} slots real)",
             shard(tg._host, last), "push"),
            (f"shard pull f32 min, CSC shard {mid}", shard(tg._csc_host, mid), "pull")):
        out.append((name, dict(src=s, dst=d, w=w, mask=mask, src_val=val, out_init=init,
                               kind="min", use_weight=True, vertex_mask=True, case=case)))
    s, d, w = shard(tg._host, mid)
    out.append((f"shard reversed push f32 min, CSR shard {mid} (src = its dst, unsorted)",
                dict(src=d, dst=s, w=w, mask=mask, src_val=val, out_init=init, kind="min",
                     use_weight=True, vertex_mask=True, case="pull")))
    return out


def busy_shares(torch, fn):
    """``(kernel_ms, copy_ms)`` of one profiled call of ``fn``: device time
    of its kernels and of its copies (which overlap them on the copy
    stream), or ``(None, None)`` where the profiler records none."""
    events, _ = profiled(torch, fn)
    kern = copy = 0.0
    for ev in events or ():
        ms = (getattr(ev, "self_device_time_total", 0) or 0) / 1e3
        if "Memcpy" in ev.key or "memcpy" in ev.key:
            copy += ms
        else:
            kern += ms
    return (kern, copy) if kern > 0 else (None, None)


def far_source(torch, ops, eng, g, owner):
    """The source of the streamed traversals: the vertex whose reach along
    out-edges spans the most shards of the cut (``owner``: each vertex's
    shard), ties to the larger out-degree.  Each vertex's shard index is
    propagated backwards along the edges (a reversed push) to a fixed
    point, once by max and once by min: the last and the first shard it
    reaches.  Returns ``(source, first shard, last shard, rounds)``."""
    valid = g.valid_vertex_mask()
    sid = owner.to(torch.float32)

    def step(state):
        hi, lo, _ = state
        nhi = ops.push_dense(g, hi, valid, hi, kind="max", use_weight=False, reverse=True)
        nlo = ops.push_dense(g, lo, valid, lo, kind="min", use_weight=False, reverse=True)
        return nhi, nlo, torch.any(nhi != hi) | torch.any(nlo != lo)

    rounds, (hi, lo, _) = eng.run_dense(step, (sid, sid.clone(), True), lambda st: st[2],
                                        100_000)
    span = (hi - lo).to(torch.int64) + 1
    score = torch.where(valid, span * (1 << 32) + g.out_deg.to(torch.int64), -1)
    v = int(score.argmax())
    return v, int(lo[v]), int(hi[v]), rounds


def ooc_run(torch, label, fn, tg, resident=None, busy=False):
    """One streamed run from an empty pool (so the stream counters are the
    run's own): wall, stream counters, exact h2d accounting, with ``busy``
    the device's kernel and copy busy shares (a second, profiled call), and
    against a resident run ``(labels, stats, wall_ms)`` the time per edge
    touched."""
    tg._pool.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels, st = fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    check(st.placement == "tiered" and st.h2d_bytes == st.shards_streamed * tg.shard_bytes,
          f"ooc {label}: h2d_bytes {st.h2d_bytes} != {st.shards_streamed} x {tg.shard_bytes}")
    kern, copy = busy_shares(torch, fn) if busy else (None, None)
    line = dict(run=label, wall_ms=wall, rounds=st.rounds, edges_touched=st.edges_touched,
                h2d_bytes=st.h2d_bytes, shards_streamed=st.shards_streamed,
                buffer_hits=st.buffer_hits, io_wait_us=st.io_wait_us,
                h2d_gbps=st.h2d_bytes / (wall * 1e-3) / 1e9,
                kernel_busy_share=None if kern is None else kern / wall,
                copy_busy_share=None if copy is None else copy / wall,
                pull_rounds=st.pull_rounds)
    if resident is not None and st.edges_touched and resident[1].edges_touched:
        line["per_edge_vs_resident"] = ((wall / st.edges_touched)
                                        / (resident[2] / resident[1].edges_touched))
    print("  ooc " + json.dumps(line), flush=True)
    return labels, st, wall


def timed_run(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels, st = fn()
    torch.cuda.synchronize()
    return labels, st, (time.perf_counter() - t0) * 1e3


def ooc_phase(torch, gk, ops, eng, tiered, store, bfs, sssp, cc, pagerank, g, gsym, hub,
              rng, directory):
    """9c: out of core on phase 3's graphs, each cut into 16 shards with a
    pool of 2 (the CSR 8 times the pool).  Labels bitwise equal to the
    resident runs, pagerank bitwise across pools and fused against eager
    under deterministic add and allclose to the resident run, h2d_bytes ==
    shards_streamed x shard_bytes exactly, edges_touched equal to the
    resident run's for bfs_dirop and pr_pull; then the web graph through
    the store.  The traversals of the web graph start at ``far_source``,
    whose reach crosses the most shards (the hub's stays in one), and each
    must stream more shards than the pool holds.  The store is saved
    under ``directory`` and kept for 9f.  Returns (edge_relax shard rows,
    edge_relax launches, the far source, its resident bfs labels)."""
    t0 = time.perf_counter()
    tg = tiered.tier_graph(g, nshards=16, resident_shards=2, build_csc=True)
    tgs = tiered.tier_graph(gsym, nshards=16, resident_shards=2, build_csc=True)
    print(f"ooc: cut both graphs into 16 pinned host shards in {time.perf_counter() - t0} s; "
          f"web epd={tg.epd} shard_bytes={tg.shard_bytes} csr_bytes={tg.csr_bytes} "
          f"budget={tg.resident_budget}; sym shard_bytes={tgs.shard_bytes} "
          f"csr_bytes={tgs.csr_bytes}", flush=True)
    rows = []
    for name, kw in shard_relax_cases(torch, tg, rng):
        row = run_edge_relax_case(torch, gk, name, kw)
        rows.append(row)
        print("  edge_relax " + json.dumps(row), flush=True)
    t0 = time.perf_counter()
    source, first, last, rounds = far_source(torch, ops, eng, g, tg.owner)
    print(f"ooc: source {source} (out-degree {int(g.out_deg[source])}) reaches shards "
          f"{first}..{last} of the web graph's cut (the hub's reach: shards "
          f"{int(tg.owner[hub])}..); found in {rounds} rounds, "
          f"{(time.perf_counter() - t0) * 1e3} ms", flush=True)
    check(last - first + 1 > tg.resident_shards,
          f"ooc: no source reaches more than {tg.resident_shards} shards")
    res = {name: timed_run(torch, fn) for name, fn in (
        ("bfs", lambda: bfs.bfs_dd_sparse(g, source)),
        ("sssp", lambda: sssp.sssp_dd_sparse(g, source)),
        ("dirop", lambda: bfs.bfs_dirop(g, source)),
        ("cc", lambda: cc.cc_dd_sparse(gsym, max_rounds=OOC_CC_ROUNDS)),
        ("pr_push", lambda: pagerank.pr_push(gsym, max_iters=OOC_PR_ITERS)),
        ("pr_pull", lambda: pagerank.pr_pull(gsym)))}
    gk.reset_launches()
    # busy shares (a profiled second call) of one run of each kind
    for label, fn, ref, exact, busy in (
            ("bfs_dd_sparse", lambda: bfs.bfs_dd_sparse(tg, source), "bfs", True, True),
            ("bfs_dd_sparse(fused=False)", lambda: bfs.bfs_dd_sparse(tg, source, fused=False),
             "bfs", True, False),
            ("sssp_dd_sparse", lambda: sssp.sssp_dd_sparse(tg, source), "sssp", True, False),
            ("bfs_dirop", lambda: bfs.bfs_dirop(tg, source), "dirop", True, True),
            ("cc_dd_sparse", lambda: cc.cc_dd_sparse(tgs, max_rounds=OOC_CC_ROUNDS), "cc",
             True, False),
            ("pr_push", lambda: pagerank.pr_push(tgs, max_iters=OOC_PR_ITERS), "pr_push",
             False, True),
            ("pr_pull", lambda: pagerank.pr_pull(tgs), "pr_pull", False, True)):
        web = ref in ("bfs", "sssp", "dirop")
        labels, st, _ = ooc_run(torch, label, fn, tg if web else tgs, res[ref], busy)
        if web:
            check(st.shards_streamed > tg.resident_shards,
                  f"ooc {label}: {st.shards_streamed} shards streamed, the pool holds "
                  f"{tg.resident_shards}")
        want = res[ref][0]
        if exact:
            check(torch.equal(bits(torch, labels), bits(torch, want)),
                  f"ooc {label}: labels differ from the resident run")
        else:
            check(torch.allclose(labels, want, rtol=PR_TOL[0], atol=PR_TOL[1]),
                  f"ooc {label}: ranks outside {PR_TOL} of the resident run")
        if ref in ("dirop", "pr_pull"):
            check(st.edges_touched == res[ref][1].edges_touched
                  and st.rounds == res[ref][1].rounds,
                  f"ooc {label}: edges_touched {st.edges_touched} != resident "
                  f"{res[ref][1].edges_touched}")
    launches = gk.launch_counts()
    print(f"ooc launches (cuda): {json.dumps(launches)}", flush=True)
    check(launches["edge_relax"] > 0, "ooc: edge_relax was not launched on the streamed path")
    with ops.substrate_scope("torch"):
        labels, st, _ = ooc_run(torch, "bfs_dd_sparse [torch]",
                                lambda: bfs.bfs_dd_sparse(tg, source), tg, res["bfs"])
    check(torch.equal(labels, res["bfs"][0]) and st.shards_streamed > tg.resident_shards,
          f"ooc bfs [torch]: labels differ, or {st.shards_streamed} shards streamed")
    check(gk.launch_counts() == launches, "ooc: the torch substrate launched a kernel")
    tgs16 = tiered.tier_graph(gsym, nshards=16, resident_shards=16)
    with ops.deterministic_add_scope(True):
        det = {}
        for label, t, fused in (("pool 2", tgs, True), ("pool 16", tgs16, True),
                                ("pool 2, eager", tgs, False)):
            det[label] = ooc_run(torch, f"pr_push det {label}",
                                 lambda: pr_push_streamed(torch, eng, pagerank, t, fused), t)[0]
    check(torch.equal(det["pool 2"], det["pool 16"]) and
          torch.equal(det["pool 2"], det["pool 2, eager"]),
          "ooc pr_push det: not bitwise across pools and regimes")
    check(torch.allclose(det["pool 2"], res["pr_push"][0], rtol=PR_TOL[0], atol=PR_TOL[1]),
          "ooc pr_push det: outside PR_TOL of the resident run")
    del tgs, tgs16
    shutil.rmtree(directory, ignore_errors=True)
    t0 = time.perf_counter()
    store.save_graph(tg, str(directory))
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    opened = store.open_graph(str(directory), resident_shards=2, verify="open")
    t_open = time.perf_counter() - t0
    check(opened.shard_crcs == tg.shard_crcs and opened.verified,
          "store: CRCs differ from the cut's")
    labels, st, _ = ooc_run(torch, "bfs_dd_sparse [store, mmap]",
                            lambda: bfs.bfs_dd_sparse(opened, source), opened, res["bfs"])
    check(torch.equal(labels, res["bfs"][0]) and st.shards_streamed > opened.resident_shards,
          f"store bfs: labels differ, or {st.shards_streamed} shards streamed")
    # every shard of both directions through the pinned staging ring
    vals = torch.rand(g.n_pad, generator=rng, device="cuda") * 100.0
    act = g.valid_vertex_mask()
    opened._pool.clear()   # every shard of both directions misses
    io0 = opened.io.snapshot()
    for name, got, want in (
            ("reversed push", ops.push_dense(opened, vals, act, vals, reverse=True),
             ops.push_dense(g, vals, act, vals, reverse=True)),
            ("pull", ops.pull_dense(opened, vals, act, vals), ops.pull_dense(g, vals, act, vals))):
        check(torch.equal(bits(torch, got), bits(torch, want)),
              f"store {name}: differs from the resident relax")
    streamed = opened.io.shards_streamed - io0[1]
    check(opened.io.h2d_bytes - io0[0] == streamed * opened.shard_bytes
          and streamed == 2 * opened.nshards, f"store relaxes: {streamed} shards streamed")
    print(f"store: saved in {t_save} s, opened with verify='open' in {t_open} s, "
          f"bfs equal; a reversed push and a pull over every shard streamed {streamed} "
          f"shards through the staging ring, bitwise equal to the resident relaxes",
          flush=True)
    return rows, launches["edge_relax"], source, res["bfs"][0]


def pr_push_streamed(torch, eng, pagerank, tg, fused):
    """pr_push's streamed run of ``OOC_PR_ITERS`` rounds through
    ``run_streamed(fused=...)``, normalised as ``pr_push`` does: the eager
    regime is the runner's option, not pr_push's."""
    valid = tg.valid_vertex_mask()
    step, cond, active = pagerank._pr_streamed_fns(0.85, 1e-9)
    io0 = tg.io.snapshot()
    state0 = (torch.zeros(tg.n_pad, device=tg.device),
              torch.where(valid, 1.0 - 0.85, 0.0))
    rounds, (rank, resid) = eng.run_streamed(tg, step, state0, cond, active, OOC_PR_ITERS,
                                             fused=fused)
    rank = rank + resid
    return (torch.where(valid, rank / rank.sum(), 0.0),
            pagerank._dense_stats(tg, rounds, io0))


def memtier_phase(memtier):
    """9d: the tiers measured on the card (``benchmarks/memtier.py``)."""
    rows = memtier.device_rows("cuda")
    for name, us, derived, _ in rows:
        print(f"  memtier {name},{us},{derived}", flush=True)


# ---- phases 9e-9g: the figure suites, resume, dynamic graphs -----------------

# a figure-suite row's call ("<algo>/<class or variant>") -> the phase 6, 8 or
# 9 run of the same function on the same container (kcore/peel in
# algo_classes peels k = 4, which no earlier phase runs)
SUITE_REFS = {
    "bfs/galois": "bfs_dd_sparse", "bfs/dd_sparse": "bfs_dd_sparse",
    "sssp/gap": "sssp_delta", "sssp/gbbs": "sssp_delta", "sssp/galois": "sssp_delta",
    "sssp/delta": "sssp_delta",
    "cc/gap": "cc_pointer_jump", "cc/galois": "cc_pointer_jump",
    "cc/pointer_jump": "cc_pointer_jump", "cc/dd_sparse": "cc_dd_sparse",
    "pr/graphit": "pr_pull", "pr/gap": "pr_pull", "pr/gbbs": "pr_pull",
    "pagerank/pull": "pr_pull", "pr/galois": "pr_push", "pagerank/push": "pr_push",
    "bc/all": "bc_brandes", "bc/brandes": "bc_brandes",
    "kcore/all": "kcore_peel(k=3)",
    "tc/all": "tc_count", "tc/orient_intersect": "tc_count",
}
# 9e's rows held against each other on one graph: every frameworks and
# algo_classes row of an algorithm has the labels of its anchor row, bitwise
SUITE_ANCHORS = {"bfs": "dd_sparse", "sssp": "delta", "cc": "pointer_jump"}
GRANULARITY_COMMUNITIES = 64   # an eighth of phase 3's 512, cut in depth only
# 9f's kill drills: (algo, pool); each is killed at a quarter of its
# uninterrupted rounds (at least 3) and snapshots every third of that;
# pr_push runs OOC_PR_ITERS rounds under deterministic add
RESUME_DRILLS = (("bfs", 2), ("pr_push", 16))
# 9g: inserts between existing vertices, symmetrized
DYN_BATCHES, DYN_BATCH_EDGES, DYN_POOLS = 6, 65_536, (16, 4)
# depth cuts of the pagerank replays: they take the first batch only, and
# the cross-pool pair stops each solve after DYN_DET_ITERS rounds (the
# converged replay at a pool of 16 is the one held to scratch): at a pool
# of 4 every round misses all 16 shards and re-checks their CRCs, 0.76 s a
# round on an H100 (PERF.md); DYN_SUB_ITERS rounds a solve for the substrate
# check
DYN_PR_BATCHES, DYN_DET_ITERS, DYN_SUB_ITERS = 1, 20, 20


class _Stats(dict):
    """A suite row's stats dict where ``compare_runs`` expects RunStats."""

    def as_dict(self):
        return dict(self)


def suite_rows_check(torch, label, rows, results, refs, dense_m):
    """Print each row with its counters, and hold it against the earlier
    phase's run of the same function on the same container: labels bitwise
    (pagerank within PR_TOL, its rounds within one; bc within BC_TOL);
    RunStats equal but ``substrate`` (tc's only by count: the suites chunk
    its edges by 8192)."""
    compared = 0
    for name, us, derived, stats in rows:
        print(f"  {label} {name} us={us} {derived}", flush=True)
        parts = name.split("/")
        ref = refs.get(SUITE_REFS.get(f"{parts[1]}/{parts[-1]}"))
        if ref is None:
            continue
        got = results[name]
        if parts[1] == "tc":
            check(int(got) == int(ref[0]), f"{label} {name}: count {got} != {ref[0]}")
        else:
            st = _Stats(stats)
            tol = (PR_TOL if parts[1] in ("pr", "pagerank") else
                   BC_TOL if parts[1] == "bc" else None)
            compare_runs(torch, f"{label} {name}", (got, st, 0, 0), (ref[0], ref[1], 0, 0),
                         tol, dense_m if tol is PR_TOL else None)
        compared += 1
    return compared


def suite_cross_check(torch, label, results):
    """Hold one graph's suite rows against each other: every bfs, sssp and
    cc row (the frameworks' classes and algo_classes' variants) has the
    labels of algo_classes' SUITE_ANCHORS row, and the two k = 4 peels
    keep the same vertices; all bitwise.  ``results`` maps the row names
    of that graph to their labels.  Returns the number of rows held."""
    held = 0
    for algo, variant in SUITE_ANCHORS.items():
        anchor = f"fig6/{algo}/{label}/{variant}"
        want = bits(torch, results[anchor].cpu())
        for name, got in results.items():
            if name.split("/")[1] == algo and name != anchor:
                check(torch.equal(bits(torch, got.cpu()), want),
                      f"9e {label}: {name} differs from {anchor}")
                held += 1
    peel, dd = (results[f"fig7/kcore/{label}/{v}"].cpu() for v in ("peel", "dd_sparse"))
    check(torch.equal(peel, dd), f"9e {label}: the two k = 4 peels keep different vertices")
    return held + 1


def suites_phase(torch, np, gk, gen_mod, benches, web, kron, refs):
    """9e: the paper's figure suites at full width.  ``frameworks`` on both
    graphs and ``algo_classes`` on both, warm-up 1 and one timed call, each
    row held against the earlier phases' run of the same call and against
    its graph's anchor row (``suite_cross_check``); then
    ``granularity`` on a web graph cut to GRANULARITY_COMMUNITIES
    communities (it rebuilds its graph at three block sizes).  Returns the
    kernel launches of the suites' cuda runs."""
    granularity, frameworks, algo_classes = benches
    gk.reset_launches()
    compared = 0
    by_graph = {}
    for label, graphs in (("web", web), ("kron", kron)):
        t0 = time.perf_counter()
        results = by_graph[label] = {}
        rows = frameworks.run(graphs=graphs[:3], warmup=1, iters=1, results=results)
        compared += suite_rows_check(torch, f"frameworks[{label}]", rows, results,
                                     refs[label], graphs[1].m)
        print(f"9e frameworks[{label}]: {len(rows)} rows in {time.perf_counter() - t0} s",
              flush=True)
    t0 = time.perf_counter()
    results = {}
    rows = algo_classes.run(graphs={"web": web[:3], "kron": kron[:3]}, warmup=1, iters=1,
                            results=results)
    for label in ("web", "kron"):
        compared += suite_rows_check(
            torch, "algo_classes", [r for r in rows if f"/{label}/" in r[0]], results,
            refs[label], (web if label == "web" else kron)[1].m)
    check(len(rows) == 36, f"algo_classes: {len(rows)} rows, not 36")
    held = 0
    for label, res in by_graph.items():
        res.update((k, v) for k, v in results.items() if f"/{label}/" in k)
        held += suite_cross_check(torch, label, res)
    print(f"9e algo_classes: {len(rows)} rows in {time.perf_counter() - t0} s", flush=True)
    t0 = time.perf_counter()
    coo = gen_mod.web_crawl_like(GRANULARITY_COMMUNITIES, 13, 16, 3, seed=0)
    results = {}
    rows = granularity.run(graphs=coo, warmup=1, iters=1, results=results)
    for name, us, derived, stats in rows:
        print(f"  granularity {name} us={us} {derived}", flush=True)
    n = coo[2]
    dists = [results[r[0]][:n] for r in rows]
    check(all(torch.equal(dists[0], d) for d in dists[1:])
          and len({r[3]["rounds"] for r in rows}) == 1 and int((dists[0] < 1e30).sum()) > 1,
          "granularity: the block sizes disagree on distances or rounds")
    print(f"9e granularity on web_crawl_like({GRANULARITY_COMMUNITIES}, 13, 16, 3) "
          f"(n={coo[2]}, m={len(coo[0])}; cut from 512 communities in depth only): "
          f"{len(rows)} rows in {time.perf_counter() - t0} s (three host builds)",
          flush=True)
    launches = gk.launch_counts()
    print(f"9e launches (cuda): {json.dumps(launches)}; {compared} rows equal to the "
          f"earlier phases' runs; {held} rows equal to their graph's anchor row",
          flush=True)
    for k in ("edge_relax", "advance", "intersect"):
        check(launches[k] > 0, f"9e: kernel {k} was not launched")
    return launches


def resume_child(spec):
    """One process of 9f's kill drill (``--resume-child JSON``): open the
    store, attach the kill at round ``kill_at`` when ``mode`` is "kill",
    run with a checkpointer, save the result beside the snapshots and
    print one JSON line.  Imports nothing of the JAX package."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.checkpoint import RunCheckpointer, open_graph
    from repro_torch.core import faultio
    from repro_torch.core import operators as ops
    from repro_torch.core.algorithms import bfs, pagerank

    tg = open_graph(spec["store"], resident_shards=spec["pool"])
    if spec["mode"] == "kill":
        tg.set_fault_injector(faultio.FaultInjector([faultio.kill("round",
                                                                  at=spec["kill_at"])]))
    ckr = RunCheckpointer(spec["ckdir"], every=spec["every"])
    t0 = time.perf_counter()
    if spec["algo"] == "bfs":
        out, st = bfs.bfs_dd_sparse(tg, spec["source"], checkpointer=ckr)
    else:
        with ops.deterministic_add_scope(True):
            out, st = pagerank.pr_push(tg, max_iters=OOC_PR_ITERS, checkpointer=ckr)
    torch.cuda.synchronize()
    np.save(os.path.join(spec["ckdir"], "result.npy"), out.cpu().numpy())
    print(json.dumps(dict(rounds=st.rounds, saves=ckr.saves, save_s=ckr.save_s,
                          wall_s=time.perf_counter() - t0,
                          shards_streamed=st.shards_streamed,
                          jax_imported="jax" in sys.modules or "repro" in sys.modules)))
    return 0


def run_children(specs):
    """Start one ``--resume-child`` process per spec, all at once; returns
    ``[(returncode, stdout, stderr)]`` once every one has ended."""
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--resume-child", json.dumps(spec)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for spec in specs]
    out = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
        out.append((p.returncode, so, se))
    return out


def snapshot_steps(directory):
    return sorted(int(f[5:-4]) for f in os.listdir(directory)
                  if f.startswith("step_") and f.endswith(".npz"))


def resume_phase(torch, np, gk, ops, ck, bfs, pagerank, directory, far, far_ref, g,
                 source, bfs_ref, bfs_rounds):
    """9f: resume on the card.  The kill drill on the store 9c saved
    (``open_graph``, no new host build), for streamed bfs_dd_sparse from
    the far source and det-add pr_push: the uninterrupted run in this
    process, then a child killed at round r (``faultio.kill``, exit 7)
    with a committed snapshot, then a child that resumes; both results
    bitwise equal to the uninterrupted run.  Then a fused resume of web
    bfs_dd_sparse on the resident graph, twice, bitwise.  Returns the
    kernel launches of this process's cuda runs."""
    gk.reset_launches()
    root = directory.parent / f"{directory.name}_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    want, specs = {}, []
    for algo, pool in RESUME_DRILLS:
        tg = ck.open_graph(str(directory), resident_shards=pool)
        ckr = ck.RunCheckpointer(str(root / f"{algo}_uninterrupted"), every=4)
        t0 = time.perf_counter()
        if algo == "bfs":
            out, st = bfs.bfs_dd_sparse(tg, far, checkpointer=ckr)
            check(torch.equal(out, far_ref), "9f bfs: the streamed run differs from 9c's")
        else:
            with ops.deterministic_add_scope(True):
                out, st = pagerank.pr_push(tg, max_iters=OOC_PR_ITERS, checkpointer=ckr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want[algo] = out.cpu().numpy()
        kill_at = max(3, st.rounds // 4)
        every = max(2, kill_at // 3)
        print(f"9f {algo} uninterrupted (pool {pool}, a snapshot every 4 rounds): "
              f"rounds={st.rounds} wall_s={wall} snapshots={ckr.saves} save_s_each="
              f"{ckr.save_s / max(ckr.saves, 1)} shards_streamed={st.shards_streamed}; "
              f"the drill kills at round {kill_at}, snapshots every {every}", flush=True)
        check(st.rounds > kill_at and ckr.saves > 0, f"9f {algo}: too few rounds to kill")
        kill_dir = root / f"{algo}_kill"
        kill_dir.mkdir(parents=True)
        specs.append(dict(algo=algo, pool=pool, kill_at=kill_at, every=every,
                          store=str(directory), ckdir=str(kill_dir), source=far))
        del tg
    t0 = time.perf_counter()
    for spec, (rc, so, se) in zip(specs, run_children([dict(s, mode="kill") for s in specs])):
        steps = snapshot_steps(spec["ckdir"])
        print(f"9f {spec['algo']} killed at round {spec['kill_at']}: exit {rc}, snapshots "
              f"{steps}", flush=True)
        check(rc == 7, f"9f {spec['algo']}: the killed child exited {rc}, not 7: {se[-2000:]}")
        check(not os.path.exists(os.path.join(spec["ckdir"], "result.npy"))
              and steps and steps[-1] == spec["kill_at"] // spec["every"] * spec["every"],
              f"9f {spec['algo']}: snapshots {steps} after a kill at {spec['kill_at']}")
    t_kill = time.perf_counter() - t0
    t0 = time.perf_counter()
    for spec, (rc, so, se) in zip(specs, run_children([dict(s, mode="resume") for s in specs])):
        check(rc == 0, f"9f {spec['algo']}: the resumed child exited {rc}: {se[-2000:]}")
        line = json.loads(so.strip().splitlines()[-1])
        got = np.load(os.path.join(spec["ckdir"], "result.npy"))
        check(not line["jax_imported"], "9f: a child imported the JAX package")
        check(got.dtype == want[spec["algo"]].dtype
              and np.array_equal(got.view(np.int32), want[spec["algo"]].view(np.int32)),
              f"9f {spec['algo']}: the resumed result differs from the uninterrupted run")
        print(f"9f {spec['algo']} resumed: {json.dumps(line)}; bitwise equal to the "
              f"uninterrupted run", flush=True)
    print(f"9f children: kills {t_kill} s, resumes {time.perf_counter() - t0} s "
          f"(two at a time)", flush=True)
    # the fused ladder on the resident graph: snapshots at stretch boundaries
    ck_dir = root / "fused"
    ckr = ck.RunCheckpointer(str(ck_dir), every=1, keep_last=2)
    stop = max(1, bfs_rounds // 2)
    dist, st = bfs.bfs_dd_sparse(g, source, max_rounds=stop, checkpointer=ckr)
    steps = snapshot_steps(ck_dir)
    resumed = []
    for _ in range(2):   # from the latest snapshot, then from the one before
        dist, st = bfs.bfs_dd_sparse(g, source, checkpointer=ck.RunCheckpointer(
            str(ck_dir), every=10**9))
        check(torch.equal(bits(torch, dist), bits(torch, bfs_ref)),
              "9f fused resume: labels differ from the uninterrupted run")
        resumed.append((snapshot_steps(ck_dir)[-1], st.rounds))
        os.remove(ck_dir / f"step_{snapshot_steps(ck_dir)[-1]:010d}.npz")
    print(f"9f fused bfs_dd_sparse on the resident web graph ({bfs_rounds} rounds): "
          f"stopped at round {stop} with "
          f"snapshots {steps} ({ckr.saves} saves, {ckr.save_s / max(ckr.saves, 1)} s "
          f"each); resumed from (round, rounds run) {resumed}, bitwise twice", flush=True)
    shutil.rmtree(root, ignore_errors=True)
    launches = gk.launch_counts()
    print(f"9f launches (cuda, this process): {json.dumps(launches)}", flush=True)
    check(launches["edge_relax"] > 0 and launches["advance"] > 0,
          "9f: edge_relax or advance was not launched")
    return launches


def dynamic_substrates(torch, gk, ops, store, pagerank, directory, post):
    """9g's log-shard add relax against its plain version: the store the
    suite leaves (its base and the six batches' logs, saved before the
    compaction) opened at a pool of 16, a cold pr_incremental and, after
    ``post``, a warm one from the cuda run's state, each on both substrates
    under plain float add (deterministic add takes the plain fixed-order
    sum on both), DYN_SUB_ITERS rounds a solve: ranks within PR_TOL,
    rounds equal."""
    h = store.open_dynamic(str(directory), resident_shards=16)
    logged = h.m - h.base.m
    check(logged > 0, "9g: the store holds no logs")
    launches, state, delta = 0, None, None
    for solve in ("cold", "warm"):
        if solve == "warm":
            delta = h.apply_batch(*post, symmetrize=True)
        got = {}
        for sub in ("cuda", "torch"):
            gk.reset_launches()
            with ops.substrate_scope(sub):
                # each side starts from its own copy of the cuda run's state
                got[sub] = pagerank.pr_incremental(
                    h, delta, None if state is None else type(state)(
                        *(t.clone() for t in state)), tol=1e-6, max_iters=DYN_SUB_ITERS)
            torch.cuda.synchronize()
            n_relax = gk.launch_counts()["edge_relax"]
            check((n_relax > 0) == (sub == "cuda"),
                  f"9g {solve} pr_incremental [{sub}]: {n_relax} edge_relax launches")
            launches += n_relax
        (rc, sc, pc), (rt, st, _) = got["cuda"], got["torch"]
        compare_runs(torch, f"9g {solve} pr_incremental cuda/torch", (rc, None, 0, 0),
                     (rt, None, 0, 0), PR_TOL)
        check(sc.rounds == st.rounds == DYN_SUB_ITERS,
              f"9g {solve} pr_incremental: rounds {sc.rounds} and {st.rounds}")
        check(bool(torch.isfinite(rc).all()), f"9g {solve} pr_incremental: non-finite")
        state = pc
    print(f"9g pr_incremental on the logged store, cold and warm, cuda against torch "
          f"({DYN_SUB_ITERS} rounds a solve, {logged} log edges before the last "
          f"batch): within PR_TOL; edge_relax launches {launches}", flush=True)


def dynamic_phase(torch, np, gk, ops, store, pagerank, dynamic_bench, gsym, source,
                  directory):
    """9g: dynamic graphs at full width through ``benchmarks/dynamic.py``:
    phase 3's symmetrized graph saved at 16 shards and opened with
    ``open_dynamic``; DYN_BATCHES seeded batches of DYN_BATCH_EDGES edges
    between existing vertices (symmetrized); after each, incremental bfs
    and cc against the from-scratch runs, bitwise; pr_incremental's det-add
    replay allclose to scratch and bitwise across DYN_POOLS; compaction,
    the save_dynamic / open_dynamic round trip and one batch after
    compaction.  Every flag of the suite's rows must be 1.  Then
    ``dynamic_substrates`` on the store.  Returns the suite's kernel
    launches."""
    rng = np.random.default_rng(18)
    n = gsym.n
    batches = [(rng.integers(0, n, DYN_BATCH_EDGES), rng.integers(0, n, DYN_BATCH_EDGES))
               for _ in range(DYN_BATCHES + 1)]
    print(f"9g: {DYN_BATCHES} batches of {DYN_BATCH_EDGES} edges (+1 after compaction), "
          f"symmetrized, on phase 3's symmetrized web graph (m={gsym.m}) at 16 shards, "
          f"pools {DYN_POOLS} (the stream's; the pagerank replays'), every handle "
          f"checking each shard's CRC as it streams; against the JAX suite: its "
          f"rmat(10, 12) and batches of 64 scaled up, its pools (4, 8) changed, the "
          f"pagerank replays cut to the first {DYN_PR_BATCHES} batch(es) and the "
          f"cross-pool pair to {DYN_DET_ITERS} rounds a solve, its batch count and "
          f"pagerank's tol 1e-6 and max_iters 300 kept", flush=True)
    gk.reset_launches()
    t0 = time.perf_counter()
    shutil.rmtree(directory, ignore_errors=True)
    try:
        rows = dynamic_bench.run(base=gsym, batches=batches[:-1], post=batches[-1],
                                 pools=DYN_POOLS, source=source, store=directory,
                                 pr_batches=DYN_PR_BATCHES, det_iters=DYN_DET_ITERS,
                                 log=lambda line: print("  9g " + line, flush=True))
        for name, us, derived, stats in rows:
            print(f"  9g {name} us={us} {derived} {json.dumps(stats)}", flush=True)
        flags = {"dynamic/stream_incremental": ("bitwise_equal",),
                 "dynamic/pr_incremental": ("allclose", "det_bitwise"),
                 "dynamic/compact": ("bitwise_after_compact", "roundtrip_equal")}
        by = {r[0]: r[3] for r in rows}
        for name, keys in flags.items():
            for key in keys:
                check(by[name][key] == 1, f"9g {name}: {key} is not 1")
        launches = gk.launch_counts()
        print(f"9g suite: {time.perf_counter() - t0} s; launches (cuda): "
              f"{json.dumps(launches)}", flush=True)
        check(launches["edge_relax"] > 0, "9g: edge_relax was not launched")
        t1 = time.perf_counter()
        dynamic_substrates(torch, gk, ops, store, pagerank, directory, batches[-1])
        print(f"9g substrate check: {time.perf_counter() - t1} s", flush=True)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    return launches


# ---- phases 10-12: flash attention, spmm_bsr, embedding_bag, the layer and --
# ---- the kernels_bench entry point -------------------------------------------

DEV = "cuda"

# (name, heads, S, d_head, window): the attention layers of the repo's
# configs at B = 1 (configs/h2o_danube3_4b.py, configs/stablelm_3b.py), bf16,
# causal; BH = heads (GQA's K/V already expanded, as the layer does)
FLASH_CASES = (("h2o-danube-3-4b S=8192", 32, 8192, 120, 4096),
               ("stablelm-3b S=4096", 32, 4096, 80, None))
FLASH_LONG = ("h2o-danube-3-4b S=32768 (prefill_32k)", 32, 32768, 120, 4096)
# (name, bh, S, d, window, causal): an odd width (d % 8 != 0: element-wise
# tile loads) with a window, and a bidirectional head, both with a ragged S
FLASH_SMALL = (("odd width, window, ragged S", 4, 200, 36, 48, True),
               ("bidirectional, ragged S", 2, 300, 64, None, False))
FLASH_ROUTE = "tensor cores: mma.sync m16n8k16 bf16, f32 accumulators, p as bf16 hi + lo"
FLASH_SAMPLED_ROWS = 256
# bf16 flash attention against its plain versions: both keep f32 scores and
# sums (the kernel carries p as bf16 hi + lo, to about 2^-17) and round the
# output once, so they differ by the final rounding: rtol 8e-3 (2^-7, one
# bf16 ulp at worst) plus an atol of 1e-3 x rms(want) (the H100 read at
# most 3.6e-5 x rms; p rounded once to bf16 would exceed it)
FLASH_RTOL, FLASH_ATOL_RMS = 8e-3, 1e-3
# the layer's flash branch against its plain branch, which rounds the
# probabilities and the head outputs to bf16 (about 2^-9 of a row's scale
# each): rtol 8e-3 plus 5e-2 x the rms of that query row (the H100 read
# 2.76e-2 at danube's full width)
LAYER_RTOL, LAYER_ATOL_RMS = 8e-3, 5e-2
F32_TOL = 2e-5         # the reference's f32 tolerance (tests/test_kernels.py TOL)
SPMM_TOL = 2e-5 * 10   # the reference's f32 SpMM tolerance against its oracle
SPMM_COO_TOL = 2e-5 * 20
SPMM_BF16_TOL = 2e-2 * 10   # the CPU tests' bf16 SpMM tolerance, for bf16 outputs
# Under bf16 out the reference rounds each slot's product and the running
# sum to bf16.  The kernel's f32 products differ from the plain version's
# (cuBLAS) in the last bits, so a rounding can land one bf16 ulp apart, and
# that ulp of a large running sum survives where later slots cancel it
# (at full size with f32 blocks and bf16 x, a few outputs of a small value
# in rows whose sums pass 64).  A bf16 output may therefore also
# differ by one bf16 ulp of the largest sum its row could reach (the sum
# of its slots' |A| |X| products); the rows print how many needed it.
H100_TF32_TC_OPS_PER_S = 495e12  # TF32 on the tensor cores, dense
# (blocks dtype, x dtype) of the SpMM cases beside f32 x f32, and the
# tensor-core products the kernel runs for each: one bf16 pass, or a TF32
# split whose bf16 operand has no low half
SPMM_DTYPES = (("bfloat16", "bfloat16", 1, H100_BF16_TC_OPS_PER_S),
               ("float32", "bfloat16", 2, H100_TF32_TC_OPS_PER_S),
               ("bfloat16", "float32", 2, H100_TF32_TC_OPS_PER_S))
SPMM_ROUTE = ("tensor cores: mma.sync m16n8k8 TF32 split hi/lo (three products f32 x f32, "
              "two mixed), m16n8k16 bf16 x bf16; f32 accumulators; a cp.async ring of 64-deep "
              "chunks, 3 stages f32 x f32, 4 mixed, 6 bf16 x bf16")
EB_ORACLE_TOL = 2e-5 * 5
# MIND (configs/mind.py): item table 2^23 x 64 f32, hist_len 50; batches
MIND_ITEMS, MIND_DIM, MIND_HIST = 1 << 23, 64, 50
MIND_BATCHES = (("serve_bulk", 262_144), ("serve_p99", 512))
# h2o-danube-3-4b's attention (configs/h2o_danube3_4b.py FULL)
DANUBE = dict(d_model=3840, n_heads=32, n_kv_heads=8, d_head=120,
              rope_theta=1e4, sliding_window=4096)
LAYER_S = 8192


def attention_pairs(s, window, causal=True):
    """Unmasked (query, key) pairs of one head: sum of min(q+1, window) when
    causal, else of the keys past q - window."""
    if not causal:
        return s * s if window is None else sum(s - max(0, q - window + 1) for q in range(s))
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def within(torch, got, want, rtol, atol_rms, dim=None):
    """(ok, max |got - want|, reading): |got - want| <= rtol |want| +
    atol_rms x rms(want), the rms over all of want (``dim=None``) or over
    ``dim``.  The reading is the atol each element needs, in units of that
    rms: max((|got - want| - rtol |want|) / rms)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    rms = (want.square().mean() if dim is None
           else want.square().mean(dim, keepdim=True)).sqrt().clamp_min(1e-30)
    need = float(((err - rtol * want.abs()) / rms).max())
    ok = bool(torch.isfinite(got).all()) and need <= atol_rms
    return ok, float(err.max()), need


def flash_case(torch, fk, fref, name, bh, s, d, window, gen, sampled=False, causal=True):
    """The kernel against the plain oracle (all rows, or sampled rows at a
    length whose S x S scores do not fit), timed beside the plain version
    and scaled_dot_product_attention."""
    import torch.nn.functional as F
    q, k, v = (torch.randn((bh, s, d), generator=gen, device=DEV).to(torch.bfloat16)
               for _ in range(3))
    kw = dict(causal=causal, window=window)

    def kernel():
        return fk.flash_attention_bhsd(q, k, v, **kw)

    before = fk.flash_attention_bhsd.launches, fk.flash_attention_bhsd.tc_launches
    got = kernel()
    torch.cuda.synchronize()
    check((fk.flash_attention_bhsd.launches, fk.flash_attention_bhsd.tc_launches) ==
          (before[0] + 1, before[1] + 1), f"flash {name}: no tensor-core launch counted")
    limit = f"rtol {FLASH_RTOL} + {FLASH_ATOL_RMS} x rms(want)"
    if sampled:
        rows = torch.randperm(s, generator=gen, device=DEV)[:FLASH_SAMPLED_ROWS - 2]
        rows = torch.cat([rows, torch.tensor([0, s - 1], device=DEV)]).sort().values
        wants = {"attention_ref": fref.attention_ref(q, k, v, rows=rows, **kw)}
        got_rows = got[:, rows]
    else:
        wants = {"plain": fref.flash_attention_plain(q, k, v, **kw),
                 "attention_ref": fref.attention_ref(q, k, v, **kw)}
        got_rows = got
    check(got.dtype == torch.bfloat16 and got.shape == q.shape, f"flash {name}: dtype/shape")
    row = dict(case=name)
    for against, want in wants.items():
        ok, err, need = within(torch, got_rows, want, FLASH_RTOL, FLASH_ATOL_RMS)
        rms = float(want.float().square().mean().sqrt())
        check(ok, f"flash {name}: outside {limit} of {against} (max err {err}, atol "
                  f"needed {need} x rms, rms {rms})")
        row[f"max_abs_err_{against}"] = err
        row[f"atol_needed_rms_{against}"] = need
        row[f"rms_{against}"] = rms
    row["max_abs_err"] = max(row[f"max_abs_err_{a}"] for a in wants)
    row["compare"] = (f"{' and '.join(wants)}, {'sampled rows' if sampled else 'all rows'}"
                      f", bf16, {limit}")
    del wants, want, got_rows
    torch.cuda.empty_cache()
    q4, k4, v4 = (t.view(1, bh, s, d) for t in (q, k, v))
    if window is None:
        library = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)  # noqa: E731
    else:
        qi = torch.arange(s, device=DEV)[:, None]
        ki = torch.arange(s, device=DEV)[None, :]
        mask = (ki > qi - window) & ((ki <= qi) if causal else True)
        library = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)  # noqa: E731
    row["ms"] = cuda_ms(torch, kernel)
    if sampled:
        row["plain_ms"] = None    # the plain versions' time is taken at S = 8192
    else:
        row["plain_ms"] = cuda_ms(torch, lambda: fref.flash_attention_plain(q, k, v, **kw))
        row["oracle_ms"] = cuda_ms(torch, lambda: fref.attention_ref(q, k, v, **kw))
        torch.cuda.empty_cache()
    row["library_ms"] = cuda_ms(torch, library)
    pairs = attention_pairs(s, window, causal) * bh
    nbytes = 4 * bh * s * d * 2                  # q, k, v read, out written, bf16
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 4 * d * pairs, H100_BF16_TC_OPS_PER_S)
    row.update(pairs=pairs, flops=4 * d * pairs, tflops=4 * d * pairs / row["ms"] / 1e9,
               tc_flops=6 * d * pairs, route=FLASH_ROUTE,
               bound_rate="bf16 tensor cores 989 TFLOP/s")
    return row


def sass_hmma(build, stem):
    """{kernel: count of HMMA (tensor-core) instructions} in the SASS of
    ``stem``'s library, or None where the toolkit has no ``cuobjdump``."""
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    if not cuobjdump.exists():
        return None
    hmma, name = {}, None
    for line in sh([str(cuobjdump), "-sass", str(build.build_all()[stem])]).splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            hmma[name] = 0
        elif name and "HMMA" in line:
            hmma[name] += 1
    return hmma


def tc_kernel_report(build):
    """The tensor-core kernels' instantiations — the bf16 flash kernel's
    eight and spmm_kernel's four — registers, spills and static shared
    memory from ``-Xptxas -v`` (beside the dynamic bytes of a flash
    launch), and, where the toolkit has ``cuobjdump``, the ``HMMA``
    instructions in each one's SASS.  Fails on a spill or on no HMMA."""
    lib = build.load("flash_attention")
    for stem, frag, count in (("flash_attention", "flash_tc_kernel", 8),
                              ("spmm_bsr", "spmm_kernel", 4)):
        info = {name: v for name, v in build.ptxas_info(stem).items() if frag in name}
        check(len(info) == count, f"{frag}: {len(info)} instantiations in the ptxas log")
        hmma = sass_hmma(build, stem)
        for name, v in sorted(info.items()):
            if frag == "flash_tc_kernel":
                nk = int(name.split("flash_tc_kernelILi", 1)[1].split("E", 1)[0])
                label = f"flash_tc_kernel<DP={16 * nk}>"
                dyn = f" dynamic smem {lib.flash_attention_tc_smem_bytes(16 * nk)} B"
            else:
                label, dyn = f"spmm_kernel {name}", ""
            n_hmma = None if hmma is None else hmma.get(name, 0)
            print(f"  {label}: registers {v.get('registers')} spill stores "
                  f"{v.get('spill_stores')} loads {v.get('spill_loads')} stack "
                  f"{v.get('stack')} static smem {v.get('smem')} B{dyn}; HMMA in SASS "
                  f"{'no cuobjdump' if n_hmma is None else n_hmma}", flush=True)
            check(v.get("spill_stores") == 0 and v.get("spill_loads") == 0,
                  f"{label} spills: {v}")
            check(n_hmma is None or n_hmma > 0, f"{label}: no HMMA in SASS")


def spmm_case(torch, np, gen_mod, sk, sref, gen):
    """``web_crawl_like(16, 13, 16, 3)`` as block-ELL (the port's to_bsr),
    F = 128: f32 against the plain version and the edge list, then bf16 x
    bf16 and both mixed dtypes against the plain version.  Returns the
    rows, f32 first."""
    t0 = time.perf_counter()
    src, dst, n = gen_mod.web_crawl_like(16, 13, 16, 3, seed=0)
    w = gen_mod.random_weights(len(src), seed=1)
    idx_np, blocks_np = sk.to_bsr(src, dst, w, n)
    t_host = time.perf_counter() - t0
    idx = torch.from_numpy(idx_np).to(DEV)
    blocks = torch.from_numpy(blocks_np).to(DEV)
    del blocks_np
    R, K, bm, bk = blocks.shape
    f = 128
    x = torch.randn((idx.shape[0] * bk, f), generator=gen, device=DEV)

    def kernel():
        return sk.spmm_bsr(idx, blocks, x)

    before = sk.spmm_bsr.launches
    got = kernel()
    torch.cuda.synchronize()
    check(sk.spmm_bsr.launches == before + 1, "spmm_bsr: no launch counted")
    want = sref.spmm_bsr_plain(idx, blocks, x)
    err = (got - want).abs()
    check(bool((err <= SPMM_TOL + SPMM_TOL * want.abs()).all()),
          f"spmm_bsr: kernel and plain version outside {SPMM_TOL} (max err {float(err.max())})")
    src_t, dst_t = torch.from_numpy(src).to(DEV), torch.from_numpy(dst).to(DEV)
    coo = sref.spmm_coo_ref(src_t, dst_t, torch.from_numpy(w).to(DEV), n, x)
    coo_err = (got[:n] - coo).abs()
    check(bool((coo_err <= SPMM_COO_TOL + SPMM_COO_TOL * coo.abs()).all()),
          f"spmm_bsr: outside {SPMM_COO_TOL} of the edge list (max err {float(coo_err.max())})")
    nnzb = int((idx >= 0).sum())
    flops = nnzb * 2 * bm * bk * f
    row = dict(case=f"web_crawl_like(16, 13, 16, 3) F={f} f32", n=n, edges=len(src),
               nnz_blocks=nnzb, K=K, to_bsr_host_s=t_host, max_abs_err=float(err.max()),
               max_abs_err_edge_list=float(coo_err.max()),
               compare=f"plain version atol = rtol = {SPMM_TOL}; edge list {SPMM_COO_TOL}")
    del want, err, coo, coo_err, src_t, dst_t
    valid = idx >= 0
    counts = valid.sum(1)
    crow = torch.zeros(R + 1, dtype=torch.int64, device=DEV)
    crow[1:] = torch.cumsum(counts, 0)
    row["ms"] = cuda_ms(torch, kernel)
    row["plain_ms"] = cuda_ms(torch, lambda: sref.spmm_bsr_plain(idx, blocks, x))
    with warnings.catch_warnings():   # PyTorch's BSR support warns that it is beta
        warnings.simplefilter("ignore")
        bsr = torch.sparse_bsr_tensor(crow, idx[valid].long(), blocks[valid],
                                      size=(R * bm, x.shape[0]))
        row["library_ms"] = cuda_ms(torch, lambda: bsr @ x)
        lib_err = float((bsr @ x - got).abs().max())
    del bsr

    def nbytes(a_size, x_size):
        return idx.numel() * 4 + nnzb * bm * bk * a_size + x.numel() * x_size + R * bm * f * x_size

    # the split's three TF32 products on the tensor cores; the f32 CUDA-core
    # bound of the first design beside it
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes(4, 4), 3 * flops, H100_TF32_TC_OPS_PER_S)
    row.update(flops=flops, tc_flops=3 * flops, route=SPMM_ROUTE,
               bound_rate="TF32 tensor cores 495 TFLOP/s, three products",
               bound_f32_cuda_cores_ms=bound_ms(nbytes(4, 4), flops)[0],
               library_max_abs_diff=lib_err)
    rows = [row]
    for a_name, x_name, passes, rate in SPMM_DTYPES:
        a_t = blocks.to(getattr(torch, a_name))
        x_t = x.to(getattr(torch, x_name))
        before = sk.spmm_bsr.launches
        got = sk.spmm_bsr(idx, a_t, x_t)
        torch.cuda.synchronize()
        check(sk.spmm_bsr.launches == before + 1, f"spmm_bsr {a_name} x {x_name}: no launch")
        want = sref.spmm_bsr_plain(idx, a_t, x_t)
        err = (got.float() - want.float()).abs()
        bf16_out = x_t.dtype == torch.bfloat16   # out takes x's dtype
        tol = SPMM_BF16_TOL if bf16_out else SPMM_TOL
        limit = tol + tol * want.float().abs()
        past = int((err > limit).sum())
        if bf16_out:   # one bf16 ulp of the row's largest sum
            reach = sref.spmm_bsr_plain(idx, a_t.abs(), x_t.float().abs())
            limit = limit + torch.exp2(torch.floor(torch.log2(reach.clamp_min(1e-30))) - 7)
            del reach
        check(got.dtype == want.dtype and bool(torch.isfinite(got).all()) and bool(
            (err <= limit).all()),
            f"spmm_bsr {a_name} x {x_name}: outside {tol}" + (
                " (+ one bf16 ulp of the row's largest sum)" if bf16_out else "") +
            f" of the plain version (max err {float(err.max())})")
        r = dict(case=f"web_crawl_like(16, 13, 16, 3) F={f} blocks {a_name} x {x_name}",
                 max_abs_err=float(err.max()), compare=f"plain version atol = rtol = "
                 f"{tol}" + (" + one bf16 ulp of the row's largest sum" if bf16_out else ""),
                 outputs_past_atol_rtol=past, tc_flops=passes * flops)
        del limit
        r["ms"] = cuda_ms(torch, lambda: sk.spmm_bsr(idx, a_t, x_t))
        r["plain_ms"] = cuda_ms(torch, lambda: sref.spmm_bsr_plain(idx, a_t, x_t))
        r["library_ms"] = None
        r["bound_ms"], r["bound_by"] = bound_ms(nbytes(a_t.element_size(), x_t.element_size()),
                                                passes * flops, rate)
        rows.append(r)
        del a_t, x_t, got, want, err
    return rows


def embedding_bag_cases(torch, ek, eops, eref, gen):
    """MIND's item table under its serve_bulk and serve_p99 batches: history
    lengths uniform in 1..50, the tail -1, unweighted; sum and mean, each
    bitwise equal to the plain version."""
    import torch.nn.functional as F
    table = torch.randn((MIND_ITEMS, MIND_DIM), generator=gen, device=DEV)
    rows = []
    for batch, b in MIND_BATCHES:
        lengths = torch.randint(1, MIND_HIST + 1, (b, 1), generator=gen, device=DEV)
        ids = torch.randint(0, MIND_ITEMS, (b, MIND_HIST), generator=gen, device=DEV,
                            dtype=torch.int32)
        ids = torch.where(torch.arange(MIND_HIST, device=DEV)[None] < lengths, ids, -1)
        ones = torch.ones((b, MIND_HIST), device=DEV)
        max_err = 0.0
        for mode in ("sum", "mean"):
            before = ek.embedding_bag.launches
            got = eops.embedding_bag(ids, table, mode=mode)
            torch.cuda.synchronize()
            check(ek.embedding_bag.launches == before + 1, f"embedding_bag {batch}: no launch")
            plain = eref.embedding_bag_plain(ids, ones, table)
            if mode == "mean":
                plain = plain / torch.where(ids >= 0, ones, 0.0).sum(1, keepdim=True).clamp_min(1e-9)
            check(torch.equal(got.view(torch.int32), plain.view(torch.int32)),
                  f"embedding_bag {batch} {mode}: kernel and plain version differ bitwise")
            if mode == "sum":
                oracle = eref.embedding_bag_ref(ids, ones, table)
                err = (got - oracle).abs()
                check(bool((err <= EB_ORACLE_TOL + EB_ORACLE_TOL * oracle.abs()).all()),
                      f"embedding_bag {batch}: outside {EB_ORACLE_TOL} of the oracle")
                max_err = float(err.max())
        valid = int((ids >= 0).sum())
        w0 = torch.where(ids >= 0, ones, 0.0)
        ids0 = ids.clamp_min(0)
        row = dict(case=f"MIND {batch}: {b} x {MIND_HIST}, table {MIND_ITEMS} x {MIND_DIM} f32",
                   rows_gathered=valid, max_abs_err=0.0, max_abs_err_oracle=max_err,
                   compare="bitwise (sum and mean); oracle atol = rtol = "
                           f"{EB_ORACLE_TOL}")
        row["ms"] = cuda_ms(torch, lambda: ek.embedding_bag(ids, ones, table))
        row["plain_ms"] = cuda_ms(torch, lambda: eref.embedding_bag_plain(ids, ones, table))
        row["library_ms"] = cuda_ms(torch, lambda: F.embedding_bag(
            ids0, table, per_sample_weights=w0, mode="sum"))
        nbytes = b * MIND_HIST * 8 + valid * MIND_DIM * 4 + b * MIND_DIM * 4
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 2 * valid * MIND_DIM)
        rows.append(row)
    return rows


def layer_check(torch, kern, L):
    """layers.attention at h2o-danube-3-4b's full width, B = 1, S = 8192,
    bf16: the flash branch (counts set to 0 just before, read just after)
    against the plain softmax branch.  Each branch runs twice; the wall
    times of both calls are printed (the first pays one-time set-up)."""
    cfg = L.AttnConfig(**DANUBE)
    gen = torch.Generator(device=DEV).manual_seed(21)
    p = L.attn_init(gen, cfg, torch.bfloat16, device=DEV)
    x = torch.randn((1, LAYER_S, cfg.d_model), generator=gen, device=DEV).to(torch.bfloat16)
    pos = torch.arange(LAYER_S, device=DEV)

    def twice(use_pallas):
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = L.attention(p, cfg, x, pos, use_pallas=use_pallas)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return out, walls

    kern.reset_launches()
    a, wall = twice(True)
    launches = kern.launch_counts()
    tc_launches = kern.KERNELS["flash_attention"].tc_launches
    check(launches["flash_attention"] > 0, "layer: flash_attention was not launched")
    check(tc_launches == launches["flash_attention"],
          f"layer: {tc_launches} of {launches['flash_attention']} flash launches on the "
          f"tensor cores")
    check(a.shape == x.shape and a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all()),
          "layer: flash branch output shape/dtype/finite")
    b, wall_plain = twice(False)
    check(kern.launch_counts() == launches, "layer: the plain branch launched a kernel")
    ok, err, need = within(torch, a, b, LAYER_RTOL, LAYER_ATOL_RMS, dim=-1)
    row_rms = b.float().square().mean(-1).sqrt()
    check(ok, f"layer: flash and plain branches differ (max err {err}, atol needed "
              f"{need} x the row's rms, limit rtol {LAYER_RTOL} + {LAYER_ATOL_RMS} x rms)")
    print(f"layer: h2o-danube-3-4b attention d_model={cfg.d_model} S={LAYER_S} bf16: "
          f"flash wall_ms={wall} plain wall_ms={wall_plain} (first, second call) "
          f"max_abs_err={err} atol_needed={need} x row rms (limit rtol {LAYER_RTOL} + "
          f"{LAYER_ATOL_RMS} x row rms); row rms min/median/max "
          f"{float(row_rms.min())}/{float(row_rms.median())}/{float(row_rms.max())} "
          f"launches {json.dumps(launches)} (flash on the tensor cores: {tc_launches})",
          flush=True)
    return launches


def bench_kernels_check(torch, np, kernels_bench, fk, fref, sk, sref, ek, eref):
    """Each kernel on kernels_bench's own inputs (f32 flash at d = 64, f32
    SpMM at n = 512, the f32 bag at D = 128) against its plain version: f32
    within the reference's 2e-5, the bag bitwise; the bag also on that
    table in bf16 and widened to D = 256 in both dtypes, which with MIND's
    D = 64 runs each of its vector widths.  These launches are not the
    entry point's."""
    (q, k, v), (idx, blocks, x), (ids, ws, table) = kernels_bench.kernel_inputs(
        DEV, np.random.default_rng(0))
    out = {}
    for name, got, want in (
            ("flash_attention", fk.flash_attention_bhsd(q, k, v),
             fref.flash_attention_plain(q, k, v)),
            ("spmm_bsr", sk.spmm_bsr(idx, blocks, x), sref.spmm_bsr_plain(idx, blocks, x))):
        err = (got - want).abs()
        check(got.dtype == want.dtype and bool(torch.isfinite(got).all()) and bool(
            (err <= F32_TOL + F32_TOL * want.abs()).all()),
            f"kernels_bench inputs: {name} outside {F32_TOL} of its plain version "
            f"(max err {float(err.max())})")
        out[name] = float(err.max())
    wide = torch.cat([table, -table], 1)      # D = 256: other vector widths
    for tab in (table, table.to(torch.bfloat16), wide, wide.to(torch.bfloat16)):
        got, want = ek.embedding_bag(ids, ws, tab), eref.embedding_bag_plain(ids, ws, tab)
        check(got.dtype == tab.dtype and torch.equal(got, want),
              f"kernels_bench inputs: embedding_bag {tab.dtype} differs from its plain version")
    out["embedding_bag"] = 0.0
    print(f"kernels_bench inputs, kernel against plain version (max abs err): "
          f"{json.dumps(out)}", flush=True)
    return out


def bench_check(torch, kern, kernels_bench):
    """The port's kernels_bench entry point on the card (counts set to 0
    just before, read just after)."""
    kern.reset_launches()
    t0 = time.perf_counter()
    rows = kernels_bench.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = kern.launch_counts()
    for r in rows:
        print(f"  {r[0]},{r[1]},{r[2]}", flush=True)
    check(tuple(r[0] for r in rows) == KERNELS_BENCH_ROWS,
          f"kernels_bench rows {[r[0] for r in rows]} are not the JAX suite's")
    derived = dict(kv.split("=", 1) for kv in rows[-1][2].split(";"))
    check(rows[-1][0] == "kern/graph_bfs_e2e[cuda]" and derived["substrate"] == "cuda",
          f"kernels_bench: the cuda BFS row says {rows[-1][2]}")
    for name, count in launches.items():
        check(count > 0, f"kernels_bench: kernel {name} was not launched")
    print(f"kernels_bench: {len(rows)} rows in {secs} s, launches {json.dumps(launches)}",
          flush=True)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--communities", type=int, default=512,
                    help="web_crawl_like communities (the depth; default 512)")
    ap.add_argument("--kron-scale", type=int, default=20,
                    help="log2 vertices of the low-diameter kron input (default 20)")
    ap.add_argument("--resume-child", metavar="JSON", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.resume_child:
        return resume_child(json.loads(args.resume_child))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: src/repro_torch not found beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    import repro_torch as tc
    from repro_torch.core import frontier as fr
    from repro_torch.core import operators as ops
    from repro_torch.core.algorithms import bc, bfs, cc, kcore, pagerank, sssp
    from repro_torch.core.algorithms import tc as tri
    from repro_torch.graphs import generators as gen_mod
    from repro_torch import kernels as kern
    from repro_torch import checkpoint as store
    from repro_torch.benchmarks import algo_classes, frameworks, granularity, kernels_bench
    from repro_torch.benchmarks import dynamic as dynamic_bench
    from repro_torch.benchmarks import memtier
    from repro_torch.core import engine as eng
    from repro_torch.core import tiered
    from repro_torch.kernels import device_loop as dl
    from repro_torch.kernels import build
    from repro_torch.kernels import graph_ops as gk
    from repro_torch.kernels.embedding_bag import embedding_bag as ek
    from repro_torch.kernels.embedding_bag import ops as eops
    from repro_torch.kernels.embedding_bag import ref as eref
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.spmm_bsr import ref as sref
    from repro_torch.kernels.spmm_bsr import spmm_bsr as sk
    from repro_torch.models import layers
    algos = (bfs, sssp, cc, pagerank)
    suite = (kcore, bc, tri)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. environment
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = card.splitlines()[0]
    print(card, flush=True)
    nvcc = sh([build.nvcc_path(), "--version"]).splitlines()[-1]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} nvcc: {nvcc} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    # 2. build: every kernel library, one nvcc each, all at once
    t0 = time.perf_counter()
    libs = build.build_all()
    for stem in libs:
        build.load(stem)
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0} s (nvcc "
          f"{build.build_seconds} s) into {build.BUILD_DIR}", flush=True)
    tc_kernel_report(build)

    # 3. the graph, built on the host and copied to the card once
    t0 = time.perf_counter()
    src, dst, n = gen_mod.web_crawl_like(args.communities, 13, 16, 3, seed=0)
    w = gen_mod.random_weights(len(src), seed=1)
    t_gen = time.perf_counter() - t0
    g = tc.from_coo(src, dst, n, w, build_csc=True)
    t_g = time.perf_counter() - t0 - t_gen
    gsym = tc.from_coo(src, dst, n, symmetrize=True, build_csc=True)
    torch.cuda.synchronize()
    t_host = time.perf_counter() - t0
    source = int(np.argmax(np.bincount(src, minlength=n)))
    del src, dst, w
    check(g.device.type == "cuda", "from_coo did not place the graph on the card")
    print(f"graph: n={g.n} m={g.m} n_pad={g.n_pad} m_pad={g.m_pad} sym m={gsym.m} "
          f"source={source} host build {t_host} s (generate {t_gen}, "
          f"csr+csc {t_g}, symmetrized {t_host - t_gen - t_g})", flush=True)

    # 4. kernels against their plain versions
    rng = torch.Generator(device="cuda").manual_seed(11)
    relax_rows = []
    for name, kw in edge_relax_cases(torch, g, gsym, gk, fr, rng):
        row = run_edge_relax_case(torch, gk, name, kw)
        relax_rows.append(row)
        print("  edge_relax " + json.dumps(row), flush=True)
    adv_rows = []
    for name, mask, cap, budget in advance_cases(torch, g, fr, rng):
        row = run_advance_case(torch, gk, fr, g, name, mask, cap, budget)
        adv_rows.append(row)
        print("  advance " + json.dumps(row), flush=True)
    torch.cuda.empty_cache()

    # 5. small input against the CPU (also warms every code path up)
    small_check(torch, np, tc, algos, gen_mod)
    print("small: card == cpu on the quickstart graph", flush=True)

    # 6. the main path: counts set to 0 just before, read just after
    main_runs = main_path_runs(algos, g, gsym, source)
    gk.reset_launches()
    dl.do_while.launches = 0
    cuda_runs = run_path(torch, main_runs, "cuda", ops)
    launches = gk.launch_counts()
    loop_launches = dl.do_while.launches
    print(f"main path launches: {json.dumps(launches)}, device loops {loop_launches}",
          flush=True)
    for k in ("edge_relax", "advance"):
        check(launches[k] > 0, f"kernel {k} was not launched on the main path")
    check(loop_launches > 0, "the device loop was not launched on the main path")
    torch_runs = run_path(torch, main_runs, "torch", ops)
    check(gk.launch_counts() == launches, "the torch substrate launched a kernel")
    for name, run in main_runs.items():
        compare_runs(torch, name, cuda_runs[name], torch_runs[name], run.tol)
    dist = cuda_runs["bfs_dd_sparse"][0]
    rank = cuda_runs["pr_push"][0]
    check(float(dist[source]) == 0.0 and int((dist < 1e30).sum()) > 1, "bfs reached nothing")
    check(all(bool(torch.isfinite(cuda_runs[k][0]).all()) for k in ("pr_push", "pr_pull")),
          "non-finite ranks")
    check(abs(float(rank.double().sum()) - 1.0) < 1e-3, "pagerank does not sum to 1")
    print("main path: cuda == torch (labels bitwise, pagerank allclose, RunStats equal)",
          flush=True)
    # 6b. the main path once more on the "cuda" substrate, its device time by kernel
    with ops.substrate_scope("cuda"):
        print_profile(torch, gk, "main path", main_runs,
                      sum(run[2] for run in cuda_runs.values()))

    # 7. the suite's kernels: int32 add at the symmetrized graph's shapes,
    # then the kron input and intersect on both graphs' oriented lists
    for name, kw in int_add_cases(torch, gsym, rng):
        row = run_edge_relax_case(torch, gk, name, kw)
        relax_rows.append(row)
        print("  edge_relax " + json.dumps(row), flush=True)
    t0 = time.perf_counter()
    ksrc, kdst, kn = gen_mod.table3_suite(args.kron_scale - 10)["kron30"]()
    t_gen = time.perf_counter() - t0
    kweights = gen_mod.random_weights(len(ksrc), seed=7)
    kg = tc.from_coo(ksrc, kdst, kn, kweights, build_csc=True)
    kg_unw = tc.from_coo(ksrc, kdst, kn, build_csc=True)
    kgsym = tc.from_coo(ksrc, kdst, kn, symmetrize=True, build_csc=True)
    torch.cuda.synchronize()
    del ksrc, kdst, kweights
    ksource = int(np.argmax(np.bincount(kg.src_idx[: kg.m].cpu().numpy(), minlength=kn)))
    print(f"kron: scale={args.kron_scale} n={kg.n} m={kg.m} sym m={kgsym.m} "
          f"source={ksource} host build {time.perf_counter() - t0} s "
          f"(generate {t_gen})", flush=True)
    t0 = time.perf_counter()
    inter_rows = []
    for label, og in (("web", gsym), ("kron", kgsym)):
        oriented = oriented_chunks(torch, tri, og)
        print(f"  oriented {label}: ne={oriented[5]} dmax={oriented[0].shape[1]} "
              f"chunks={oriented[1].shape[0] // INTERSECT_CHUNK}", flush=True)
        for case in intersect_cases(torch, label, og, *oriented):
            row = run_intersect_case(torch, gk, *case)
            inter_rows.append(row)
            print("  intersect " + json.dumps(row), flush=True)
        row = intersect_whole_list(torch, gk, label, *oriented[:4], og.sentinel)
        print("  intersect " + json.dumps(row), flush=True)
        del case, oriented  # they hold an oriented adjacency on the card
        torch.cuda.empty_cache()
    print(f"intersect cases: {time.perf_counter() - t0} s (two oriented "
          f"adjacencies built on the host)", flush=True)

    # 8. the paper suite's new algorithms on the web graph
    small_suite_check(torch, np, tc, suite, gen_mod)
    print("small: card == cpu for kcore, bc and tc on the quickstart graph", flush=True)
    web_launches, web_cuda, web_torch = run_suite_both(
        torch, gk, ops, "web suite", web_suite_runs(suite, g, gsym, source),
        ("edge_relax", "advance", "intersect"))
    bc_hazard(torch, ops, bc, g, source, {"cuda": web_cuda, "torch": web_torch})
    # the runs 9e's suite rows are held against
    refs = {"web": {k: cuda_runs[k][:2] for k in main_runs},
            "kron": {}}
    refs["web"].update({k: web_cuda[k][:2] for k in
                        ("kcore_peel(k=3)", "bc_brandes", "tc_count")})
    alive64 = web_cuda["kcore_dd_sparse(k=64)"][0]
    check(bool(alive64.any()) and torch.equal(
        alive64, web_cuda["core_numbers(k_max=64)"][0] >= 64),
        "kcore(64) disagrees with core_numbers")
    check(web_cuda["tc_count"][0] > 0, "no triangles on the web graph")
    print(f"web suite: cuda == torch; kcore(64) keeps {int(alive64.sum())} of {gsym.n}",
          flush=True)
    # 8b. kcore's sparse rounds and peel loops, and tc's intersections,
    # their device time by kernel
    suite_runs = {k: v for k, v in web_suite_runs(suite, g, gsym, source).items()
                  if k in ("kcore_dd_sparse(k=64)", "core_numbers(k_max=64)", "tc_count")}
    with ops.substrate_scope("cuda"):
        print_profile(torch, gk, "kcore and tc", suite_runs,
                      sum(web_cuda[k][2] for k in suite_runs))
    del web_cuda, web_torch

    # 9. the seven paper benchmarks on the low-diameter kron input
    kron_launches, kron_cuda, kron_torch = run_suite_both(
        torch, gk, ops, "kron suite",
        kron_suite_runs(algos, suite, kg, kg_unw, kgsym, ksource),
        ("edge_relax", "advance", "intersect"))
    bc_hazard(torch, ops, bc, kg, ksource, {"cuda": kron_cuda, "torch": kron_torch})
    # phase 9's bfs runs on the unweighted kron graph, the suites' on kg
    refs["kron"] = {k: v[:2] for k, v in kron_cuda.items() if k != "bfs_dd_sparse"}
    check(kron_cuda["tc_count"][0] > 0, "no triangles on kron")
    check(bool(torch.isfinite(kron_cuda["pr_push"][0]).all()), "kron: non-finite ranks")
    print("kron suite: cuda == torch (labels bitwise, pagerank and bc allclose, "
          "RunStats equal but for pagerank's round slack)", flush=True)
    del kron_cuda, kron_torch
    torch.cuda.empty_cache()

    # 9a-9d. one fetch per stretch, det add, out of core, the memory tiers
    t0 = time.perf_counter()
    loop_rows = fetch_phase(torch, np, tc, gen_mod, eng, fr, dl, bfs, sssp, g, source)
    print(f"9a: {time.perf_counter() - t0} s", flush=True)
    t0 = time.perf_counter()
    det_phase(torch, np, tc, gen_mod, ops, pagerank, bc, g, gsym, source)
    print(f"9b: {time.perf_counter() - t0} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    directory = ROOT / "build" / f"chip_store_{os.getpid()}"
    try:
        shard_rows, ooc_relax, far, far_ref = ooc_phase(
            torch, gk, ops, eng, tiered, store, bfs, sssp, cc, pagerank, g, gsym, source,
            rng, directory)
        relax_rows += shard_rows
        print(f"9c: {time.perf_counter() - t0} s, peak device bytes "
              f"{torch.cuda.max_memory_allocated()}", flush=True)
        memtier_phase(memtier)

        # 9e-9g. the figure suites, resume, dynamic graphs
        t0 = time.perf_counter()
        suite_launches = suites_phase(torch, np, gk, gen_mod,
                                      (granularity, frameworks, algo_classes),
                                      (g, gsym, source), (kg, kgsym, ksource), refs)
        print(f"9e: {time.perf_counter() - t0} s", flush=True)
        t0 = time.perf_counter()
        resume_launches = resume_phase(torch, np, gk, ops, store, bfs, pagerank, directory,
                                       far, far_ref, g, source,
                                       *cuda_runs["bfs_dd_sparse"][:1],
                                       cuda_runs["bfs_dd_sparse"][1].rounds)
        print(f"9f: {time.perf_counter() - t0} s", flush=True)
        t0 = time.perf_counter()
        dyn_launches = dynamic_phase(torch, np, gk, ops, store, pagerank, dynamic_bench,
                                     gsym, source,
                                     directory.parent / f"{directory.name}_dynamic")
        print(f"9g: {time.perf_counter() - t0} s", flush=True)
    finally:
        for d in (directory, directory.parent / f"{directory.name}_dynamic",
                  directory.parent / f"{directory.name}_ckpt"):
            shutil.rmtree(d, ignore_errors=True)
    del refs
    del (g, gsym, kg, kg_unw, kgsym, main_runs, cuda_runs, torch_runs, kw, mask)
    torch.cuda.empty_cache()

    # 10. flash attention, spmm_bsr and embedding_bag at full width, each
    # against its plain version on the card
    t0 = time.perf_counter()
    flash_rows = [flash_case(torch, fk, fref, *case, rng) for case in FLASH_CASES]
    flash_rows.append(flash_case(torch, fk, fref, *FLASH_LONG, rng, sampled=True))
    for *case, causal in FLASH_SMALL:
        flash_rows.append(flash_case(torch, fk, fref, *case, rng, causal=causal))
    for row in flash_rows:
        print("  flash_attention " + json.dumps(row), flush=True)
    torch.cuda.empty_cache()
    spmm_rows = spmm_case(torch, np, gen_mod, sk, sref, rng)
    for row in spmm_rows:
        print("  spmm_bsr " + json.dumps(row), flush=True)
    torch.cuda.empty_cache()
    eb_rows = embedding_bag_cases(torch, ek, eops, eref, rng)
    for row in eb_rows:
        print("  embedding_bag " + json.dumps(row), flush=True)
    torch.cuda.empty_cache()
    print(f"new kernels: {time.perf_counter() - t0} s", flush=True)

    # 11. the attention layer, flash branch against the plain branch
    layer_launches = layer_check(torch, kern, layers)
    torch.cuda.empty_cache()

    # 12. the kernels_bench entry point: its kernels on its inputs, then the run
    bench_errs = bench_kernels_check(torch, np, kernels_bench, fk, fref, sk, sref, ek, eref)
    bench_launches = bench_check(torch, kern, kernels_bench)

    # every path's cuda launches: the three graph paths count graph_ops only
    total = {k: sum(path.get(k, 0) for path in (launches, web_launches, kron_launches,
                                                suite_launches, resume_launches,
                                                dyn_launches, layer_launches,
                                                bench_launches))
             for k in bench_launches}
    total["edge_relax"] += ooc_relax
    src_file = "src/repro_torch/kernels/graph_ops/csrc/graph_ops.cu"
    main_relax, main_adv, main_inter = relax_rows[0], adv_rows[1], inter_rows[0]
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def entry(name, source, replaces, max_err, row):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=total[name], max_abs_err=max_err,
                    **{key: row[key] for key in timed})

    kernels = [
        entry("edge_relax", src_file, "src/repro/kernels/graph_ops/graph_ops.py:65",
              max(r["max_abs_err"] for r in relax_rows), main_relax),
        entry("advance", src_file, "src/repro/kernels/graph_ops/graph_ops.py:162", 0.0,
              main_adv),
        entry("intersect", src_file, "src/repro/kernels/graph_ops/graph_ops.py:117",
              max(r["max_abs_err"] for r in inter_rows), main_inter),
        entry("flash_attention",
              "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention/flash_attention.py:29",
              max([r["max_abs_err"] for r in flash_rows] + [bench_errs["flash_attention"]]),
              flash_rows[0]),
        entry("spmm_bsr", "src/repro_torch/kernels/spmm_bsr/csrc/spmm_bsr.cu",
              "src/repro/kernels/spmm_bsr/spmm_bsr.py:29",
              max([r["max_abs_err"] for r in spmm_rows] + [bench_errs["spmm_bsr"]]),
              spmm_rows[0]),
        entry("embedding_bag",
              "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu",
              "src/repro/kernels/embedding_bag/embedding_bag.py:25",
              max(r["max_abs_err"] for r in eb_rows), eb_rows[0]),
    ]
    # no TPU kernel: the graph that replaces the reference's stretch
    # while_loop; its graph launches on the main path (phase 6)
    print(json.dumps({"device_loop": dict(
        source="src/repro_torch/kernels/device_loop/csrc/device_loop.cu",
        replaces="src/repro/core/engine.py:425 (lax.while_loop of _sparse_stretch)",
        launches=loop_launches, **loop_rows[0])}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
