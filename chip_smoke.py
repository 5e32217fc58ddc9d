#!/usr/bin/env python3
"""Drive the torch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                  # the full-size run
    python3 chip_smoke.py --communities 8  # a short build-and-check run

Phases, in order; any mismatch or exception ends the script with a
non-zero exit before its last line:

1. environment: the card's name and power limit, torch, CUDA and nvcc;
2. build: every kernel library (``src/repro_torch/kernels/*/csrc/*.cu``:
   graph_ops, flash_attention, spmm_bsr, embedding_bag, device_loop,
   crc32), one ``nvcc`` each,
   all at once, into the git-ignored ``build/repro_torch``; then, for each
   instantiation of the three tensor-core kernels (the bf16 and f32
   flash-attention kernels ``flash_tc_kernel`` and ``flash_f32_kernel``,
   and ``spmm_kernel``), its registers, spills
   and shared memory from ``-Xptxas -v`` (no spills allowed) and, where
   the toolkit has ``cuobjdump``, the count of ``HMMA`` (tensor-core)
   instructions in its SASS (none is a failure);
3. graph: ``web_crawl_like(512, 13, 16, 3)`` with random weights (about
   4.19 M vertices and 57 M edges), generated on the host and built by
   ``from_coo`` on the card as CSR+CSC and symmetrized (CSR+CSC, for cc
   and pagerank), each stage's seconds and the symmetrized build's peak
   device memory printed; at full size n, m, n_pad, m_pad and the
   symmetrized m must be those the numpy build gave (kron's likewise in
   phase 7); 3b:
   ``from_coo`` and ``oriented_adjacency`` on the card against the same
   calls on the CPU, every array bitwise, on the quickstart graph,
   ``web_crawl_like(64, 13, 16, 3)`` (plain, symmetrized, CSR+CSC) and a
   duplicate-heavy graph weighted with +-0.0, NaNs and infinities;
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
   times the pool); the crc32 kernel that checks every streamed copy
   (``kernels/crc32``) against the CRC each cut recorded for all 64 CSR
   and CSC shards, against ``crc32_ref`` on the card at odd lengths from
   an unaligned start, on 16 seeded single-bit flips of the largest shard
   (each seen), and timed on that shard against its byte bound, its
   pinned H2D copy and the host's zlib; edge_relax on the shards as the streamed path gives
   them (push over a middle and the partial last CSR shard, pull over a
   CSC shard, the reversed push), bitwise; then bfs_dd_sparse (fused,
   per-round, and fused under "torch"), sssp_dd_sparse and bfs_dirop
   (CSC streamed) on the weighted graph, from the vertex whose reach
   crosses the most shards (a reversed max and min push of each vertex's
   shard to a fixed point; the hub's reach stays in one shard), each
   streaming more shards than the pool holds, and cc_dd_sparse, pr_push
   (``OOC_PR_ITERS`` = 20 rounds; cc_dd_sparse ``OOC_CC_ROUNDS`` = 15) and pr_pull on the
   symmetrized one, every run from an empty pool:
   labels bitwise equal to
   the resident runs, ranks within PR_TOL, ``h2d_bytes == shards_streamed
   x shard_bytes``, edges_touched equal for bfs_dirop and pr_pull; pr_push
   under deterministic add at pools of 2 and 16 and eager, bitwise; each
   run prints its wall, H2D GB/s, io_wait_us, buffer hits, the device's
   kernel and copy busy shares (a second, profiled call) and its time per
   edge touched against the resident run's, and its crc32 launches must
   equal its misses (no miss unchecked, none checked on the host); a
   fault drill on the web cut: a bitflip at the first read heals (one
   checksum failure, one retry, labels bitwise), a persistent torn shard
   0 raises ShardCorruptError after three failed checks; then the weighted graph
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
   scratch (atol scaled to the mean rank 1/n) at a pool of 16 and, each
   solve to convergence, bitwise across pools of 16 and 4 (every
   handle checking its CRCs as shards stream), compaction, the v3 round
   trip and one batch after compaction: every flag of the suite's rows 1;
   then, on the store the suite leaves (base and six logs), a cold and a
   warm pr_incremental under plain float add on both substrates, within
   PR_TOL (the cuda side's edge_relax over the log shards against the
   plain push);
9h. multi-source traversal and the graph query server (``core/multisource``,
   ``launch/graph_serve``, ``benchmarks/serving.py``): ``edge_relax_lanes``
   against its plain version (``batched_push_ref`` / ``batched_relax_ref``)
   at B = 8 on the web graph — push (a dense round) and batch (a union
   advance) for f32 min weighted, f32 add unweighted and int32 min, the
   batch case at B = 40 (two launches), and +inf seeds in two lanes; and
   the in-place route as the two-buffer rounds call it
   (a batch reseeded at its union, B = 8 and 40, a push reseeded in
   full), each changed mask bitwise to ``batched_updated_mask`` — bitwise
   but f32 add, each with its ms, bound, plain ms, one
   ``scatter_reduce_`` over the flattened (B·n_pad) index (library_ms) and
   B launches of ``edge_relax`` on the same rows; then, counts set to 0
   just before and read just after, the serving suite on the web graph
   from phase 3's source and seven seeded vertices with out-edges (8
   per-source bfs and sssp runs, ``ms_bfs`` / ``ms_sssp`` with every lane
   bitwise to its source's run and lane 0 to phase 6's bfs, the server's
   16 ragged requests on 8 slots after a warm pass, each bitwise to its
   source's run; qps, p50, p99 and both edges_per_source printed),
   ``ms_ppr`` (lanes within PR_TOL of ``ppr_push``) and ``ms_bfs`` on kron
   (bitwise to per-source runs); the three web runs again under "torch",
   labels and RunStats equal (ppr: allclose, rounds within one); and
   ``ms_ppr`` at 4 lanes under det add on phase 5's quickstart graph,
   bitwise to ``ppr_push``; the ``profile serving`` lines (device time
   by kernel of the three batched web runs, the seed passes summed);
9i. the multi-device path on a virtual mesh of positions on the card
   (``core/{mesh,placement,partition,sharded}.py``): the web graphs
   sharded at ndev 8 (blocked OEC) and on a (2, 4) CVC grid, each build
   timed and its shards held to the graph (edge multiset, (src, dst)
   order, row_ptr and deg); ``edge_relax``'s gate (1: the ungated launch,
   0: ``out_init``, both bitwise; the gate-0 launch timed against its
   seed copy); bfs_dd_sparse (fused and per round), sssp_dd_sparse,
   cc_dd_sparse, kcore_dd_sparse(k=3), and det-add bc_brandes and pr_push
   (``MESH_PR_ITERS`` rounds) at ndev 8 under "cuda" (counts set to 0 just
   before, read just after) and "torch": labels bitwise to the unsharded
   runs, RunStats equal but ``substrate``, ``comm_elems`` its closed form,
   each wall beside the unsharded wall; bsp_bfs (against sssp_dd_sparse)
   and bsp_cc (cc's components) at ndev 8 with their rounds; bfs and cc
   on the grid under the "cvc" and "full" reducers, bitwise, with the
   full/cvc ``comm_elems`` ratio; tc_count on kron at ndev 4 (phase 9's
   count); ms_bfs at B = 8 on the web graph at ndev 4 (9h's lanes,
   ``comm_elems`` its closed form);
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
   on the cuda substrate, all six kernels launched;
13. the LM server (``launch/serve.py`` over ``models/transformer.py``'s
   ``make_decode``; no hand-written kernel on its path, as the
   reference's runs no Pallas kernel: the launch counts must not move):
   13a the h2o-danube3 and deepseek-moe SMOKE configs, f32, served on the
   card and on the CPU with the same weights (6 ragged requests on 4 and
   2 slots), tokens equal and decode logits within 1e-4 of the row's
   largest; 13b h2o-danube-3-4b FULL (24 layers, bf16) as
   ``Server(max_batch=4, max_seq=512)`` on 6 seeded requests (prompts of
   16-256 tokens, 16 new each), the first 2 requests' tokens equal to
   their greedy decodes served alone at the same shapes (one decode step run
   twice on the served cache shows whether the card's GEMMs repeat
   bitwise; if not, logits within 2e-2 of the row's largest up to a near
   tie), with the decode tick at B = 4 against its byte bound, prefill ms
   per prompt token, generated tokens/s; 13c one request at danube's
   width, depth cut to 2 layers, of a 4,080-token prompt and 48 new
   tokens (positions past the 4,096 window): its tokens equal to the
   argmax of ``forward`` over prompt + output wherever forward's top-2
   gap exceeds 2 x 2e-2 of the row's largest, its last decode logits
   within 2e-2 of forward's row; 13d deepseek-moe-16b at full width, 2
   of its 28 layers, f32, 2 requests (8-token prompts, 4 new): the
   card's tokens equal the CPU server's, the first tick's top-6 experts
   printed on both sides; ``max_memory_allocated`` and the phase's
   seconds; one JSON line ``{"lm_server": {...}}`` before the kernels
   line;
14. the LM trainer (``launch/train.py``'s ``Trainer`` over
   ``transformer.make_train_step``, AdamW and the token pipeline; no
   hand-written kernel on its path, as the reference's training runs no
   Pallas kernel: the launch counts must not move): 14a ``tiny_model``,
   the h2o-danube3 and deepseek-moe SMOKE configs and
   ``tests/test_train_loop.py``'s MoE config, f32, each trained 6 steps
   (4 x 32 tokens) on the card and on the CPU from the same weights:
   every step's loss within 1e-5 relative, the final parameters within
   rtol 1e-5 plus 2·lr a step; the last also with compressed gradients,
   and crashed at step 3 and resumed on the card (final loss within 1e-5
   of the uninterrupted run's; whether bitwise is printed); 14b one
   ``make_train_step`` step at h2o-danube-3-4b's full width, depth cut to
   2 layers, f32, 1 x 128 tokens, card against CPU from the same weights
   and AdamW state: the loss within 1e-5 relative, the gradients' global
   norm within 1e-4, the parameters within rtol 1e-5 plus 2·lr, and the
   CPU side's wall; 14c h2o-danube-3-4b FULL (24 layers, bf16, remat)
   trained 5 steps of 1 x 4,096 tokens (the reference's train_4k
   sequence, the batch cut from 256) at the reference's lr_peak: finite
   losses, step walls (median after the first) against 6·N·tokens over
   989 TFLOP/s (N without the embedding's rows), tokens/s,
   ``max_memory_allocated``, the bf16 weights that changed, step 0 run
   twice from the initial state (whether it repeats bitwise: digests of
   the parameters and moments), step 1 timed in two parts (the loss and
   its gradient, then AdamW) and step 2 under ``torch.profiler`` (its ten
   largest device ops, and the device time of each family: GEMM, softmax,
   copy, reduce, index, other elementwise); one JSON line
   ``{"lm_train": {...}}`` before the kernels line;
15. the GNN trainer (``configs/gnn_common.py``'s ``make_train_step`` and
   ``build_gnn_step`` over ``models/gnn``, the sampler and
   ``GraphBatchPipeline``; no hand-written kernel on its path, as the
   reference's GNNs run no Pallas kernel: the launch counts must not
   move): 15a the four SMOKE configs through ``gnn_smoke`` on the card,
   then 5 steps on its molecule batch, card against CPU from the same
   weights: every loss within 1e-5 relative, the gradients' global norm
   within 1e-4, the final parameters within rtol 1e-5 plus 2·lr a step;
   15b each architecture at its BASE width (MACE mul 128, l_max 2,
   correlation 3) on the molecule shape at full size (128 graphs x 30
   nodes x 64 edges, d_feat 16) through ``build_gnn_step(..., "molecule")``,
   3 steps, card against CPU with 15a's limits, step ms and
   ``max_memory_allocated``; 15c gcn-cora on minibatch_lg at full scale:
   a seeded synthetic CSR built in numpy (n 232,965, m 114,615,892,
   lognormal degrees with hubs and degree-0 vertices, uniform
   destinations), (n, 602) features, 41 classes, seeds from
   ``GraphBatchPipeline(n, 1024)``, fanouts (15, 10), 5 steps through the
   sampled step on the card and on the CPU (which holds the same CSR):
   every step's blocks bitwise, losses within 1e-5, sampling and step ms,
   the batch's nodes and edges, peak memory; 15d gcn-cora on ogb_products
   full-batch at full scale (N, M padded with ``_ru``, padding masked), the
   card alone: 5 steps, finite losses, step ms against the step's byte
   bound, ``max_memory_allocated``, step 2 under ``torch.profiler`` (its ten
   largest device ops); one JSON line ``{"gnn_train": {...}}`` before the
   kernels line;
16. MIND and the dry run (``models/recsys/mind.py``, ``configs/mind.py``,
   ``launch/dryrun.py``; no hand-written kernel on the path, as the
   reference's MIND gathers its table with a plain ``embed[ids]``: the
   launch counts must not move): 16a ``mind_smoke`` on the card, then
   ``SMOKE`` from weights carried from a CPU init, 5 AdamW steps card
   against CPU (losses within 1e-5 relative, gradient norms within 1e-4,
   parameters within rtol 1e-5 plus 2·lr a step), then ``serve_scores``
   and ``retrieval`` of the card's trained weights on both (scores within
   1e-5 of the row's largest |score|; top-k positions equal, or the two
   scores within that of each other: such places are printed) on a slate
   with repeated candidates; 16b ``FULL`` on the card (2^23 x 64 f32 table):
   ``serve_p99`` (512 x 50, slate 8,192) card against CPU in full,
   ``serve_bulk`` (262,144, slate 8,192) on the card with 1,024 seeded
   rows re-scored on the CPU, ``retrieval_cand`` (1 x 1,000,000 padded to
   1,000,448, top 100: the registry cell's step) card against CPU, each
   with its median ms of 5 after a warm-up, the warm-up's peak memory and
   its bound (this run's distinct table rows, ids and output over 3.35
   TB/s against its matrix products' FLOPs, counted on meta tensors, over
   67 TFLOP/s); 16c the train step card against CPU for 3 steps at B =
   4,096 from the full-width table, then 5 steps at ``MIND_TRAIN_BATCH``
   = 32,768 (``train_batch``'s 65,536 halved: its step runs out of memory):
   median step ms after the first, peak memory and the bound (parameters
   and AdamW state read and written once against the step's FLOPs); 16d
   ``launch/dryrun.run_cell`` for mind's four cells and h2o-danube-3-4b x
   train_4k, then the meta account of the step 14c times (danube FULL, 1 x
   4,096 tokens, remat): its FLOPs beside 6·N·tokens and 14c's measured
   step ms; one JSON line ``{"mind": {...}}`` before the kernels line;
17. the examples and the harness as a user runs them (``repro_torch.examples``,
   ``repro_torch.benchmarks.run``), each with the counts set to 0 just
   before and read just after: 17a ``quickstart.main()`` (``edge_relax``
   and ``advance`` launch; its results against its ``--device cpu`` run
   within phase 5's limits, its printed lines equal but where pagerank's
   top vertex parts at a tie within PR_TOL); 17b ``paper_suite.main(
   ["--scale", "small"])``: all 21 oracle checks pass, read from
   ``run_input``'s return, and ``intersect`` launches; 17c
   ``serve_lm.main()``, then its weights and requests served on the CPU:
   each request's tokens equal, or parting only where the CPU's top two
   logits lie within 1e-4 of the row's largest (the least gap printed);
   17d ``train_lm.main(["--steps", "20"])`` at ``model_100m``'s full width
   (8 layers, d 512, 8-expert top-2 MoE, vocab 32,000; 16 x 256 tokens),
   checkpoints in a temporary directory: finite losses, the last below
   the first, step ms, tokens/s and peak memory (17c and 17d launch no
   kernel); 17e the harness on the ``serving`` suite on the card, its JSON
   read back by ``benchmarks/ci_gate.py serve`` in process under ci.yml's
   bounds; 17f the f32 flash route (``flash_f32_kernel``, split TF32 on
   the tensor cores) against its plain version within 2e-5 (atol + rtol)
   at (a) ``kernels_bench``'s inputs (bh 2, S 256, d 64, causal: split-KV,
   merged in a cluster), (b) train_lm's ``model_100m`` attention (bh 128,
   S 256, d 64), (c) h2o-danube-3-4b's heads at ``train_4k``'s length (bh
   32, S 4096, d 120, window 4096), each with its ms, plain ms, f32
   ``scaled_dot_product_attention`` ms and bounds (bytes, split TF32,
   CUDA cores), and at FLASH_SMALL's two shapes and d = 30 in f32,
   checked only; each call must raise ``launches`` and ``tc_launches``
   (not counted: a comparison); one JSON line ``{"examples": {...}}``
   before the kernels line.

Agreement: labels, alive masks, core numbers and triangle counts bitwise;
pagerank rtol 1e-4 / atol 1e-10; bc rtol 1e-3 / atol 1e-4 (its sigma and
delta sums are float atomicAdds in an order that changes from run to run;
the tolerance is the suite's own oracle check, and the largest error seen
is printed beside it); RunStats equal except ``substrate`` and, in phase
9, pagerank's round count, which may differ by one round: its
residual-threshold exit reads float sums taken in another order (seen on
kron: 143 rounds under "cuda", 142 under "torch").  Its rounds are all
dense then, each charging m, and that is checked on both sides.

The crc32 kernel (no TPU kernel: the check of each streamed copy that
replaces the reference's host zlib on every miss) has a line of its own,
``{"shard_crc32": {...}}``: its launches (the misses of 9c's runs, of 9f
in this process and of 9g), its time on the largest shard (``ms``), the
plain version's, its byte bound, the shard's H2D copy and the host's zlib
on the same bytes; ``library_ms`` is null, as no PyTorch call computes a
CRC-32.  The device loop (no TPU kernel: the graph that replaces the reference's
stretch ``while_loop``) has a line of its own before the kernels line,
``{"device_loop": {...}}``: its graph launches on the main path, and 2,000
rounds of the path's stretch timed through the graph (``ms``) and through
the plain Python loop (``plain_ms``), with the largest difference of their
labels (``max_abs_err``).  A kernel's ``launches`` sum its cuda launches
on every path (phases 6, 8, 9, 9c, 9e-9i, 11, 12, 17; in 9f those of this
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
runs); edge_relax_lanes the same per slot (w for each slot some lane
sends from), the frontier and its three (B, n_pad) lane arrays once (in
place: out only at the (lane, dst) pairs a message reaches and the
reseeded columns, and one byte per changed entry), and counts one
operation per message; advance reads the live entries' f_idx,
degree and row_ptr.  A bf16 flash row also prints
``tflops`` (those 4 d operations per unmasked pair over the kernel's
time), ``tc_flops`` (the 6 d per pair the kernel runs: p @ v twice, for
p's bf16 hi and lo halves) and ``route``.

It prints the kernels line (one JSON object) and, last, the device line.
It exits non-zero without a result when no CUDA device is present or when
the repository's sources are not beside it.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
import warnings
import zlib
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


def distinct_sources(torch, idx, n_pad):
    """How many distinct vertices ``idx`` names: the src_val elements a
    relax must gather once for those slots."""
    seen = torch.zeros(n_pad, dtype=torch.bool, device=idx.device)
    seen[idx] = True
    return int(seen.sum())


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
    # neutral), w for the active ones, src_val at the distinct sources of
    # the active slots — and out_init read and out written once
    m, n_pad = src.shape[0], args[5].shape[0]
    s = args[5].element_size()
    n_act = int(keep.sum())
    n_gathered = distinct_sources(torch, src[keep], n_pad)
    clamp = bool(beyond_neutral(torch, args[5], kind).any())
    n_send = m if clamp else n_act
    nbytes = ((4 * m if vm else 4 * n_act) + (n_pad if vm else m) + 4 * n_send
              + (4 * n_act if use_w else 0) + s * n_gathered + 2 * n_pad * s)
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
PROFILE_FAMILIES = (("edge_relax_lanes", "edge_relax_lanes"),
                    ("lanes_prep", "edge_relax_lanes"),
                    ("lanes_seed", "edge_relax_lanes"),    # a tree from before the prep pass
                    ("edge_relax", "edge_relax"), ("relax_seed", "edge_relax"),
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
    names = ("edge_relax", "edge_relax_lanes", "edge_relax_lanes_", "advance_frontier",
             "intersect_count")
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
    return rows


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


# ---- phase 3: the graph built on the card ----------------------------------

# The sizes the numpy build gave the full inputs (512 communities, kron
# scale 20), which the build on the card must reproduce: (n, m, n_pad,
# m_pad, symmetrized m)
FULL_WEB_SIZES = (4_194_304, 56_702_470, 4_194_816, 56_702_976, 104_472_702)
FULL_KRON_SIZES = (1_048_576, 16_085_580, None, None, 31_404_412)


def check_sizes(label, g, gsym, want):
    got = (g.n, g.m, g.n_pad, g.m_pad, gsym.m)
    check(all(w is None or a == w for a, w in zip(got, want)),
          f"{label}: built sizes {got} differ from {want}")


def build_pair(torch, tc, label, src, dst, n, w, t_gen):
    """``from_coo`` on the card: the weighted CSR+CSC, then the symmetrized
    unweighted CSR+CSC, each stage's seconds printed (the device
    synchronized at each stage's end) with the symmetrized build's peak
    device memory."""
    split, sym = {}, {}
    t0 = time.perf_counter()
    g = tc.from_coo(src, dst, n, w, build_csc=True, timings=split)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    gsym = tc.from_coo(src, dst, n, symmetrize=True, build_csc=True, timings=sym)
    peak = torch.cuda.max_memory_allocated() - held
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    print(f"{label} build on the card: {t_build} s after generate {t_gen} s: "
          f"copy {split['copy']}, dedup {split['dedup']}, CSR {split['csr']}, "
          f"CSC {split['csc']}; symmetrized {sum(sym.values())} "
          f"({json.dumps(sym)}), its peak device bytes {peak} above the "
          f"{held} held", flush=True)
    return g, gsym


def signed_zero_nan_coo(np, n=512, m=1 << 20, seed=3):
    """Duplicate-heavy COO whose weights are +-0.0, NaNs of three bit
    patterns, +-inf and a few finite values: the dedup's weight order at a
    size where the card's sort runs its radix path."""
    rng = np.random.default_rng(seed)
    pool = np.array([0x80000000, 0x00000000, 0x7FC00000, 0x7FC00001, 0xFFC00000,
                     0x7F800000, 0xFF800000, 0x3F800000, 0x40000000],
                    np.uint32).view(np.float32)
    return (rng.integers(0, n, m), rng.integers(0, n, m), n,
            pool[rng.integers(0, pool.size, m)])


def build_check(torch, np, tc, gen_mod):
    """``from_coo`` and ``oriented_adjacency`` on the card against the same
    calls on the CPU (which the CPU tests hold bitwise against the JAX
    package's numpy build): every array bitwise equal."""
    t0 = time.perf_counter()
    from repro_torch.core.algorithms import tc as tri
    from repro_torch.core.graph import _ARRAYS
    quick = gen_mod.web_crawl_like(16, 5, 8, 2, seed=0)
    quick_w = gen_mod.random_weights(len(quick[0]), seed=1)
    web64 = gen_mod.web_crawl_like(64, 13, 16, 3, seed=0)
    web64_w = gen_mod.random_weights(len(web64[0]), seed=1)
    special = signed_zero_nan_coo(np)
    cases = [
        ("quickstart csr+csc", quick[:2], quick_w, dict(build_csc=True)),
        ("quickstart symmetrized", quick[:2], None, dict(symmetrize=True)),
        ("quickstart no dedup", quick[:2], quick_w, dict(dedup=False, build_csc=True)),
        ("web(64) plain", web64[:2], web64_w, {}),
        ("web(64) symmetrized", web64[:2], None, dict(symmetrize=True)),
        ("web(64) csr+csc", web64[:2], web64_w, dict(build_csc=True)),
        ("+-0.0/NaN csr+csc", special[:2], special[3], dict(build_csc=True)),
        ("+-0.0/NaN symmetrized", special[:2], special[3], dict(symmetrize=True)),
    ]
    ns = {"quickstart": quick[2], "web(64)": web64[2], "+-0.0/NaN": special[2]}
    for name, (src, dst), w, opts in cases:
        n = ns[name.split()[0]]
        built = {dev: tc.from_coo(src, dst, n, w, device=dev, **opts)
                 for dev in ("cuda", "cpu")}
        a, b = built["cuda"], built["cpu"]
        check((a.n, a.m, a.n_pad, a.m_pad) == (b.n, b.m, b.n_pad, b.m_pad),
              f"build {name}: sizes differ card/cpu")
        for f in _ARRAYS:
            x, y = getattr(a, f), getattr(b, f)
            check((x is None) == (y is None), f"build {name}: {f} on one side only")
            if x is not None:
                check(x.dtype == y.dtype and torch.equal(bits(torch, x).cpu(),
                                                         bits(torch, y)),
                      f"build {name}: {f} differs card/cpu")
        if opts.get("symmetrize"):
            for f, x, y in zip(("adj", "osrc", "odst"), tri.oriented_adjacency(a),
                               tri.oriented_adjacency(b)):
                check(torch.equal(x.cpu(), y), f"oriented {name}: {f} differs card/cpu")
        print(f"  build {name}: n={a.n} m={a.m} m_pad={a.m_pad}, card == cpu bitwise",
              flush=True)
    print(f"3b: from_coo and oriented_adjacency, card == cpu bitwise on "
          f"{len(cases)} builds in {time.perf_counter() - t0} s", flush=True)


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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adj, osrc, odst = tri.oriented_adjacency(g)
    torch.cuda.synchronize()
    print(f"  oriented_adjacency: {time.perf_counter() - t0} s on the card", flush=True)
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
OOC_CC_ROUNDS = 15             # cc_dd_sparse's rounds out of core (depth cut from its
                               # 326 to keep the run in its time; both sides stop there)
OOC_PR_ITERS = 20              # pr_push's rounds out of core (depth cut from the JAX
                               # outofcore suite's 50: every round streams the graph)
# the crc32 kernel against crc32_ref on the card at tests/test_torch_crc32.py's
# odd lengths, each 3 bytes into its buffer (an unaligned start); and its
# seeded single-bit flips of the largest shard, every one to be seen
CRC_LENGTHS = (0, 1, 3, 4, 5, 95, 96, 97, 4095, 4096, 4097, (1 << 20) + 13)
CRC_FLIPS = 16
# (label, launches of the crc32 kernel) of each 9c run: the run's verified misses
CRC_VERIFIED = []


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
    # the stretch's carry: labels, frontier, ladder scalars, escalations
    state = (bfs._init_dist(g, source), mask, fr.round_scalars(g, mask),
             torch.zeros((), dtype=torch.int32, device=mask.device))
    _, cap_need, mass_med, _ = state[2].tolist()
    cap, budget, dense = e._pick(cap_need, mass_med)
    check(not dense, f"device loop {label}: the first round is not sparse")
    one_round = eng._sparse_round(
        g, step=bfs._sparse_step, capacity=cap, budget=budget,
        lo_cap=fr.ladder_below(cap, e.cap_ladder),
        lo_budget=fr.ladder_below(budget, e.budget_ladder), cutoff=e.sparse_cutoff)
    with dl.StretchGraphs() as graphs:
        before = dl.do_while.launches
        (lab, msk, sc, _), k = dl.do_while(one_round, state, limit, graphs=graphs, key=label)
        k = int(k)
        graphs.settle(k)
        check(dl.do_while.launches == before + 1, f"device loop {label}: no launch counted")
        (plab, pmsk, psc, _), pk = dl.do_while_plain(one_round, state, limit)
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


def ooc_run(torch, label, fn, tg, resident=None, busy=False, crc=None):
    """One streamed run from an empty pool (so the stream counters are the
    run's own): wall, stream counters, exact h2d accounting, with ``busy``
    the device's kernel and copy busy shares (a second, profiled call), and
    against a resident run ``(labels, stats, wall_ms)`` the time per edge
    touched.  With ``crc`` (the crc32 kernel's wrapper) its launches in the
    run must equal the run's checked copies: every miss, and every attempt
    whose CRC failed (``CRC_VERIFIED``)."""
    tg._pool.clear()
    torch.cuda.synchronize()
    crc0 = None if crc is None else crc.launches
    t0 = time.perf_counter()
    labels, st = fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    check(st.placement == "tiered" and st.h2d_bytes == st.shards_streamed * tg.shard_bytes,
          f"ooc {label}: h2d_bytes {st.h2d_bytes} != {st.shards_streamed} x {tg.shard_bytes}")
    if crc is not None:
        verified = crc.launches - crc0
        check(verified == st.shards_streamed + st.checksum_failures,
              f"ooc {label}: {verified} crc32 launches for {st.shards_streamed} misses and "
              f"{st.checksum_failures} failed checks")
        CRC_VERIFIED.append((label, verified))
    kern, copy = busy_shares(torch, fn) if busy else (None, None)
    line = dict(run=label, wall_ms=wall, rounds=st.rounds, edges_touched=st.edges_touched,
                h2d_bytes=st.h2d_bytes, shards_streamed=st.shards_streamed,
                buffer_hits=st.buffer_hits, io_wait_us=st.io_wait_us,
                h2d_gbps=st.h2d_bytes / (wall * 1e-3) / 1e9,
                kernel_busy_share=None if kern is None else kern / wall,
                copy_busy_share=None if copy is None else copy / wall,
                pull_rounds=st.pull_rounds,
                crc32_launches=None if crc is None else CRC_VERIFIED[-1][1])
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


def crc_checks(torch, np, crc_ops, crc_ref, cuts):
    """9c: the crc32 kernel (``kernels/crc32``) on the card: against the
    CRC each cut recorded for every CSR and CSC shard of ``cuts`` (no host
    CRC is taken), against ``crc32_ref`` on the card (and zlib) at
    CRC_LENGTHS from an unaligned start, and on CRC_FLIPS seeded
    single-bit flips of the largest shard, each of which it must see; then
    its time on that shard (CUDA events, 5 reps after a warm-up) against
    its byte bound, the plain version's, the shard's H2D copy from pinned
    memory and the host's zlib on the same bytes.  Launches here are
    comparisons.  Returns the fields of the ``shard_crc32`` line."""
    out = torch.empty((1,), dtype=torch.int32, device="cuda")
    checked, big = 0, None
    for label, tg in cuts:
        for direction, hosts, crcs in (("csr", tg._bufs, tg.shard_crcs),
                                       ("csc", tg._csc_bufs, tg.in_shard_crcs)):
            for sid, host in enumerate(hosts):
                dev = host.to("cuda")
                got = crc_ops.crc32(dev)
                check(got == crcs[sid], f"crc32 {label} {direction} shard {sid}: {got:#010x} "
                      f"!= recorded {crcs[sid]:#010x}")
                checked += 1
                if big is None or dev.numel() > big[1].numel():
                    big = (f"{label} {direction} shard {sid}", dev, host, crcs[sid])
    gen = torch.Generator(device="cuda").manual_seed(29)
    for n in CRC_LENGTHS:
        raw = torch.randint(0, 256, (n + 3,), generator=gen, device="cuda",
                            dtype=torch.int32).to(torch.uint8)
        t = raw[3:]
        got, want = crc_ops.crc32(t), crc_ref.crc32_ref(t)
        check(got == want == zlib.crc32(t.cpu().numpy()),
              f"crc32 at {n} bytes: kernel {got:#010x}, plain {want:#010x}")
    name, dev, host, want = big
    nbytes = dev.numel() * dev.element_size()
    flat = dev.view(torch.uint8)
    draw = np.random.default_rng(29)
    for i in range(CRC_FLIPS):
        pos, bit = int(draw.integers(0, nbytes)), 1 << int(draw.integers(0, 8))
        flat[pos] ^= bit
        got, plain = crc_ops.crc32(dev), crc_ref.crc32_ref(dev)
        flat[pos] ^= bit
        check(got != want and got == plain,
              f"crc32: flip {i} (byte {pos}, bit {bit}) of {name}: kernel {got:#010x}, plain "
              f"{plain:#010x}, recorded {want:#010x}")
    check(crc_ops.crc32(dev) == want, f"crc32: {name} not restored after the flips")
    ms = cuda_ms(torch, lambda: crc_ops.crc32_async(dev, out))
    plain_ms = cuda_ms(torch, lambda: crc_ref.crc32_ref(dev))
    h2d_ms = cuda_ms(torch, lambda: dev.copy_(host, non_blocking=True))
    bound, by = bound_ms(nbytes, 0)
    a = host.numpy()
    zlib.crc32(a)
    t0 = time.perf_counter()
    for _ in range(3):
        zlib.crc32(a)
    zlib_ms = (time.perf_counter() - t0) / 3 * 1e3
    row = dict(case=f"{name}, {nbytes} bytes", shards_checked=checked,
               lengths=len(CRC_LENGTHS), flips_seen=CRC_FLIPS, max_abs_err=0, ms=ms,
               plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
               gbps=nbytes / ms / 1e6, h2d_ms=h2d_ms, h2d_gbps=nbytes / h2d_ms / 1e6,
               host_zlib_ms=zlib_ms, host_zlib_gbps=nbytes / zlib_ms / 1e6)
    print("  crc32 " + json.dumps(row), flush=True)
    return row


def crc_drill(torch, ops, bfs, faultio, crc, tg, source, want):
    """9c: a fault drill at full size on the web graph's cut: a bitflip on
    the first read (``at=0, times=1``) heals with one checksum failure and
    one retry, the labels bitwise the resident run's and one more crc32
    launch than misses; a persistent torn read of shard 0 under a reversed
    push (which streams every shard from 0) raises ShardCorruptError after
    three failed checks."""
    tg._pool.clear()
    tg.set_fault_injector(faultio.FaultInjector([faultio.bitflip("shard_read", at=0, times=1)]))
    crc0 = crc.launches
    try:
        got, st = bfs.bfs_dd_sparse(tg, source)
        torch.cuda.synchronize()
    finally:
        tg.set_fault_injector(None)
    check(torch.equal(got, want) and st.checksum_failures == 1 and st.io_retries == 1
          and crc.launches - crc0 == st.shards_streamed + 1,
          f"crc drill bitflip: checksum_failures {st.checksum_failures}, io_retries "
          f"{st.io_retries}, {crc.launches - crc0} launches for {st.shards_streamed} misses, "
          f"labels equal {torch.equal(got, want)}")
    tg._pool.clear()
    tg.set_fault_injector(faultio.FaultInjector([faultio.torn("shard_read", key=0)]))
    fails0, raised = tg.io.checksum_failures, None
    vals = torch.ones(tg.n_pad, device="cuda")
    try:
        ops.push_dense(tg, vals, tg.valid_vertex_mask(), vals, reverse=True)
    except faultio.ShardCorruptError as err:
        raised = err
    finally:
        tg.set_fault_injector(None)
        tg._pool.clear()
    fails = tg.io.checksum_failures - fails0
    check(raised is not None and "csr shard 0" in str(raised) and fails == 3,
          f"crc drill torn: raised {raised!r}, checksum_failures {fails}")
    print(f"crc drill: a bitflip at the first read healed (checksum_failures 1, io_retries "
          f"1, labels bitwise, {st.shards_streamed} misses); a persistent torn shard 0 "
          f"raised ShardCorruptError after {fails} failed checks", flush=True)


def ooc_phase(torch, np, gk, ops, eng, tiered, store, bfs, sssp, cc, pagerank, crc_mods, g,
              gsym, hub, rng, directory):
    """9c: out of core on phase 3's graphs, each cut into 16 shards with a
    pool of 2 (the CSR 8 times the pool).  Labels bitwise equal to the
    resident runs, pagerank bitwise across pools and fused against eager
    under deterministic add and allclose to the resident run, h2d_bytes ==
    shards_streamed x shard_bytes exactly, edges_touched equal to the
    resident run's for bfs_dirop and pr_pull; then the web graph through
    the store.  The traversals of the web graph start at ``far_source``,
    whose reach crosses the most shards (the hub's stays in one), and each
    must stream more shards than the pool holds.  The store is saved
    under ``directory`` and kept for 9f.  ``crc_mods`` is (the crc32
    kernel's ops, its ref, faultio): the kernel is held to the cuts'
    recorded CRCs first (``crc_checks``), every streamed run's misses are
    its launches, and ``crc_drill`` runs after the runs.  Returns (edge_relax
    shard rows, edge_relax launches, the far source, its resident bfs
    labels, the ``shard_crc32`` fields)."""
    crc_ops, crc_ref, faultio = crc_mods
    crc = crc_ops.crc32_async
    CRC_VERIFIED.clear()
    t0 = time.perf_counter()
    tg = tiered.tier_graph(g, nshards=16, resident_shards=2, build_csc=True)
    tgs = tiered.tier_graph(gsym, nshards=16, resident_shards=2, build_csc=True)
    print(f"ooc: cut both graphs into 16 pinned host shards in {time.perf_counter() - t0} s; "
          f"web epd={tg.epd} shard_bytes={tg.shard_bytes} csr_bytes={tg.csr_bytes} "
          f"budget={tg.resident_budget}; sym shard_bytes={tgs.shard_bytes} "
          f"csr_bytes={tgs.csr_bytes}", flush=True)
    t0 = time.perf_counter()
    crc_row = crc_checks(torch, np, crc_ops, crc_ref, (("web", tg), ("sym", tgs)))
    print(f"crc32: {time.perf_counter() - t0} s", flush=True)
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
        labels, st, _ = ooc_run(torch, label, fn, tg if web else tgs, res[ref], busy, crc)
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
                                lambda: bfs.bfs_dd_sparse(tg, source), tg, res["bfs"], crc=crc)
    check(torch.equal(labels, res["bfs"][0]) and st.shards_streamed > tg.resident_shards,
          f"ooc bfs [torch]: labels differ, or {st.shards_streamed} shards streamed")
    check(gk.launch_counts() == launches, "ooc: the torch substrate launched a kernel")
    tgs16 = tiered.tier_graph(gsym, nshards=16, resident_shards=16)
    with ops.deterministic_add_scope(True):
        det = {}
        for label, t, fused in (("pool 2", tgs, True), ("pool 16", tgs16, True),
                                ("pool 2, eager", tgs, False)):
            det[label] = ooc_run(torch, f"pr_push det {label}",
                                 lambda: pr_push_streamed(torch, eng, pagerank, t, fused), t,
                                 crc=crc)[0]
    check(torch.equal(det["pool 2"], det["pool 16"]) and
          torch.equal(det["pool 2"], det["pool 2, eager"]),
          "ooc pr_push det: not bitwise across pools and regimes")
    check(torch.allclose(det["pool 2"], res["pr_push"][0], rtol=PR_TOL[0], atol=PR_TOL[1]),
          "ooc pr_push det: outside PR_TOL of the resident run")
    with ops.deterministic_add_scope(True):
        round_profile(torch, eng, pagerank, tgs, "pr_push det, pool 2")
    round_profile(torch, eng, pagerank, tgs, "pr_push, pool 2")
    del tgs, tgs16
    crc_drill(torch, ops, bfs, faultio, crc, tg, source, res["bfs"][0])
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
                            lambda: bfs.bfs_dd_sparse(opened, source), opened, res["bfs"],
                            crc=crc)
    check(torch.equal(labels, res["bfs"][0]) and st.shards_streamed > opened.resident_shards,
          f"store bfs: labels differ, or {st.shards_streamed} shards streamed")
    # every shard of both directions through the pinned staging ring
    vals = torch.rand(g.n_pad, generator=rng, device="cuda") * 100.0
    act = g.valid_vertex_mask()
    opened._pool.clear()   # every shard of both directions misses
    io0 = opened.io.snapshot()
    crc0 = crc.launches
    t0 = time.perf_counter()
    for name, got, want in (
            ("reversed push", ops.push_dense(opened, vals, act, vals, reverse=True),
             ops.push_dense(g, vals, act, vals, reverse=True)),
            ("pull", ops.pull_dense(opened, vals, act, vals), ops.pull_dense(g, vals, act, vals))):
        check(torch.equal(bits(torch, got), bits(torch, want)),
              f"store {name}: differs from the resident relax")
    staged_s = time.perf_counter() - t0
    streamed = opened.io.shards_streamed - io0[1]
    check(opened.io.h2d_bytes - io0[0] == streamed * opened.shard_bytes
          and streamed == 2 * opened.nshards and crc.launches - crc0 == streamed,
          f"store relaxes: {streamed} shards streamed, {crc.launches - crc0} crc32 launches")
    CRC_VERIFIED.append(("store relaxes", streamed))
    print(f"store: saved in {t_save} s, opened with verify='open' in {t_open} s, "
          f"bfs equal; a reversed push and a pull over every shard streamed {streamed} "
          f"shards ({streamed * opened.shard_bytes} bytes) through the staging ring in "
          f"{staged_s} s ({streamed * opened.shard_bytes / staged_s / 1e9} GB/s, the mmap "
          f"copy into pinned staging, the H2D copy, the CRC and the relaxes), bitwise "
          f"equal to the resident relaxes", flush=True)
    crc_row["launches"] = sum(n for _, n in CRC_VERIFIED)
    print(f"crc32 launches on 9c's streamed runs (each its run's checked copies): "
          f"{json.dumps(dict(CRC_VERIFIED))}", flush=True)
    return rows, launches["edge_relax"], source, res["bfs"][0], crc_row


def pr_push_streamed(torch, eng, pagerank, tg, fused, iters=OOC_PR_ITERS):
    """pr_push's streamed run of ``iters`` rounds through
    ``run_streamed(fused=...)``, normalised as ``pr_push`` does: the eager
    regime is the runner's option, not pr_push's."""
    valid = tg.valid_vertex_mask()
    step, cond, active = pagerank._pr_streamed_fns(0.85, 1e-9)
    io0 = tg.io.snapshot()
    state0 = (torch.zeros(tg.n_pad, device=tg.device),
              torch.where(valid, 1.0 - 0.85, 0.0))
    rounds, (rank, resid) = eng.run_streamed(tg, step, state0, cond, active, iters,
                                             fused=fused)
    rank = rank + resid
    return (torch.where(valid, rank / rank.sum(), 0.0),
            pagerank._dense_stats(tg, rounds, io0))


def round_profile(torch, eng, pagerank, tg, label):
    """One eager streamed pr_push round on ``tg`` from an empty pool (every
    shard a miss): its wall, then the device time of a second such round
    by op under ``torch.profiler``: what holds a round, the link (its H2D
    copies) or the relaxes."""
    tg._pool.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pr_push_streamed(torch, eng, pagerank, tg, False, iters=1)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    tg._pool.clear()
    events, err = profiled(torch, lambda: pr_push_streamed(torch, eng, pagerank, tg, False,
                                                           iters=1))
    ops_ms = sorted(((ev.key, (getattr(ev, "self_device_time_total", 0) or 0) / 1e3, ev.count)
                     for ev in events or ()), key=lambda r: -r[1])
    ops_ms = [r for r in ops_ms if r[1] > 0]
    copy = sum(ms for key, ms, _ in ops_ms if "emcpy" in key)
    print(f"ooc round profile, {label}: wall {wall} ms ({tg.nshards} misses, "
          f"{tg.nshards * tg.shard_bytes} bytes); device {sum(r[1] for r in ops_ms)} ms, "
          f"copies {copy} ms; by op (ms, calls): {json.dumps(ops_ms[:10])}"
          + (f"; profiler: {err}" if err else ""), flush=True)


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
# depth cut of the pagerank replays: they take the first batch only; the
# cross-pool pair runs each solve to convergence (DYN_DET_ITERS is the
# suite's cap of 300, as for the replay held to scratch).  At a pool of 4
# every round misses all 16 shards: 0.28-0.39 s a round on an H100 with
# each copy's CRC on the card (0.76 s with the host's zlib); all six
# batches took 9g to 358.8 s and the script to 981.1 s (PERF.md).
# DYN_SUB_ITERS rounds a solve for the substrate check
DYN_PR_BATCHES, DYN_DET_ITERS, DYN_SUB_ITERS = 1, 300, 20


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
          f"{len(rows)} rows in {time.perf_counter() - t0} s (three builds)",
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


# ---- phase 9h: multi-source traversal and the graph query server ------------

MS_SEED = 19                   # the seven random lanes beside phase 3's source
MS_WIDE = 40                   # lanes of the two-launch kernel case (groups of 32)
MS_DET_LANES = 4               # 9h c: ms_ppr lanes under det add, quickstart graph


def lanes_cases(torch, g, fr, gk, gen):
    """(name, kwargs of ``edge_relax_lanes``) on the web graph: push over the
    CSR (a dense round: each lane's frontier a tenth of the vertices, so
    the union's mass passes the dense cutoff) and batch over the advance
    output of a sparse union (a quarter percent a lane, the budget the
    ladder picks for its mass); f32 min weighted (bfs, sssp), f32 add
    unweighted (ppr), int32 min; B = 8, the batch case once at MS_WIDE
    lanes (two launches), and +inf seeds in two lanes (the clamp).  Then
    the in-place route as the two-buffer rounds call it (``in_place``: ``out``
    starts as a spare buffer equal to src_val but at the frontier and the
    sentinel column, reseeded at the union's columns for a batch, in full
    for a push; ``changed``: the changed lanes held to
    ``batched_updated_mask``).  The first case is the kernel's table
    case."""
    dev = g.device
    n_pad, m_pad = g.n_pad, g.m_pad

    def frontier(b, p):
        f = torch.rand((b, n_pad), generator=gen, device=dev) < p
        f[:, g.sentinel] = False
        return f

    def signed(b, inf_lanes=()):
        x = torch.randn((b, n_pad), generator=gen, device=dev) * 4
        pick = torch.rand((b, n_pad), generator=gen, device=dev)
        x = torch.where(pick < 0.05, torch.tensor(-0.0, device=dev), x)
        for lane in inf_lanes:   # unreached vertices: seeds beyond the neutral
            x[lane] = torch.where(pick[lane] > 0.7, torch.tensor(float("inf"), device=dev),
                                  x[lane])
        return x

    def mass(b):
        return torch.rand((b, n_pad), generator=gen, device=dev) / g.n

    def advanced(active):
        union = active.any(0)
        cap = fr.pick_capacity(int(union.sum()), fr.ladder_capacities(n_pad, g.block_size))
        budget = fr.pick_capacity(int(g.budget_edge_mass(union)),
                                  fr.ladder_capacities(m_pad, g.block_size))
        f = fr.compact(union, cap, g.sentinel)
        src, dst, w, valid, _ = gk.advance_frontier(
            f.idx, f.count, g.out_deg, g.row_ptr, g.col_idx, g.edge_w, budget=budget,
            sentinel=g.sentinel, m_pad=m_pad)
        return dict(src=src, dst=dst, w=w, valid=valid), budget, f.idx

    def spare(sv, active):
        """Last round's buffer: src_val but where the frontier is (the labels
        that round lowered) and in the sentinel column, where it is higher
        (+0.0 where src_val holds -0.0)."""
        stale = torch.where(active, sv.abs() + 1.0, sv)
        stale[:, -1] = sv[:, -1] + 1.0
        return stale

    csr = dict(src=g.src_idx, dst=g.col_idx, w=g.edge_w, valid=None)
    dense8 = frontier(8, 0.1)
    sparse8 = frontier(8, 0.0025)
    batch8, budget8, union8 = advanced(sparse8)
    wide = frontier(MS_WIDE, 0.0025)
    batch_wide, budget_wide, union_wide = advanced(wide)
    i32 = torch.randint(0, 2**20, (8, n_pad), generator=gen, device=dev, dtype=torch.int32)
    cases = [
        ("push f32 min weighted, B=8 (dense round)", dict(
            **csr, active=dense8, src_val=signed(8), out_init=signed(8), kind="min",
            use_weight=True)),
        (f"batch f32 min weighted, B=8 (union advance, budget {budget8})", dict(
            **batch8, active=sparse8, src_val=signed(8), out_init=signed(8), kind="min",
            use_weight=True)),
        ("push f32 add unweighted, B=8 (ppr dense round)", dict(
            **csr, active=dense8, src_val=mass(8), out_init=torch.zeros((8, n_pad), device=dev),
            kind="add", use_weight=False)),
        (f"batch f32 add unweighted, B=8 (ppr, budget {budget8})", dict(
            **batch8, active=sparse8, src_val=mass(8),
            out_init=torch.zeros((8, n_pad), device=dev), kind="add", use_weight=False)),
        ("push i32 min unweighted, B=8", dict(
            **csr, active=dense8, src_val=i32, out_init=i32.flip(0).contiguous(), kind="min",
            use_weight=False)),
        (f"batch i32 min unweighted, B=8 (budget {budget8})", dict(
            **batch8, active=sparse8, src_val=i32, out_init=i32.flip(0).contiguous(),
            kind="min", use_weight=False)),
        (f"batch f32 min weighted, B={MS_WIDE} (two launches, budget {budget_wide})", dict(
            **batch_wide, active=wide, src_val=signed(MS_WIDE), out_init=signed(MS_WIDE),
            kind="min", use_weight=True)),
        ("push f32 min weighted, B=8, +inf seeds in lanes 1 and 5 (the clamp)", dict(
            **csr, active=dense8, src_val=signed(8), out_init=signed(8, (1, 5)), kind="min",
            use_weight=True)),
        (f"batch f32 min weighted, B=8, +inf seeds in lanes 1 and 5 (budget {budget8})", dict(
            **batch8, active=sparse8, src_val=signed(8), out_init=signed(8, (1, 5)),
            kind="min", use_weight=True)),
    ]
    sv_sparse, sv_dense, sv_wide = signed(8), signed(8), signed(MS_WIDE)
    return cases + [
        (f"in place: batch f32 min weighted, B=8, reseeded at the union, changed lanes "
         f"(a sparse round, budget {budget8})", dict(
             **batch8, active=sparse8, src_val=sv_sparse, out_init=spare(sv_sparse, sparse8),
             kind="min", use_weight=True, in_place=dict(at=union8), changed=True)),
        ("in place: push f32 min weighted, B=8, reseeded in full, changed lanes (a dense "
         "round)", dict(
             **csr, active=dense8, src_val=sv_dense, out_init=spare(sv_dense, dense8),
             kind="min", use_weight=True, in_place=dict(at=None), changed=True)),
        (f"in place: batch f32 min weighted, B={MS_WIDE}, reseeded at the union, changed "
         f"lanes (two launches, budget {budget_wide})", dict(
             **batch_wide, active=wide, src_val=sv_wide, out_init=spare(sv_wide, wide),
             kind="min", use_weight=True, in_place=dict(at=union_wide), changed=True)),
    ]


def cuda_ms_each(torch, fn, reset, reps=5):
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up, each
    after ``reset()`` and timed alone by a CUDA event pair (an in-place call
    gets its inputs back between calls, outside the timing).  A spin of
    about a millisecond on the card before each start event keeps the
    host's launch of ``fn`` out of the timing."""
    reset()
    fn()
    total = 0.0
    for _ in range(reps):
        reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def run_lanes_case(torch, gk, ops, name, kw):
    """``edge_relax_lanes`` (or, for an ``in_place`` case, ``edge_relax_lanes_``)
    against its plain version on the card: bitwise, f32 add within
    ADD_RTOL_OF_ABS_SUM of each output's terms, and a requested changed
    mask bitwise to ``batched_updated_mask``; its ms, the plain version's,
    one ``scatter_reduce_`` over the flattened (B·n_pad) index of the ready
    messages (library_ms), B launches of ``edge_relax`` on the same rows
    (per_lane_edge_relax_ms; not for an in-place case) and the bound of the
    bytes this input needs."""
    kind, use_w, valid = kw["kind"], kw["use_weight"], kw["valid"]
    src, dst, w, active, sv, init = (kw[k] for k in ("src", "dst", "w", "active",
                                                     "src_val", "out_init"))
    in_place = kw.get("in_place")
    b, n_pad = init.shape
    m = src.shape[0]
    changed = torch.zeros((b, n_pad), dtype=torch.bool, device=src.device) \
        if kw.get("changed") else None
    # an in-place call's buffer: the spare ``init``, reseeded by the call
    out = init.clone() if in_place is not None else None
    at = in_place["at"] if in_place is not None else None

    def reset():
        if out is not None:
            out.copy_(init)
        if changed is not None:
            changed.zero_()

    def kernel():
        if in_place is None:
            return gk.edge_relax_lanes(src, dst, w, active, sv, init, valid=valid, kind=kind,
                                       use_weight=use_w)
        return gk.edge_relax_lanes_(src, dst, w, active, sv, out, valid=valid, kind=kind,
                                    use_weight=use_w, at=at, reseed=True, changed=changed)

    seeds = init if in_place is None else sv    # what the relax reduces into

    def plain():
        if valid is None:
            return gk.batched_push_ref(src, dst, w, sv, active, seeds, kind, use_w)
        return gk.batched_relax_ref(src, dst, w, valid, sv, active, seeds, kind, use_w)

    before = gk.edge_relax_lanes.launches
    reset()
    got, want = kernel().clone(), plain()
    torch.cuda.synchronize()
    launches = gk.edge_relax_lanes.launches - before
    check(launches == -(-b // 32), f"lanes {name}: {launches} launches counted")
    keep = active[:, src] if valid is None else valid & active[:, src]    # (B, m)
    msg = gk.edge_message(sv[:, src], w, kind, use_w)
    float_add = kind == "add" and init.dtype == torch.float32
    if float_add:
        terms = torch.where(keep, msg, 0.0).abs()
        scale = torch.zeros_like(want).index_add_(1, dst, terms) + seeds.abs()
        err = (got - want).abs()
        check(bool((err <= ADD_RTOL_OF_ABS_SUM * scale + 1e-30).all()),
              f"lanes {name}: add outside tolerance (max err {float(err.max())})")
        max_err = float(err.max())
        del terms, scale, err
    else:
        check(torch.equal(bits(torch, got), bits(torch, want)),
              f"lanes {name}: kernel and plain version differ bitwise")
        max_err = 0.0
    if changed is not None:
        check(torch.equal(changed, ops.batched_updated_mask(seeds, want)),
              f"lanes {name}: changed lanes differ from batched_updated_mask")
        n_changed = int(changed.sum())
    del got, want
    # library yardstick: one scatter_reduce_ over the flattened lane index
    reduce = {"min": "amin", "max": "amax", "add": "sum"}[kind]
    flat_msg = torch.where(keep, msg.to(init.dtype), gk.neutral_for(kind, init.dtype).item())
    flat_msg = flat_msg.reshape(-1)
    flat_idx = (torch.arange(b, device=src.device)[:, None] * n_pad
                + dst.long()[None, :]).reshape(-1)
    buf = seeds.clone().reshape(-1)
    del msg
    # the per-lane route: B launches of edge_relax on the same rows
    masks = keep if valid is not None else None

    def per_lane():
        for i in range(b):
            if masks is None:
                gk.edge_relax(src, dst, w, active[i], sv[i], init[i], kind=kind,
                              use_weight=use_w, vertex_mask=True, case="push")
            else:
                gk.edge_relax(src, dst, w, masks[i], sv[i], init[i], kind=kind,
                              use_weight=use_w, vertex_mask=False, case="batch")

    # out of place the calls repeat the same work back to back; in place
    # each gets its spare buffer back first
    t_k = cuda_ms(torch, kernel) if in_place is None else cuda_ms_each(torch, kernel, reset)
    t_p = cuda_ms(torch, plain)
    t_l = cuda_ms(torch, lambda: buf.scatter_reduce_(0, flat_idx, flat_msg, reduce))
    t_r = cuda_ms(torch, per_lane) if in_place is None else None
    del flat_msg, flat_idx, buf, masks
    work = lanes_work(torch, src, valid, keep, init, kind, use_w,
                      dst=dst if in_place is not None else None, at=at, changed=changed,
                      reseed=in_place is not None)
    b_ms, b_by = bound_ms(work["bytes"], work["messages"])
    return dict(case=name, lanes=b, in_place=in_place is not None, launches=launches,
                ms=t_k, plain_ms=t_p, library_ms=t_l, per_lane_edge_relax_ms=t_r,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=max_err,
                compare="allclose" if float_add else "bitwise",
                changed_mask=None if changed is None else "bitwise",
                changed=None if changed is None else n_changed,
                slots=m, slots_sending=work["slots_sending"], messages=work["messages"],
                gathered=work["gathered"], clamped_lanes=work["clamped_lanes"])


def lanes_work(torch, src, valid, keep, init, kind, use_w, dst=None, at=None, changed=None,
               reseed=False):
    """What a lane relax over these inputs must move, each input once:
    src for each slot (each valid one under a slot mask, whose 1-B mask is
    read for every slot); the frontier at the distinct sources of those
    slots, one byte a lane; dst for each slot that sends (every slot in a
    clamped lane); w for each slot some lane sends from; src_val at the
    distinct (lane, source) pairs that send; out_init read and out written
    once.  ``keep`` is the (B, m) send mask.  Messages: one per sending
    pair of (lane, slot), and every slot of a clamped lane.

    In place (``dst``, the list's dst, given): no copy — ``out`` read and
    written only at the distinct (lane, dst) pairs a message reaches; with
    ``at`` (a reseed at those columns and the sentinel column) src_val is
    read and out written at every lane of those columns as well (src_val's
    gathers lie among them), out read at the other pairs; ``reseed``
    without ``at`` (a reseed in full) src_val read and out written once
    in full, as the copy out of place.  ``changed``: the mask the call
    set, one byte written per set entry."""
    b, n_pad = init.shape
    m = src.shape[0]
    s = init.element_size()
    read = src if valid is None else src[valid]
    clamp = beyond_neutral(torch, init, kind).any(1)
    n_any = int(keep.any(0).sum())
    n_send = m if bool(clamp.any()) else n_any
    gathered = sum(distinct_sources(torch, src[keep[i]], n_pad) for i in range(b))
    n_msgs = int(keep.sum()) + int(clamp.sum()) * m
    src_val_bytes = s * gathered
    if dst is None:
        out_bytes = 2 * b * n_pad * s
    else:
        lane = torch.arange(b, device=src.device)[:, None] * n_pad
        pairs = torch.zeros(b * n_pad, dtype=torch.bool, device=src.device)
        pairs[(lane + dst.long()[None, :])[keep]] = True
        if at is None and reseed:
            src_val_bytes = s * b * n_pad
            out_bytes = s * b * n_pad
        elif at is None:
            out_bytes = 2 * s * int(pairs.sum())
        else:
            cols = torch.zeros(n_pad, dtype=torch.bool, device=src.device)
            cols[at.long()] = True
            cols[-1] = True
            reseeded = cols.expand(b, n_pad).reshape(-1)
            src_val_bytes = s * b * int(cols.sum())
            out_bytes = s * int((pairs | reseeded).sum()) + s * int((pairs & ~reseeded).sum())
    nbytes = (4 * read.shape[0] + (0 if valid is None else m)
              + b * distinct_sources(torch, read, n_pad) + 4 * n_send
              + (4 * n_any if use_w else 0) + src_val_bytes + out_bytes
              + (0 if changed is None else int(changed.sum())))
    return dict(bytes=nbytes, messages=n_msgs, slots_sending=n_send, gathered=gathered,
                clamped_lanes=int(clamp.sum()))


def ms_sources(np, g, source, seed):
    """Phase 3's source as lane 0, then seven seeded random vertices with
    out-edges."""
    deg = g.out_deg[: g.n].cpu().numpy()
    rng = np.random.default_rng(seed)
    return [source] + [int(v) for v in rng.choice(np.flatnonzero(deg > 0), 7,
                                                  replace=False)]


def stats_equal(name, da, db, sweep=None):
    """RunStats dicts equal but ``substrate``.  Given ``sweep``, one
    round's dense sweep (ppr: the frontier is ``resid > tol`` over float
    sums taken in another order), the rounds may differ by one and
    ``edges_touched`` by one sweep; every other counter stays equal."""
    keys = [k for k in db if k != "substrate"]
    da, db = {k: da[k] for k in keys}, {k: db[k] for k in keys}
    if sweep is not None and da != db:
        print(f"  {name}: cuda {da} vs torch {db}", flush=True)
        check(abs(da["rounds"] - db["rounds"]) <= 1, f"{name}: rounds differ by more than one")
        check(abs(da["edges_touched"] - db["edges_touched"]) <= sweep,
              f"{name}: edges_touched differ by more than one sweep ({sweep})")
        for d in (da, db):
            for k in ("rounds", "sparse_rounds", "dense_rounds", "edges_touched"):
                d.pop(k)
    check(da == db, f"{name}: RunStats differ: {da} vs {db}")


def serving_phase(torch, np, tc, gk, ops, fr, ms, serving, bfs, pagerank, gen_mod, g, kg,
                  source, ksource, bfs_ref):
    """9h: multi-source traversal and the graph query server at full width.
    a. ``edge_relax_lanes`` against its plain version (``lanes_cases``);
    b. on the web graph, from phase 3's source and seven seeded vertices,
       ``benchmarks/serving.py`` (warm-up 1, one timed call): 8 per-source
       bfs and sssp runs, ``ms_bfs`` and ``ms_sssp`` (every lane bitwise to
       its source's run, lane 0 to phase 6's bfs), the server's 16 ragged
       requests on 8 slots after a warm pass (each bitwise to its source's
       run); ``ms_ppr`` (lanes within PR_TOL of ``ppr_push``); then the
       three under "torch", labels and RunStats equal; ``ms_bfs`` on kron
       (``kg``, unweighted) bitwise to per-source runs;
    c. ``ms_ppr`` at MS_DET_LANES lanes under det add on phase 5's
       quickstart graph, each lane bitwise to ``ppr_push``.
    The cuda runs of b are the path: counts set to 0 just before, read
    just after.  Returns ``(kernel rows, launches)``."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    rng = torch.Generator(device="cuda").manual_seed(MS_SEED)
    rows = []
    for name, kw in lanes_cases(torch, g, fr, gk, rng):
        row = run_lanes_case(torch, gk, ops, name, kw)
        rows.append(row)
        print("  edge_relax_lanes " + json.dumps(row), flush=True)
        del kw
    torch.cuda.empty_cache()
    print(f"9h a: {time.perf_counter() - t0} s", flush=True)

    sources = ms_sources(np, g, source, MS_SEED)
    ksources = ms_sources(np, kg, ksource, MS_SEED)
    print(f"9h sources: web {sources}, kron {ksources}", flush=True)
    gk.reset_launches()
    t0 = time.perf_counter()
    results = {}
    srows = serving.run(graphs=(g, sources), warmup=1, iters=1, results=results)
    t_suite = time.perf_counter() - t0
    t0 = time.perf_counter()
    ppr, ppr_st = ms.ms_ppr(g, sources)
    torch.cuda.synchronize()
    t_ppr = time.perf_counter() - t0
    t0 = time.perf_counter()
    kdist, kst = ms.ms_bfs(kg, ksources)
    torch.cuda.synchronize()
    t_kron = time.perf_counter() - t0
    launches = gk.launch_counts()
    print(f"9h launches (cuda): {json.dumps(launches)}", flush=True)
    for k in ("edge_relax_lanes", "advance", "edge_relax"):
        check(launches[k] > 0, f"9h: kernel {k} was not launched")
    by = {r[0]: r for r in srows}
    for name, us, derived, stats in srows:
        print(f"  9h {name} us={us} {derived} {json.dumps(stats)}", flush=True)
    for algo in ("bfs", "sssp"):
        seq, bat = by[f"serving/seq_{algo}"][3], by[f"serving/batched_{algo}_b8"][3]
        check(bat["bitwise_equal"] == 1 and torch.equal(
            results[f"serving/seq_{algo}"], results[f"serving/batched_{algo}_b8"]),
            f"9h ms_{algo}: a lane differs from its source's {algo}_dd_sparse")
        check(bat["substrate"] == "cuda" and bat["sources"] == 8,
              f"9h ms_{algo}: substrate {bat['substrate']}, sources {bat['sources']}")
        print(f"9h {algo}: edges_per_source sequential {seq['edges_per_source']} batched "
              f"{bat['edges_per_source']} ratio "
              f"{bat['edges_per_source'] / seq['edges_per_source']} (the JAX ci_gate serve "
              f"asks <= 0.5 at its suite's size; printed here, not asserted)", flush=True)
    check(torch.equal(results["serving/batched_bfs_b8"][0], bfs_ref),
          "9h ms_bfs: lane 0 differs from phase 6's bfs_dd_sparse")
    seq_bfs = results["serving/seq_bfs"]
    for r in results["serving/server_bfs"]:
        check(r.reject_reason is None and torch.equal(
            torch.from_numpy(r.labels), seq_bfs[sources.index(r.source)].cpu()),
            f"9h server: request {r.rid} differs from its source's bfs_dd_sparse")
    srv = by["serving/server_bfs"][3]
    print(f"9h server: {srv['requests']} requests on {srv['max_batch']} slots, "
          f"qps {srv['qps']} p50_us {srv['p50_us']} p99_us {srv['p99_us']} "
          f"(after a warm pass; NVIDIA card, see the environment line)", flush=True)
    for i, s in enumerate(sources):
        want, _ = pagerank.ppr_push(g, s)
        check(torch.allclose(ppr[i], want, rtol=PR_TOL[0], atol=PR_TOL[1]),
              f"9h ms_ppr: lane {i} outside PR_TOL of ppr_push")
    print(f"9h ms_ppr web: {t_ppr} s {json.dumps(ppr_st.as_dict())}", flush=True)
    seq_edges = 0
    for i, s in enumerate(ksources):
        kd, kseq = bfs.bfs_dd_sparse(kg, s)
        seq_edges += kseq.edges_touched
        check(torch.equal(kdist[i], kd), f"9h ms_bfs kron: lane {i} differs from its source's run")
    print(f"9h ms_bfs kron: {t_kron} s {json.dumps(kst.as_dict())}; edges_per_source "
          f"sequential {seq_edges / len(ksources)} batched {kst.edges_touched / kst.sources} "
          f"ratio {kst.edges_touched / seq_edges}", flush=True)

    t0 = time.perf_counter()
    before = gk.launch_counts()
    with ops.substrate_scope("torch"):
        tb, tbs = ms.ms_bfs(g, sources)
        ts, tss = ms.ms_sssp(g, sources)
        tp, tps = ms.ms_ppr(g, sources)
    check(gk.launch_counts() == before, "9h: the torch substrate launched a kernel")
    check(torch.equal(tb, results["serving/batched_bfs_b8"])
          and torch.equal(ts, results["serving/batched_sssp_b8"]),
          "9h: torch lanes differ from cuda lanes")
    check(torch.allclose(tp, ppr, rtol=PR_TOL[0], atol=PR_TOL[1]),
          "9h: torch ppr lanes outside PR_TOL of cuda's")
    stats_equal("9h ms_bfs", by["serving/batched_bfs_b8"][3], tbs.as_dict())
    stats_equal("9h ms_sssp", by["serving/batched_sssp_b8"][3], tss.as_dict())
    stats_equal("9h ms_ppr", ppr_st.as_dict(), tps.as_dict(), sweep=g.m)
    t_torch = time.perf_counter() - t0
    print(f"9h torch substrate: {t_torch} s, labels and RunStats equal", flush=True)
    # the batched runs once more on the "cuda" substrate, device time by kernel
    runs = {"ms_bfs": Run(lambda: ms.ms_bfs(g, sources)),
            "ms_sssp": Run(lambda: ms.ms_sssp(g, sources)),
            "ms_ppr": Run(lambda: ms.ms_ppr(g, sources))}
    with ops.substrate_scope("cuda"):
        prof = print_profile(torch, gk, "serving", runs,
                             (by["serving/batched_bfs_b8"][1]
                              + by["serving/batched_sssp_b8"][1]) / 1e3 + t_ppr * 1e3)
    # the lanes' seed and reseed passes (lanes_prep: <..., at, seed>)
    seed = [r for r in prof if r["kernel"].startswith("lanes_prep")]
    print(f"profile serving seed: {sum(r['total_ms'] for r in seed)} ms in "
          f"{sum(r['calls'] for r in seed)} calls "
          + json.dumps({r["kernel"]: [r["calls"], r["total_ms"]] for r in seed}), flush=True)

    t0 = time.perf_counter()
    src, dst, n = gen_mod.web_crawl_like(16, 5, 8, 2, seed=0)
    w = gen_mod.random_weights(len(src), seed=1)
    small = tc.from_coo(src, dst, n, w, build_csc=True)
    det_sources = [int(v) for v in np.random.default_rng(MS_SEED).integers(0, n, MS_DET_LANES)]
    with ops.deterministic_add_scope(True):
        dr, _ = ms.ms_ppr(small, det_sources)
        for i, s in enumerate(det_sources):
            check(torch.equal(bits(torch, dr[i]), bits(torch, pagerank.ppr_push(small, s)[0])),
                  f"9h c: det-add ms_ppr lane {i} differs bitwise from ppr_push")
    print(f"9h c: det-add ms_ppr, {MS_DET_LANES} lanes on the quickstart graph (n={n}), "
          f"bitwise to ppr_push, in {time.perf_counter() - t0} s", flush=True)
    print(f"9h: {time.perf_counter() - t_phase} s (suite {t_suite}, ms_ppr {t_ppr}, "
          f"kron {t_kron}, torch substrate {t_torch})", flush=True)
    return rows, launches, (sources, results["serving/batched_bfs_b8"])


# ---- phase 9i: the multi-device path on a virtual mesh ----------------------

MESH_NDEV = 8                  # the reference's acceptance cell: blocked OEC at 8
MESH_GRID = (2, 4)             # the CVC grid of 8 positions on a 2-axis mesh
MESH_SMALL_NDEV = 4            # algo_classes' sharded tc cell; the batched lanes
MESH_PR_ITERS = 20             # det-add pr_push's rounds (depth cut, as 9c's)


def mesh_for(tc_mesh, dev, grid):
    """A mesh of ``grid`` (an int: one axis) on ``dev``, and its axes."""
    if isinstance(grid, int):
        return tc_mesh.Mesh({"data": grid}, device=dev), ("data",)
    return tc_mesh.Mesh({"data": grid[0], "model": grid[1]}, device=dev), ("data", "model")


def shard_keys(torch, src, dst, n_pad):
    return src.long() * n_pad + dst.long()


def partition_check(torch, label, sg, g):
    """Each shard in (src, dst) order, the shards' edge multiset the CSR's
    (and, with in-edge shards, the CSC's), and each shard's row_ptr and
    deg its own counts.  Returns the shards' edge counts."""
    n_pad, sent = sg.n_pad, sg.sentinel
    lists = [("out", sg.src, sg.dst, sg.w, g.src_idx, g.col_idx, g.edge_w)]
    if sg.has_csc:
        lists.append(("in", sg.in_nbr, sg.in_dst, sg.in_w, g.in_col_idx, g.in_src_idx,
                      g.in_edge_w))
    counts = None
    for name, s, d, w, gs, gd, gw in lists:
        key = shard_keys(torch, s, d, n_pad)
        check(bool((key[:, 1:] >= key[:, :-1]).all()),
              f"9i {label} {name}: a shard is not in (src, dst) order")
        real = s != sent
        flat = key[real]
        order = torch.sort(flat).indices
        want_key = shard_keys(torch, gs[: g.m], gd[: g.m], n_pad)
        want_order = torch.sort(want_key).indices
        check(torch.equal(flat[order], want_key[want_order])
              and torch.equal(bits(torch, w[real][order]), bits(torch, gw[: g.m][want_order])),
              f"9i {label} {name}: the shards' edges are not the graph's")
        if name == "out":
            owner = torch.arange(sg.ndev, device=s.device).unsqueeze(1).expand_as(s)[real]
            deg = torch.bincount(owner * n_pad + s[real].long(),
                                 minlength=sg.ndev * n_pad).reshape(sg.ndev, n_pad)
            deg[:, sent] = 0
            rp = torch.zeros_like(sg.shard_row_ptr)
            rp[:, 1:] = torch.cumsum(deg, 1)
            check(torch.equal(deg.to(torch.int32), sg.shard_deg)
                  and torch.equal(rp, sg.shard_row_ptr),
                  f"9i {label}: a shard's row_ptr or deg disagrees with its edges")
            counts = real.sum(1)
    return counts


def build_mesh_graph(torch, shard_graph, tc_mesh, label, g, shape, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh, axes = mesh_for(tc_mesh, g.device, shape)
    sg = shard_graph(g, mesh, axes, policy="blocked", **kw)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    counts = partition_check(torch, label, sg, g)
    print(f"9i a {label}: built in {t_build} s; ndev={sg.ndev} scheme={sg.scheme} "
          f"reducer={sg.red.mode} epd={sg.epd} shard edges {counts.tolist()} imbalance "
          f"{float(counts.max()) / max(float(counts.float().mean()), 1.0)} device bytes "
          f"{sg.shard_bytes}; the shards hold the graph's edges in (src, dst) order, "
          f"row_ptr and deg their own", flush=True)
    return sg


def comm_closed_form(name, sg, stats, bc=False):
    """``comm_elems`` against its closed form: each round one label
    reduction (bc: two forward relaxes a level, and the reversed one at
    the reverse-safe rate), each sparse round one flag collective."""
    e = sg.comm_per_relax()[0]
    d = sg.ndev
    if bc:
        lvl = stats.rounds // 2
        want = 2 * lvl * e + lvl * sg.comm_per_relax(reverse=True)[0]
    else:
        want = stats.rounds * e + stats.sparse_rounds * d * (d - 1)
    check(stats.comm_elems == want,
          f"9i {name}: comm_elems {stats.comm_elems}, closed form {want}")


def gated_relax_case(torch, gk, sg, gen):
    """edge_relax with its gate on shard 0's dense relax (the shape the
    sharded sparse round launches): gate 1 bitwise the ungated launch,
    gate 0 ``out_init`` bitwise; each launch timed by CUDA events (the
    host's wrapper included) and by the profiler's device time, the
    gate-0 launch against its bound, the seed copy of out."""
    n_pad = sg.n_pad
    dev = sg.device
    mask = torch.rand(n_pad, generator=gen, device=dev) < 0.3
    mask[sg.sentinel] = False
    sv = torch.rand(n_pad, generator=gen, device=dev) * 64
    init = torch.rand(n_pad, generator=gen, device=dev) * 64
    args = (sg.src[0], sg.dst[0], sg.w[0], mask, sv, init)
    kw = dict(kind="min", use_weight=True, vertex_mask=True, case="push")
    on = torch.ones((), dtype=torch.int32, device=dev)
    off = torch.zeros((), dtype=torch.int32, device=dev)
    plain = gk.edge_relax(*args, **kw)
    check(torch.equal(bits(torch, gk.edge_relax(*args, gate=on, **kw)), bits(torch, plain)),
          "9i b: gate 1 differs from the ungated relax")
    check(torch.equal(bits(torch, gk.edge_relax(*args, gate=off, **kw)), bits(torch, init)),
          "9i b: gate 0 is not out_init")
    check(not torch.equal(plain, init), "9i b: the case relaxes nothing")
    times = {}
    for label, gate in (("gate0", off), ("gate1", on), ("ungated", None)):
        def fn(gate=gate):
            return gk.edge_relax(*args, gate=gate, **kw)
        times[label + "_us"] = cuda_ms(torch, fn) * 1e3
        dev = device_ms(torch, fn)
        times[label + "_device_us"] = None if dev is None else dev * 1e3
    seed_bytes = 2 * n_pad * init.element_size()
    row = dict(case=f"shard 0 of {sg.ndev}: push f32 min over {sg.src.shape[1]} slots",
               **times, gate0_bound_us=bound_ms(seed_bytes, 0)[0] * 1e3, bound_by="bytes",
               bitwise=True)
    print("9i b gated edge_relax " + json.dumps(row), flush=True)
    return row


def mesh_phase(torch, np, gk, ops, mods, g, gsym, kgsym, source, refs, tc_ref, ms_ref,
               expect_launches=True):
    """9i: the multi-device path on a virtual mesh of positions on the card.
    a. the web graphs sharded at ``MESH_NDEV`` (blocked OEC) and on the
       ``MESH_GRID`` CVC grid, each build timed and checked
       (``partition_check``);
    b. the gated ``edge_relax`` (``gated_relax_case``);
    c. bfs_dd_sparse (fused and per round), sssp_dd_sparse, cc_dd_sparse,
       kcore_dd_sparse(k=3), and bc_brandes and pr_push (``MESH_PR_ITERS``
       rounds) under det add at ndev 8, under "cuda" (counts set to 0 just
       before, read just after) then "torch": labels bitwise to the
       unsharded runs (phases 6 and 8's, and this phase's own of sssp, bc
       and pr_push), RunStats equal across substrates but ``substrate``,
       ``comm_elems`` its closed form, each wall beside the unsharded one;
       then the sharded bfs and cc's device time by kernel;
    d. bfs and cc on the CVC grid under reducer "cvc" and "full": labels
       bitwise, the full/cvc ``comm_elems`` ratio printed;
    e. tc_count on kron at ndev ``MESH_SMALL_NDEV``: phase 9's count;
    f. ms_bfs at B = 8 on the web graph at ndev 4: 9h's lanes bitwise,
       ``comm_elems = dense_rounds·4·3·n_pad·8``;
    g. bsp_bfs and bsp_cc at ndev 8: bsp_bfs to the unsharded
       sssp_dd_sparse (unreached as inf on both sides), bsp_cc to cc's
       component partition; their rounds beside the engine's.
    ``refs``: the earlier phases' labels by run name; ``tc_ref``: phase 9's
    kron count; ``ms_ref``: 9h's ``(sources, ms_bfs lanes)``.  g runs
    after c, while its graphs are on the card.  Returns the launches of
    c–g's cuda runs."""
    (bfs, sssp, cc, kcore, bc, pagerank, tri, ms, tc_mesh, sharded, partition) = mods
    shard_graph = sharded.shard_graph
    t_phase = time.perf_counter()
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def det(fn):
        def run():
            with ops.deterministic_add_scope(True):
                return fn()
        return run

    # a. partitions
    sg = build_mesh_graph(torch, shard_graph, tc_mesh, f"web OEC {MESH_NDEV}", g, MESH_NDEV)
    sgs = build_mesh_graph(torch, shard_graph, tc_mesh, f"web sym OEC {MESH_NDEV}", gsym,
                           MESH_NDEV)
    # b. the gated relax
    gated_relax_case(torch, gk, sg, torch.Generator(device=g.device).manual_seed(23))

    # c. the seven algorithms at ndev 8: the unsharded runs first
    unsharded = {
        "bfs_dd_sparse": Run(lambda: bfs.bfs_dd_sparse(g, source)),
        "bfs_dd_sparse(fused=False)": Run(lambda: bfs.bfs_dd_sparse(g, source, fused=False)),
        "sssp_dd_sparse": Run(lambda: sssp.sssp_dd_sparse(g, source)),
        "cc_dd_sparse": Run(lambda: cc.cc_dd_sparse(gsym)),
        "kcore_dd_sparse(k=3)": Run(lambda: kcore.kcore_dd_sparse(gsym, 3)),
        "bc_brandes(det)": Run(det(lambda: bc.bc_brandes(g, source))),
        "pr_push(det)": Run(det(lambda: pagerank.pr_push(gsym, max_iters=MESH_PR_ITERS))),
    }
    meshed = {
        "bfs_dd_sparse": Run(lambda: bfs.bfs_dd_sparse(sg, source)),
        "bfs_dd_sparse(fused=False)": Run(lambda: bfs.bfs_dd_sparse(sg, source, fused=False)),
        "sssp_dd_sparse": Run(lambda: sssp.sssp_dd_sparse(sg, source)),
        "cc_dd_sparse": Run(lambda: cc.cc_dd_sparse(sgs)),
        "kcore_dd_sparse(k=3)": Run(lambda: kcore.kcore_dd_sparse(sgs, 3)),
        "bc_brandes(det)": Run(det(lambda: bc.bc_brandes(sg, source))),
        "pr_push(det)": Run(det(lambda: pagerank.pr_push(sgs, max_iters=MESH_PR_ITERS))),
    }
    t0 = time.perf_counter()
    base = run_path(torch, unsharded, "cuda", ops)
    for name, want in refs.items():
        check(torch.equal(bits(torch, base[name][0]), bits(torch, want)),
              f"9i c: the unsharded {name} differs from the earlier phase's")
    gk.reset_launches()
    cuda = run_path(torch, meshed, "cuda", ops)
    launches = gk.launch_counts()
    add(launches)
    print(f"9i c launches (cuda): {json.dumps(launches)}", flush=True)
    if expect_launches:
        for k in ("edge_relax", "advance"):
            check(launches[k] > 0, f"9i c: kernel {k} was not launched")
    plain = run_path(torch, meshed, "torch", ops)
    check(gk.launch_counts() == launches, "9i c: the torch substrate launched a kernel")
    for name in meshed:
        compare_runs(torch, f"9i {name}", cuda[name], plain[name])
        check(torch.equal(bits(torch, cuda[name][0]), bits(torch, base[name][0])),
              f"9i {name}: the ndev={MESH_NDEV} labels differ from the unsharded run's")
        st = cuda[name][1]
        check(st.ndev == MESH_NDEV and st.placement == "blocked",
              f"9i {name}: ndev {st.ndev}, placement {st.placement}")
        comm_closed_form(f"c {name}", sgs if name in ("cc_dd_sparse", "kcore_dd_sparse(k=3)",
                                                      "pr_push(det)") else sg,
                         st, bc=name.startswith("bc"))
        print(f"9i c {name}: sharded wall_ms cuda {cuda[name][2]} torch {plain[name][2]}, "
              f"unsharded {base[name][2]}; rounds {st.rounds} (unsharded "
              f"{base[name][1].rounds}) sparse {st.sparse_rounds} escalations "
              f"{st.shard_escalations} comm_elems {st.comm_elems}", flush=True)
    check(cuda["bfs_dd_sparse"][1].sparse_rounds > 0, "9i c: bfs ran no sparse round")
    # the sharded bfs and cc once more on "cuda", their device time by kernel
    prof_runs = {k: meshed[k] for k in ("bfs_dd_sparse", "cc_dd_sparse")}
    with ops.substrate_scope("cuda"):
        print_profile(torch, gk, "mesh", prof_runs, sum(cuda[k][2] for k in prof_runs))
    print(f"9i c: {time.perf_counter() - t0} s", flush=True)
    sssp_ref = base["sssp_dd_sparse"][0]
    cc_rounds = cuda["cc_dd_sparse"][1].rounds
    sssp_rounds = cuda["sssp_dd_sparse"][1].rounds
    del cuda, plain, meshed, unsharded
    torch.cuda.empty_cache()

    # g. the BSP baseline at ndev 8 (before the OEC graphs go)
    t0 = time.perf_counter()
    mesh8, axes8 = mesh_for(tc_mesh, g.device, MESH_NDEV)
    gk.reset_launches()
    t1 = time.perf_counter()
    pg = partition.partition_1d(g, MESH_NDEV)
    labels, rounds = partition.bsp_bfs(pg, mesh8, axes8, source)
    torch.cuda.synchronize()
    t_bfs = time.perf_counter() - t1
    inf = torch.tensor(float("inf"), device=g.device)
    check(torch.equal(torch.where(labels > 1e30, inf, labels)[: g.n],
                      torch.where(sssp_ref > 1e30, inf, sssp_ref)[: g.n]),
          "9i g: bsp_bfs differs from sssp_dd_sparse")
    del pg
    t1 = time.perf_counter()
    pgs = partition.partition_1d(gsym, MESH_NDEV)
    clab, crounds = partition.bsp_cc(pgs, mesh8, axes8)
    torch.cuda.synchronize()
    t_cc = time.perf_counter() - t1
    want = base["cc_dd_sparse"][0][: gsym.n]
    check(torch.equal(torch.unique(want, return_inverse=True)[1],
                      torch.unique(clab[: gsym.n], return_inverse=True)[1]),
          "9i g: bsp_cc's components differ from cc_dd_sparse's")
    del pgs
    launches = gk.launch_counts()
    add(launches)
    print(f"9i g: bsp_bfs {rounds} rounds in {t_bfs} s (the engine's sssp_dd_sparse "
          f"{sssp_rounds}), bsp_cc {crounds} rounds in {t_cc} s (cc_dd_sparse {cc_rounds}); "
          f"launches {json.dumps(launches)}; {time.perf_counter() - t0} s", flush=True)
    del sg, sgs, base
    torch.cuda.empty_cache()

    # d. the two reducers on the CVC grid
    t0 = time.perf_counter()
    gk.reset_launches()
    out = {}
    for reducer in ("cvc", "full"):
        sgc = build_mesh_graph(torch, shard_graph, tc_mesh, f"web CVC {MESH_GRID} {reducer}",
                               g, MESH_GRID, scheme="cvc", grid=MESH_GRID, reducer=reducer)
        bl, bst = bfs.bfs_dd_sparse(sgc, source)
        del sgc
        sgsc = build_mesh_graph(torch, shard_graph, tc_mesh,
                                f"web sym CVC {MESH_GRID} {reducer}", gsym, MESH_GRID,
                                scheme="cvc", grid=MESH_GRID, reducer=reducer)
        cl, cst = cc.cc_dd_sparse(sgsc)
        del sgsc
        torch.cuda.empty_cache()
        out[reducer] = (bl, bst, cl, cst)
    launches = gk.launch_counts()
    add(launches)
    (bl, bst, cl, cst), (fbl, fbst, fcl, fcst) = out["cvc"], out["full"]
    check(torch.equal(bits(torch, bl), bits(torch, fbl)) and torch.equal(cl, fcl),
          "9i d: the cvc and full reducers' labels differ")
    check(torch.equal(bits(torch, bl), bits(torch, refs["bfs_dd_sparse"]))
          and torch.equal(cl, refs["cc_dd_sparse"]),
          "9i d: the grid's labels differ from the unsharded runs'")
    for algo, a, b in (("bfs", bst, fbst), ("cc", cst, fcst)):
        print(f"9i d {algo}: comm_elems full {b.comm_elems} / cvc {a.comm_elems} = "
              f"{b.comm_elems / max(a.comm_elems, 1)} (the reference's bar: >= 2 at ndev 8; "
              f"printed, not asserted); reduce_axis_hops full {b.reduce_axis_hops} cvc "
              f"{a.reduce_axis_hops}", flush=True)
    print(f"9i d: launches {json.dumps(launches)}; {time.perf_counter() - t0} s", flush=True)
    del out, bl, cl, fbl, fcl

    # e. tc on kron at ndev 4
    t0 = time.perf_counter()
    skg = build_mesh_graph(torch, shard_graph, tc_mesh, f"kron sym OEC {MESH_SMALL_NDEV}",
                           kgsym, MESH_SMALL_NDEV)
    gk.reset_launches()
    count, tst = tri.tc_count(skg)
    launches = gk.launch_counts()
    add(launches)
    check(count == tc_ref, f"9i e: tc counted {count}, phase 9 {tc_ref}")
    check(tst.comm_elems == MESH_SMALL_NDEV * (MESH_SMALL_NDEV - 1), "9i e: tc's comm_elems")
    if expect_launches:
        check(launches["intersect"] > 0, "9i e: kernel intersect was not launched")
    del skg
    print(f"9i e: tc_count on kron at ndev {MESH_SMALL_NDEV}: {count} (phase 9's), "
          f"{json.dumps(tst.as_dict())}; {time.perf_counter() - t0} s", flush=True)

    # f. the batched lanes at ndev 4
    t0 = time.perf_counter()
    sources, lanes_ref = ms_ref
    sg4 = build_mesh_graph(torch, shard_graph, tc_mesh, f"web OEC {MESH_SMALL_NDEV}", g,
                           MESH_SMALL_NDEV)
    gk.reset_launches()
    lanes, mst = ms.ms_bfs(sg4, sources)
    launches = gk.launch_counts()
    add(launches)
    check(torch.equal(bits(torch, lanes), bits(torch, lanes_ref)),
          "9i f: ms_bfs lanes differ from 9h's")
    d = MESH_SMALL_NDEV
    check(mst.dense_rounds == mst.rounds and
          mst.comm_elems == mst.dense_rounds * d * (d - 1) * g.n_pad * len(sources),
          f"9i f: comm_elems {mst.comm_elems} against its closed form")
    if expect_launches:
        check(launches["edge_relax_lanes"] > 0, "9i f: kernel edge_relax_lanes was not launched")
    del sg4, lanes
    torch.cuda.empty_cache()
    print(f"9i f: ms_bfs B={len(sources)} at ndev {d}: lanes bitwise 9h's, "
          f"{json.dumps(mst.as_dict())}; launches {json.dumps(launches)}; "
          f"{time.perf_counter() - t0} s", flush=True)
    print(f"9i: {time.perf_counter() - t_phase} s; launches {json.dumps(total)}", flush=True)
    return total


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
    eight, the f32 flash kernel's four and spmm_kernel's four — registers,
    spills and static shared memory from ``-Xptxas -v`` (beside the
    dynamic bytes of a flash launch at the instantiation's widest head),
    and, where the toolkit has ``cuobjdump``, the ``HMMA`` instructions in
    each one's SASS.  Fails on a spill or on no HMMA."""
    lib = build.load("flash_attention")
    hmma = {stem: sass_hmma(build, stem) for stem in ("flash_attention", "spmm_bsr")}
    for stem, frag, count in (("flash_attention", "flash_tc_kernel", 8),
                              ("flash_attention", "flash_f32_kernel", 4),
                              ("spmm_bsr", "spmm_kernel", 4)):
        info = {name: v for name, v in build.ptxas_info(stem).items() if frag in name}
        check(len(info) == count, f"{frag}: {len(info)} instantiations in the ptxas log")
        for name, v in sorted(info.items()):
            if frag == "spmm_kernel":
                label, dyn = f"spmm_kernel {name}", ""
            else:
                n = int(name.split(f"{frag}ILi", 1)[1].split("E", 1)[0])
                width, smem_bytes = ((16 * n, lib.flash_attention_tc_smem_bytes)
                                     if frag == "flash_tc_kernel"
                                     else (8 * n, lib.flash_attention_f32_smem_bytes))
                label = f"{frag}<{n}> (d <= {width})"
                dyn = f" dynamic smem {smem_bytes(width)} B"
            n_hmma = None if hmma[stem] is None else hmma[stem].get(name, 0)
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
        # the JAX suite has no multi-source row: edge_relax_lanes is 9h's
        check(count > 0 or name == "edge_relax_lanes",
              f"kernels_bench: kernel {name} was not launched")
    print(f"kernels_bench: {len(rows)} rows in {secs} s, launches {json.dumps(launches)}",
          flush=True)
    return launches


# ---- 13. the LM server -------------------------------------------------------

# 13a: the SMOKE configs served on the CPU and on the card (slots each)
LM_SMALL_SLOTS = {"h2o-danube3-smoke": 4, "deepseek-moe-smoke": 2}
LM_SMALL_REQUESTS, LM_SMALL_SEQ = 6, 32
# f32 logits, card against CPU: |card - cpu| <= 1e-4 x the row's largest |logit|
LM_SMALL_RTOL = 1e-4
# 13b: h2o-danube-3-4b FULL, 6 requests on 4 slots (prompts of 16-256 tokens;
# 8 to PR 23, cut for the script's time)
LM_BATCH, LM_SEQ = 4, 512
LM_REQUESTS, LM_PROMPTS, LM_NEW = 6, (16, 256), 16
# the first LM_ISOLATED of them are decoded again alone (a cut from all of
# them, for the script's time: 4 to PR 23, 2 from PR 24)
LM_ISOLATED = 2
# bf16 logits of two computations of one model (other GEMM shapes, other
# sum orders): |a - b| <= 2e-2 (the CPU tests' bf16 tolerance) x the row's
# largest |logit|; an argmax is held only where the top-2 gap exceeds
# twice that
LM_BF16_TOL = 2e-2
# 13c: danube cut in depth to 2 layers (for time); the prompt and the generation pass
# position 4096, the window
LM_WINDOW_LAYERS, LM_WINDOW_PROMPT, LM_WINDOW_NEW = 2, 4080, 48
# 13d: deepseek-moe-16b FULL cut in depth to 2 of its 28 layers, f32
LM_MOE_LAYERS, LM_MOE_REQUESTS, LM_MOE_PROMPT, LM_MOE_NEW = 2, 2, 8, 4


def lm_to(tree, device):
    """A parameter tree copied to ``device``."""
    return {k: lm_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def lm_bytes(tree):
    return sum(lm_bytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
               for v in tree.values())


def lm_specs(np, vocab, n, lens, news, seed):
    """n seeded requests as (rid, prompt, max_new): prompt lengths and
    max_new drawn from the closed ranges ``lens`` and ``news``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        n_prompt = int(rng.integers(lens[0], lens[1] + 1))
        out.append((i, [int(t) for t in rng.integers(1, vocab, n_prompt)],
                    int(rng.integers(news[0], news[1] + 1))))
    return out


def lm_serve(torch, serve, server, specs, routes=None):
    """Serve fresh requests of ``specs`` through ``server``; returns (the
    tokens by rid, each rid's decode logits by tick, per-call walls of
    prefill and tick in ms, prefilled tokens, the serve wall in s).  With
    ``routes = [layers module]``, the first tick's top-k experts of each
    layer are appended to it."""
    logits, walls = {}, {"prefill": [], "tick": []}
    real_decode, real_prefill = server._decode, server._prefill

    def timed(kind, fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        walls[kind].append((time.perf_counter() - t0) * 1e3)
        return out

    def decode(*a):
        if routes is not None and not walls["tick"]:
            L = routes[0]
            real_route = L.moe_route

            def route(*ra):
                got = real_route(*ra)
                routes.append(got[2].cpu().tolist())
                return got
            L.moe_route = route
            try:
                out = timed("tick", real_decode, *a)
            finally:
                L.moe_route = real_route
        else:
            out = timed("tick", real_decode, *a)
        for r in server.slots:
            if r is not None and not r.done:
                logits.setdefault(r.rid, []).append(out[0][r.slot, 0].float())
        return out

    server._decode = decode
    server._prefill = lambda *a: timed("prefill", real_prefill, *a)
    reqs = [serve.Request(rid=i, prompt=list(p), max_new=m) for i, p, m in specs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = server.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(len(done) == len(specs) and all(r.reject_reason is None and len(r.out) == r.max_new
                                          for r in done), "lm: a request was not served")
    return ({r.rid: r.out for r in done}, logits, walls,
            sum(len(p) - 1 for _, p, _ in specs), wall)


def lm_rel_err(a, b):
    """Over paired rows, the largest max|a - b| / max|b| (b the reference)."""
    return max(float((x.float().cpu() - y.float().cpu()).abs().max()
                     / y.float().abs().max().cpu()) for x, y in zip(a, b))


def lm_small(torch, np, T, serve, cfgs):
    """13a: each SMOKE config served on the card and on the CPU with the
    same carried weights, f32: tokens equal, decode logits within
    LM_SMALL_RTOL."""
    rows = {}
    for cfg in cfgs:
        params = T.init(torch.Generator(device=DEV).manual_seed(31), cfg, device=DEV)
        specs = lm_specs(np, cfg.vocab_size, LM_SMALL_REQUESTS, (1, 12), (3, 8), seed=32)
        slots = LM_SMALL_SLOTS[cfg.name]
        card = lm_serve(torch, serve, serve.Server(cfg, params, slots, LM_SMALL_SEQ,
                                                   device=DEV), specs)
        cpu = lm_serve(torch, serve, serve.Server(cfg, lm_to(params, "cpu"), slots,
                                                  LM_SMALL_SEQ, device="cpu"), specs)
        check(card[0] == cpu[0], f"13a {cfg.name}: card tokens {card[0]} != cpu {cpu[0]}")
        err = max(lm_rel_err(card[1][rid], cpu[1][rid]) for rid in card[1])
        check(err <= LM_SMALL_RTOL, f"13a {cfg.name}: decode logits differ by {err} of the "
                                    f"row's largest (limit {LM_SMALL_RTOL})")
        rows[cfg.name] = dict(slots=slots, tokens=sum(map(len, card[0].values())),
                              max_rel_err=err)
        print(f"13a {cfg.name}: {len(specs)} requests on {slots} slots, card == cpu tokens "
              f"{card[0]}, decode logits max rel err {err} (limit {LM_SMALL_RTOL})",
              flush=True)
    return rows


def lm_same_stream(name, got, want):
    """Two runs of one request, each (tokens, logits by tick): logits
    within LM_BF16_TOL up to the tick where the tokens part, and a near tie
    there.  Returns that tick (None: equal tokens)."""
    (gt, gl), (wt, wl) = got, want
    part = next((i for i, (a, b) in enumerate(zip(gt, wt)) if a != b), None)
    for i in range(len(gt) if part is None else part + 1):
        lim = LM_BF16_TOL * float(wl[i].abs().max())
        err = float((gl[i] - wl[i]).abs().max())
        check(err <= lim, f"{name}: tick {i} logits differ by {err} (limit {lim})")
    if part is not None:
        gap = abs(float(wl[part][gt[part]]) - float(wl[part][wt[part]]))
        check(gap <= 2 * LM_BF16_TOL * float(wl[part].abs().max()),
              f"{name}: tokens part at tick {part} where the top-2 gap is {gap}")
    return part


def lm_full(torch, np, T, serve, cfg, card):
    """13b: danube FULL served on LM_BATCH slots, each request against its
    isolated greedy decode at the same shapes; the timings."""
    t0 = time.perf_counter()
    params = T.init(torch.Generator(device=DEV).manual_seed(41), cfg, device=DEV)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    warm = lm_specs(np, cfg.vocab_size, 1, (4, 4), (2, 2), seed=42)
    lm_serve(torch, serve, serve.Server(cfg, params, LM_BATCH, LM_SEQ, device=DEV), warm)
    specs = lm_specs(np, cfg.vocab_size, LM_REQUESTS, LM_PROMPTS, (LM_NEW, LM_NEW), seed=43)
    server = serve.Server(cfg, params, LM_BATCH, LM_SEQ, device=DEV)
    tokens, logits, walls, n_prefill, wall = lm_serve(torch, serve, server, specs)
    # run to run: one decode step twice, on two copies of the served cache
    rng = np.random.default_rng(44)
    step = (torch.from_numpy(rng.integers(1, cfg.vocab_size, (LM_BATCH, 1)).astype(
        np.int32)).to(DEV),
            torch.from_numpy(rng.integers(0, LM_SEQ, LM_BATCH).astype(np.int32)).to(DEV))
    runs = [T.make_decode(cfg)(params, {k: v.clone() for k, v in server.cache.items()}, *step)
            for _ in range(2)]
    deterministic = bool(torch.equal(runs[0][0], runs[1][0]) and all(
        torch.equal(runs[0][1][k], runs[1][1][k]) for k in ("k", "v")))
    cache_bytes = lm_bytes(server.cache)
    del runs, server
    print(f"13b: one decode step run twice on copies of the served cache: bitwise equal "
          f"{deterministic}", flush=True)
    parts = {}
    t1 = time.perf_counter()
    for spec in specs[:LM_ISOLATED]:
        alone = lm_serve(torch, serve, serve.Server(cfg, params, LM_BATCH, LM_SEQ, device=DEV),
                         [spec])
        rid = spec[0]
        if deterministic:
            check(tokens[rid] == alone[0][rid],
                  f"13b: request {rid} served {tokens[rid]}, alone {alone[0][rid]}")
        parts[rid] = lm_same_stream(f"13b request {rid}", (tokens[rid], logits[rid]),
                                    (alone[0][rid], alone[1][rid]))
    t_alone = time.perf_counter() - t1
    ticks = sorted(walls["tick"])
    # a tick reads every weight but the embedding (B rows of it) and every
    # layer's whole (B, S_max) K and V cache
    tick_bytes = (lm_bytes(params) - lm_bytes({"e": params["embed"]})
                  + LM_BATCH * cfg.d_model * params["embed"].element_size() + cache_bytes)
    n_gen = sum(map(len, tokens.values()))
    row = dict(requests=len(specs), isolated=LM_ISOLATED, slots=LM_BATCH, max_seq=LM_SEQ,
               prompt_tokens=sum(len(p) for _, p, _ in specs), generated=n_gen,
               deterministic=deterministic, equal_tokens=all(p is None for p in parts.values()),
               tick_ms_median=ticks[len(ticks) // 2], tick_ms_min=ticks[0],
               tick_ms_max=ticks[-1], ticks=len(ticks), tick_bytes=tick_bytes,
               tick_bound_ms=tick_bytes / H100_BYTES_PER_S * 1e3,
               prefill_ms_per_token=sum(walls["prefill"]) / n_prefill,
               generated_tokens_per_s=n_gen / wall, serve_s=wall, isolated_s=t_alone,
               init_s=t_init, param_bytes=lm_bytes(params))
    print(f"13b h2o-danube-3-4b FULL ({cfg.n_layers} layers, d_model {cfg.d_model}, bf16, "
          f"{row['param_bytes']} parameter bytes) on {card}: {len(specs)} requests "
          f"({row['prompt_tokens']} prompt tokens), served == isolated {row['equal_tokens']} "
          f"(the first {LM_ISOLATED} decoded alone) "
          f"(parted at {parts}); decode tick at B = {LM_BATCH} median "
          f"{row['tick_ms_median']} ms (min {ticks[0]}, max {ticks[-1]}, {len(ticks)} ticks) "
          f"against its byte bound {row['tick_bound_ms']} ms ({tick_bytes} bytes: the "
          f"weights less the embedding's unread rows, and the cache); prefill "
          f"{row['prefill_ms_per_token']} ms per prompt token; "
          f"{row['generated_tokens_per_s']} generated tokens/s ({n_gen} in {wall} s); "
          f"isolated runs {t_alone} s; init {t_init} s", flush=True)
    return params, row


def lm_window(torch, np, T, serve, cfg, params, card):
    """13c: one request past the window at danube's width, cut in depth
    to LM_WINDOW_LAYERS: its tokens against forward's argmax and its last
    decode logits against forward's row."""
    n = LM_WINDOW_LAYERS
    cfgw = dataclasses.replace(cfg, n_layers=n)
    pw = dict(params, layers=T.tree_map(lambda t: t[:n], params["layers"]))
    spec = lm_specs(np, cfg.vocab_size, 1, (LM_WINDOW_PROMPT, LM_WINDOW_PROMPT),
                    (LM_WINDOW_NEW, LM_WINDOW_NEW), seed=45)
    t0 = time.perf_counter()
    server = serve.Server(cfgw, pw, 1, LM_WINDOW_PROMPT + LM_WINDOW_NEW, device=DEV)
    tokens, logits, _, _, _ = lm_serve(torch, serve, server, spec)
    out, dec = tokens[0], logits[0]
    del server
    seq = torch.tensor([spec[0][1] + out[:-1]], device=DEV)
    full = T.forward(pw, cfgw, seq)[0][0, LM_WINDOW_PROMPT - 1:].float()
    check(bool(torch.isfinite(full).all()), "13c: forward's logits are not finite")
    positions = list(range(LM_WINDOW_PROMPT - 1, LM_WINDOW_PROMPT - 1 + len(out)))
    checked, worst = 0, 0.0
    for i, pos in enumerate(positions):
        row = full[i]
        scale = float(row.abs().max())
        top2 = row.topk(2).values
        worst = max(worst, float((dec[i] - row).abs().max()) / scale)
        if float(top2[0] - top2[1]) > 2 * LM_BF16_TOL * scale:
            checked += 1
            check(int(row.argmax()) == out[i],
                  f"13c: position {pos}: decode chose {out[i]}, forward {int(row.argmax())}")
    last = float((dec[-1] - full[-1]).abs().max()) / float(full[-1].abs().max())
    check(last <= LM_BF16_TOL, f"13c: the last decode logits differ from forward's by {last} "
                               f"of the row's largest (limit {LM_BF16_TOL})")
    windowed = sum(p >= cfg.sliding_window for p in positions)
    check(windowed > 0, "13c: no decode position passed the window")
    row = dict(layers=n, prompt=LM_WINDOW_PROMPT, generated=len(out),
               positions=[positions[0], positions[-1]], past_window=windowed,
               argmax_checked=checked, last_rel_err=last, max_rel_err=worst,
               seconds=time.perf_counter() - t0)
    print(f"13c window (h2o-danube-3-4b width, depth cut to {n} of {cfg.n_layers} layers) "
          f"on {card}: prompt {LM_WINDOW_PROMPT} + {len(out)} generated, decode at positions "
          f"{positions[0]}..{positions[-1]} ({windowed} past the window of "
          f"{cfg.sliding_window}); argmax == forward's at {checked} of {len(out)} positions "
          f"(the others within a top-2 gap of {2 * LM_BF16_TOL} x the row's largest); last "
          f"logits rel err {last}, max over positions {worst} (limit {LM_BF16_TOL}); "
          f"{row['seconds']} s", flush=True)
    return row


def lm_moe(torch, np, T, L, serve, cfg, card):
    """13d: deepseek-moe-16b at full width, cut to LM_MOE_LAYERS layers,
    f32: the card's tokens against the same server's on the CPU."""
    cfgm = dataclasses.replace(cfg, n_layers=LM_MOE_LAYERS, dtype="float32")
    t0 = time.perf_counter()
    params = T.init(torch.Generator(device=DEV).manual_seed(51), cfgm, device=DEV)
    specs = lm_specs(np, cfg.vocab_size, LM_MOE_REQUESTS, (LM_MOE_PROMPT, LM_MOE_PROMPT),
                     (LM_MOE_NEW, LM_MOE_NEW), seed=52)
    seq = LM_MOE_PROMPT + LM_MOE_NEW
    routes = {"card": [L], "cpu": [L]}
    card_run = lm_serve(torch, serve, serve.Server(cfgm, params, LM_MOE_REQUESTS, seq,
                                                   device=DEV), specs, routes["card"])
    host = lm_to(params, "cpu")
    nbytes = lm_bytes(params)
    del params
    cpu_run = lm_serve(torch, serve, serve.Server(cfgm, host, LM_MOE_REQUESTS, seq,
                                                  device="cpu"), specs, routes["cpu"])
    del host
    check(card_run[0] == cpu_run[0], f"13d: card tokens {card_run[0]} != cpu {cpu_run[0]}")
    err = max(lm_rel_err(card_run[1][r], cpu_run[1][r]) for r in card_run[1])
    routes = {k: v[1:] for k, v in routes.items()}
    row = dict(layers=LM_MOE_LAYERS, param_bytes=nbytes, tokens=card_run[0],
               max_rel_err=err, routes_equal=routes["card"] == routes["cpu"],
               seconds=time.perf_counter() - t0)
    print(f"13d deepseek-moe-16b (full width, depth cut to {LM_MOE_LAYERS} of {cfg.n_layers} "
          f"layers, f32, {nbytes} parameter bytes) on {card}: card == cpu tokens "
          f"{card_run[0]}; decode logits max rel err {err}; first tick's top-{cfg.moe.top_k} "
          f"experts by layer and slot, card {routes['card']} cpu {routes['cpu']}; "
          f"{row['seconds']} s", flush=True)
    return row


def lm_phase(torch, np, kern, T, L, serve, small, dense, moe, card):
    """13: the LM server.  Its path runs no hand-written kernel (the
    reference's LM server runs no Pallas kernel): the launch counts must
    not move."""
    t0 = time.perf_counter()
    before = kern.launch_counts()
    torch.cuda.reset_peak_memory_stats()
    small_rows = lm_small(torch, np, T, serve, small)
    params, full = lm_full(torch, np, T, serve, dense, card)
    window = lm_window(torch, np, T, serve, dense, params, card)
    del params
    torch.cuda.empty_cache()
    moe_row = lm_moe(torch, np, T, L, serve, moe, card)
    torch.cuda.empty_cache()
    check(kern.launch_counts() == before, "13: the LM server launched a kernel")
    row = {"small": small_rows, "dense": full, "window": window, "moe": moe_row,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "seconds": time.perf_counter() - t0, "card": card}
    print(f"13: {row['seconds']} s, max_memory_allocated {row['max_memory_allocated']} "
          f"on {card}", flush=True)
    print(json.dumps({"lm_server": row}), flush=True)
    return row


# ---- 14. the LM trainer --------------------------------------------------------

# 14a: small configs trained TRAIN_STEPS steps on the card and on the CPU from
# the same weights (the trainer test's config, tiny_model, two SMOKE configs)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 4, 32
TRAIN_LR_PEAK = 3e-4           # the reference trainer's lr_peak
# per-step losses card against CPU, relative; parameters within this rtol plus
# an atol of 2·lr a step (a near-zero gradient's sign may differ between the
# devices, and AdamW then moves that weight by ±lr)
TRAIN_RTOL = 1e-5
# 14b: h2o-danube-3-4b at full width, depth cut to 2 layers, f32, one step of
# 1 x 128 tokens; the gradients' global norm card against CPU, relative
TRAIN_WIDE_LAYERS, TRAIN_WIDE_SEQ = 2, 128
TRAIN_NORM_RTOL = 1e-4
# 14c: h2o-danube-3-4b FULL, bf16, 24 layers: the reference's train_4k sequence,
# the global batch cut from 256 to 1 (one card's memory)
TRAIN_FULL_BATCH, TRAIN_FULL_SEQ, TRAIN_FULL_STEPS = 1, 4096, 5


def train_loop_cfg(T, L):
    """``tests/test_train_loop.py``'s model (MoE, f32, remat off)."""
    return T.LMConfig(name="train-loop-moe", n_layers=2, d_model=32, n_heads=4,
                      n_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32", remat=False,
                      moe=L.MoEConfig(n_experts=4, top_k=2, d_expert=32))


def train_lrs(O, steps):
    """The rates of steps 0..steps-1 (``make_train_step``'s schedule: 100
    warm-up steps)."""
    return [float(O.cosine_schedule(s, 100, steps, TRAIN_LR_PEAK)) for s in range(steps)]


def record_steps(torch, trainer):
    """Wrap ``trainer._step``: every call's loss and wall (host clock to
    ``synchronize()``, ms) are appended to the returned lists; the real
    step is returned too."""
    losses, walls = [], []
    real = trainer._step

    def step(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a)
        losses.append(float(out[2]["loss"]))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        return out

    trainer._step = step
    return losses, walls, real


def tree_excess(torch, T, got, want, rtol):
    """The largest ``|got - want| - rtol·|want|`` over every leaf (``want``
    moved to ``got``'s device a leaf at a time): within an atol when <= it."""
    worst = [float("-inf")]

    def leaf(g, w):
        w = w.to(g.device).float()
        worst[0] = max(worst[0], float(((g.float() - w).abs() - rtol * w.abs()).max()))

    T.tree_map(leaf, got, want)
    return worst[0]


def tree_equal(torch, T, a, b):
    same = [True]
    T.tree_map(lambda x, y: same.__setitem__(0, same[0] and bool(torch.equal(x, y))), a, b)
    return same[0]


def train_pair(torch, T, TR, tcfg, params):
    """``tcfg`` trained on the card and on the CPU from copies of
    ``params`` (on the card): {device: (losses, trainer)}."""
    runs = {}
    for dev in (DEV, "cpu"):
        p = T.tree_map(lambda t: t.to(dev, copy=True), params)
        tr = TR.Trainer(tcfg, device=dev, params=p)
        losses, _, _ = record_steps(torch, tr)
        tr.run()
        runs[dev] = (losses, tr)
    return runs


def train_agree(torch, T, O, name, runs, steps):
    """Card against CPU: each step's loss within TRAIN_RTOL, the final
    parameters within TRAIN_RTOL plus 2·lr a step.  Returns the row."""
    (lc, tc_), (lh, th) = runs[DEV], runs["cpu"]
    check(all(map(math.isfinite, lc)), f"14a {name}: a loss is not finite: {lc}")
    err = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    check(err <= TRAIN_RTOL, f"14a {name}: card losses {lc} against cpu {lh}: rel err {err}")
    atol = 2 * sum(train_lrs(O, steps))
    excess = tree_excess(torch, T, tc_.params, th.params, TRAIN_RTOL)
    check(excess <= atol, f"14a {name}: parameters differ by {excess} beyond rtol "
                          f"{TRAIN_RTOL} (atol {atol})")
    return dict(losses=lc, cpu_losses=lh, max_rel_err=err, param_excess=excess, atol=atol)


def train_small(torch, np, T, L, O, TR, cfgs):
    """14a: each config trained on the card and on the CPU from the same
    weights; the trainer test's config also with compressed gradients and
    crashed at step 3 and resumed on the card."""
    rows, loop = {}, train_loop_cfg(T, L)
    for cfg in cfgs + (loop,):
        tcfg = TR.TrainerConfig(model=cfg, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                steps=TRAIN_STEPS, lr_peak=TRAIN_LR_PEAK)
        params = T.init(torch.Generator(device=DEV).manual_seed(61), cfg, device=DEV)
        runs = train_pair(torch, T, TR, tcfg, params)
        rows[cfg.name] = train_agree(torch, T, O, cfg.name, runs, TRAIN_STEPS)
        print(f"14a {cfg.name}: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
              f"card losses {runs[DEV][0]} == cpu within {rows[cfg.name]['max_rel_err']} "
              f"(limit {TRAIN_RTOL}); parameters within rtol {TRAIN_RTOL} + "
              f"{rows[cfg.name]['param_excess']} (atol {rows[cfg.name]['atol']})", flush=True)
    full_loss, full = runs[DEV][0][-1], runs[DEV][1]

    comp = train_pair(torch, T, TR, dataclasses.replace(tcfg, compress_grads=True), params)
    rows["compressed"] = train_agree(torch, T, O, "compressed", comp, TRAIN_STEPS)
    print(f"14a compressed gradients ({loop.name}): card losses {comp[DEV][0]} == cpu within "
          f"{rows['compressed']['max_rel_err']}", flush=True)

    directory = ROOT / "build" / f"chip_train_{os.getpid()}"
    shutil.rmtree(directory, ignore_errors=True)
    try:
        crash = dataclasses.replace(tcfg, steps=3, ckpt_dir=str(directory), ckpt_every=3)
        TR.Trainer(crash, device=DEV, params=T.tree_map(torch.clone, params)).run()
        resumed = TR.Trainer(dataclasses.replace(crash, steps=TRAIN_STEPS), device=DEV)
        check(resumed.step_num == 3, f"14a resume: resumed at step {resumed.step_num}, not 3")
        loss = float(resumed.run()["loss"])
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    err = abs(loss - full_loss) / abs(full_loss)
    check(err <= TRAIN_RTOL, f"14a resume: final loss {loss} against the uninterrupted "
                             f"{full_loss} (rel err {err})")
    bitwise = loss == full_loss and tree_equal(torch, T, resumed.params, full.params)
    rows["resume"] = dict(loss=loss, uninterrupted=full_loss, rel_err=err, bitwise=bitwise)
    print(f"14a resume on the card: crashed at step 3 and resumed to {TRAIN_STEPS}: final loss "
          f"{loss} against the uninterrupted {full_loss} (rel err {err}, limit {TRAIN_RTOL}); "
          f"bitwise {bitwise}", flush=True)
    return rows


def grad_norm_spy(T, O):
    """Wrap ``T.value_and_grad`` (``make_train_step`` looks it up at each
    call; ``T`` is ``models.transformer`` or ``configs.gnn_common``): each
    call's gradient global norm is appended to the returned list.  Returns
    (norms, undo)."""
    norms, real = [], T.value_and_grad

    def spy(*a, **kw):
        out = real(*a, **kw)
        norms.append(float(O.global_norm(out[1])))
        return out

    T.value_and_grad = spy
    return norms, lambda: setattr(T, "value_and_grad", real)


def train_wide(torch, np, T, O, data, cfg, card):
    """14b: one ``make_train_step`` step at danube's full width, cut to
    TRAIN_WIDE_LAYERS layers, f32, on the card and on the CPU from the same
    parameters and AdamW state: loss, gradient norm, parameters."""
    cfgw = dataclasses.replace(cfg, n_layers=TRAIN_WIDE_LAYERS, dtype="float32")
    params = T.init(torch.Generator(device=DEV).manual_seed(71), cfgw, device=DEV)
    host = T.tree_map(lambda t: t.to("cpu", copy=True), params)
    batch = data.TokenPipeline(cfg.vocab_size, TRAIN_WIDE_SEQ, 1, seed=72).batch(0)
    step = T.make_train_step(cfgw, lr_peak=TRAIN_LR_PEAK, total_steps=TRAIN_STEPS)
    norms, undo = grad_norm_spy(T, O)
    out, walls = {}, {}
    try:
        for dev, p in ((DEV, params), ("cpu", host)):
            b = {k: v.to(dev) for k, v in batch.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, _, m = step(p, O.adamw_init(p), b)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            walls[dev] = time.perf_counter() - t0
            out[dev] = (loss, float(m["lr"]), p)
    finally:
        undo()
    (lc, lr, pc), (lh, _, ph) = out[DEV], out["cpu"]
    err = abs(lc - lh) / abs(lh)
    check(math.isfinite(lc) and err <= TRAIN_RTOL,
          f"14b: card loss {lc} against cpu {lh} (rel err {err}, limit {TRAIN_RTOL})")
    nerr = abs(norms[0] - norms[1]) / norms[1]
    check(nerr <= TRAIN_NORM_RTOL, f"14b: gradient norm {norms[0]} against cpu {norms[1]} "
                                   f"(rel err {nerr}, limit {TRAIN_NORM_RTOL})")
    excess = tree_excess(torch, T, pc, ph, TRAIN_RTOL)
    check(excess <= 2 * lr, f"14b: parameters differ by {excess} beyond rtol {TRAIN_RTOL} "
                            f"(atol {2 * lr})")
    row = dict(layers=TRAIN_WIDE_LAYERS, tokens=TRAIN_WIDE_SEQ, params=sum(
        v.numel() for v in flat_leaves(params)), loss=lc, cpu_loss=lh, loss_rel_err=err,
        grad_norm=norms[0], cpu_grad_norm=norms[1], norm_rel_err=nerr, lr=lr,
        param_excess=excess, card_s=walls[DEV], cpu_s=walls["cpu"])
    print(f"14b h2o-danube-3-4b width, depth cut to {TRAIN_WIDE_LAYERS} of {cfg.n_layers} "
          f"layers, f32 ({row['params']} parameters) on {card}: one step of 1 x "
          f"{TRAIN_WIDE_SEQ} tokens, loss {lc} against cpu {lh} (rel err {err}, limit "
          f"{TRAIN_RTOL}); gradient norm {norms[0]} against {norms[1]} (rel err {nerr}, "
          f"limit {TRAIN_NORM_RTOL}); parameters within rtol {TRAIN_RTOL} + {excess} "
          f"(atol {2 * lr}); card {walls[DEV]} s, cpu {walls['cpu']} s", flush=True)
    return row


def flat_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in flat_leaves(v)]
    return [tree]


def bit_digest(torch, tree):
    """(sum, sum of squares) of every leaf's bit patterns, int64 with
    wrap-around, on the card: equal digests of two states mean equal bits
    for any difference a rerun could make."""
    acc = torch.zeros(2, dtype=torch.int64, device=DEV)
    for t in flat_leaves(tree):
        flat = t.reshape(-1).view({2: torch.int16, 4: torch.int32}[t.element_size()])
        for c in flat.split(1 << 26):
            c = c.to(torch.int64)
            acc[0] += c.sum()
            acc[1] += (c * c).sum()
    return tuple(acc.tolist())


TRAIN_OP_FAMILIES = (("gemm", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
                     ("softmax", ("SoftMax",)), ("copy", ("copy",)),
                     ("reduce", ("reduce", "Reduce")),
                     ("index", ("index", "scatter", "gather", "sort", "Sort")))


def train_op_family(key):
    """A device op's family by its kernel name; "elementwise" otherwise."""
    return next((fam for fam, frags in TRAIN_OP_FAMILIES if any(f in key for f in frags)),
                "elementwise")


def train_full(torch, np, T, O, TR, cfg, card):
    """14c: danube FULL (bf16, every layer) trained TRAIN_FULL_STEPS steps
    through ``Trainer`` at TRAIN_FULL_BATCH x TRAIN_FULL_SEQ tokens: losses,
    step walls against the 6·N·tokens bound on the bf16 tensor cores,
    peak memory, the bf16 weights that changed; step 0 run twice from
    copies of the initial state; step 1 timed in two parts (gradient,
    AdamW); step 2 under the profiler."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tcfg = TR.TrainerConfig(model=cfg, global_batch=TRAIN_FULL_BATCH, seq_len=TRAIN_FULL_SEQ,
                            steps=TRAIN_FULL_STEPS, lr_peak=TRAIN_LR_PEAK, seed=81)
    t0 = time.perf_counter()
    tr = TR.Trainer(tcfg, device=DEV)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    init = T.tree_map(lambda t: t.to("cpu", copy=True), tr.params)
    losses, walls, real_step = record_steps(torch, tr)
    t0 = time.perf_counter()
    tr.run()
    t_run = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(all(map(math.isfinite, losses)), f"14c: a loss is not finite: {losses}")
    changed = [0]
    T.tree_map(lambda p, h: changed.__setitem__(0, changed[0] + int(
        (p != h.to(DEV)).sum())), tr.params, init)
    n_params = sum(t.numel() for t in flat_leaves(init))

    # step 0 twice, each from the initial state (the parameters' host copy,
    # zeroed moments, step 0)
    batch0 = {k: v.to(DEV) for k, v in tr.pipeline.batch(0).items()}
    digests = []
    for _ in range(2):
        T.tree_map(lambda p, h: p.copy_(h), tr.params, init)
        opt = O.AdamWState(step=torch.zeros((), dtype=torch.int32, device=DEV),
                           mu=T.tree_map(torch.Tensor.zero_, tr.opt.mu),
                           nu=T.tree_map(torch.Tensor.zero_, tr.opt.nu))
        p, opt, m = real_step(tr.params, opt, batch0)
        digests.append((float(m["loss"]), bit_digest(torch, p), bit_digest(torch, opt.mu),
                        bit_digest(torch, opt.nu)))
    tr.opt = opt
    repeats = digests[0] == digests[1]

    # step 1 split: the loss and its gradient, then the AdamW update
    batch = {k: v.to(DEV) for k, v in tr.pipeline.batch(1).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, grads = T.value_and_grad(tr.params, cfg, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    lr = O.cosine_schedule(tr.opt.step, 100, TRAIN_FULL_STEPS, TRAIN_LR_PEAK)
    tr.params, tr.opt = O.adamw_update(grads, tr.opt, tr.params, lr)
    torch.cuda.synchronize()
    split = dict(grad_ms=(t1 - t0) * 1e3, adamw_ms=(time.perf_counter() - t1) * 1e3)
    del grads

    # one step under the profiler: the ten largest device ops, and each
    # family's device time
    batch = {k: v.to(DEV) for k, v in tr.pipeline.batch(2).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events, err = profiled(torch, lambda: real_step(tr.params, tr.opt, batch))
    prof_wall = (time.perf_counter() - t0) * 1e3
    ops = sorted(((ev.key, ev.count, (getattr(ev, "self_device_time_total", 0) or 0) / 1e3)
                  for ev in events or ()), key=lambda r: -r[2])
    device_ms = sum(r[2] for r in ops)
    check(err is None and device_ms > 0, f"14c: the profiler recorded no device time ({err})")
    families = {}
    for key, calls, ms in ops:
        fam = train_op_family(key)
        row = families.setdefault(fam, dict(calls=0, device_ms=0.0))
        row["calls"] += calls
        row["device_ms"] += ms

    tokens = TRAIN_FULL_BATCH * TRAIN_FULL_SEQ
    n_mm = cfg.param_count - cfg.vocab_size * cfg.d_model     # less the embedding's rows
    flops = 6 * n_mm * tokens
    timed = sorted(walls[1:])
    med = timed[len(timed) // 2]
    row = dict(layers=cfg.n_layers, batch=TRAIN_FULL_BATCH, seq=TRAIN_FULL_SEQ,
               steps=TRAIN_FULL_STEPS, params=n_params, losses=losses, step_ms=walls,
               step_ms_median=med, tokens_per_s=tokens / med * 1e3, step_flops=flops,
               step_bound_ms=flops / H100_BF16_TC_OPS_PER_S * 1e3,
               flop_share=flops / (med / 1e3) / H100_BF16_TC_OPS_PER_S,
               max_memory_allocated=peak, bf16_changed=changed[0], repeats_bitwise=repeats,
               repeat_losses=[d[0] for d in digests], init_s=t_init, run_s=t_run,
               profiled_wall_ms=prof_wall, profiled_device_ms=device_ms, **split,
               families=families,
               top_ops=[dict(op=k, calls=c, device_ms=ms) for k, c, ms in ops[:10]])
    print(f"14c h2o-danube-3-4b FULL ({cfg.n_layers} layers, bf16, {n_params} parameters, "
          f"remat {cfg.remat}) on {card}: {TRAIN_FULL_STEPS} steps of {TRAIN_FULL_BATCH} x "
          f"{TRAIN_FULL_SEQ} tokens, losses {losses}; step ms {walls} (median after the first "
          f"{med}); {row['tokens_per_s']} tokens/s; 6·N·tokens = {flops} FLOP, "
          f"{row['flop_share']} of 989 TFLOP/s (bound {row['step_bound_ms']} ms); "
          f"max_memory_allocated {peak}; bf16 weights changed {changed[0]} of {n_params}; "
          f"step 0 run twice from the initial state: bitwise {repeats} (losses "
          f"{row['repeat_losses']}); init {t_init} s", flush=True)
    print(f"14c step 1 split: loss and gradient {split['grad_ms']} ms, AdamW "
          f"{split['adamw_ms']} ms", flush=True)
    print(f"14c profile of one step: wall {prof_wall} ms, device {device_ms} ms; by family "
          f"{json.dumps(families)}", flush=True)
    for k, c, ms in ops[:10]:
        print(f"  14c op {k[:120]}: {c} calls, {ms} ms", flush=True)
    return row


def train_phase(torch, np, kern, T, L, O, TR, data, small, dense, card):
    """14: the LM trainer.  Its path runs no hand-written kernel (the
    reference's training runs no Pallas kernel): the launch counts must
    not move."""
    t0 = time.perf_counter()
    before = kern.launch_counts()
    small_rows = train_small(torch, np, T, L, O, TR, small)
    torch.cuda.empty_cache()
    wide = train_wide(torch, np, T, O, data, dense, card)
    torch.cuda.empty_cache()
    full = train_full(torch, np, T, O, TR, dense, card)
    torch.cuda.empty_cache()
    check(kern.launch_counts() == before, "14: the trainer launched a kernel")
    row = {"small": small_rows, "wide": wide, "full": full,
           "seconds": time.perf_counter() - t0, "card": card}
    print(f"14: {row['seconds']} s on {card}", flush=True)
    print(json.dumps({"lm_train": row}), flush=True)
    return row


# ---- phase 15: the GNN trainer ----------------------------------------------

GNN_LR = 1e-3                  # make_train_step's rate
GNN_SMALL_STEPS = 5            # 15a: the SMOKE configs on gnn_smoke's batch
GNN_MOL_STEPS = 3              # 15b: BASE widths on the molecule shape
GNN_SAMPLED_STEPS = 5          # 15c: gcn-cora on minibatch_lg
GNN_FULL_STEPS = 5             # 15d: gcn-cora on ogb_products, the card alone
GNN_PROFILED_STEP = 2          # 15d's step under the profiler
# card against CPU: each step's loss relative, the gradients' global norm
# relative, the parameters within rtol plus 2·lr a step (a near-zero
# gradient's sign may differ, and AdamW then moves that weight by ±lr)
GNN_RTOL, GNN_NORM_RTOL = 1e-5, 1e-4


def gnn_run(torch, G, O, step, params, args, steps):
    """``steps`` calls of ``step(params, opt, *args)`` from fresh AdamW
    state: (losses, gradient norms, final params, walls in ms)."""
    opt = O.adamw_init(params)
    norms, undo = grad_norm_spy(G, O)
    losses, walls = [], []
    try:
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, *args)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        undo()
    return losses, norms, params, walls


def gnn_pair(torch, G, C, O, step, params, args, steps):
    """The same steps on the card and on the CPU from copies of
    ``params`` (``args`` moved to each device): {device: gnn_run's}."""
    runs = {}
    for dev in (DEV, "cpu"):
        p = C.tree_map(lambda t: t.to(dev, copy=True), params)
        runs[dev] = gnn_run(torch, G, O, step, p, [x.to(dev) for x in args], steps)
    return runs


def gnn_agree(torch, C, label, runs, steps):
    """Card against CPU: every loss within GNN_RTOL, every gradient norm
    within GNN_NORM_RTOL, the final parameters within GNN_RTOL plus
    2·lr a step.  Returns the row."""
    (lc, nc, pc, wc), (lh, nh, ph, wh) = runs[DEV], runs["cpu"]
    check(all(map(math.isfinite, lc)), f"{label}: a loss is not finite: {lc}")
    err = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    check(err <= GNN_RTOL, f"{label}: card losses {lc} against cpu {lh}: rel err {err}")
    nerr = max(abs(a - b) / b for a, b in zip(nc, nh))
    check(nerr <= GNN_NORM_RTOL, f"{label}: gradient norms {nc} against cpu {nh}: rel err {nerr}")
    excess = max(float(((g.cpu() - w).abs() - GNN_RTOL * w.abs()).max())
                 for g, w in zip(C.leaves(pc), C.leaves(ph)))
    atol = 2 * GNN_LR * steps
    check(excess <= atol, f"{label}: parameters differ by {excess} beyond rtol {GNN_RTOL} "
                          f"(atol {atol})")
    return dict(losses=lc, cpu_losses=lh, loss_rel_err=err, grad_norms=nc, cpu_grad_norms=nh,
                norm_rel_err=nerr, param_excess=excess, atol=atol, step_ms=wc, cpu_step_ms=wh)


def median_after_first(walls):
    timed = sorted(walls[1:])
    return timed[len(timed) // 2]


def gnn_small(torch, G, C, O, archs):
    """15a: each SMOKE config through ``gnn_smoke`` on the card, then
    GNN_SMALL_STEPS steps on its molecule batch, card against CPU."""
    rows = {}
    for model, cfgs in archs:
        cfg = cfgs.SMOKE
        smoke = G.gnn_smoke(model, cfg)
        check(smoke["finite"], f"15a {cfg.name}: gnn_smoke's loss is not finite: {smoke}")
        params = model.init(torch.Generator(device=DEV).manual_seed(91), cfg, device=DEV)
        runs = gnn_pair(torch, G, C, O, G.make_train_step(model, cfg), params,
                        (G.smoke_batch(cfg.d_feat, DEV),), GNN_SMALL_STEPS)
        rows[cfg.name] = row = dict(gnn_smoke=smoke, **gnn_agree(
            torch, C, f"15a {cfg.name}", runs, GNN_SMALL_STEPS))
        print(f"15a {cfg.name}: gnn_smoke loss {smoke['loss']}; {GNN_SMALL_STEPS} steps, card "
              f"losses {row['losses']} == cpu within {row['loss_rel_err']} (limit {GNN_RTOL}); "
              f"gradient norms within {row['norm_rel_err']} (limit {GNN_NORM_RTOL}); "
              f"parameters within rtol {GNN_RTOL} + {row['param_excess']} (atol {row['atol']})",
              flush=True)
    return rows


def gnn_molecule(torch, np, G, C, O, archs, card):
    """15b: each architecture at its BASE width on the molecule shape at
    full size through ``build_gnn_step``, GNN_MOL_STEPS steps, card
    against CPU; step ms and peak memory on the card."""
    info = G.GNN_SHAPE_TABLE["molecule"]
    B, n, m, F = info["batch"], info["n"], info["m"], info["d_feat"]
    rng = np.random.default_rng(101)
    args = [torch.from_numpy(a).to(DEV) for a in (
        rng.normal(size=(B, n, F)).astype(np.float32),
        rng.normal(size=(B, n, 3)).astype(np.float32),
        rng.integers(0, n, (B, m)).astype(np.int32), rng.integers(0, n, (B, m)).astype(np.int32),
        rng.normal(size=(B,)).astype(np.float32))]
    rows = {}
    for model, cfgs in archs:
        cfg = cfgs.cfg_for_shape("molecule", info)
        fn, specs = G.build_gnn_step(model, cfg, "molecule", info)
        check([tuple(s.shape) for s in specs[2:]] == [tuple(a.shape) for a in args],
              f"15b {cfg.name}: specs {[tuple(s.shape) for s in specs[2:]]}")
        params = model.init(torch.Generator(device=DEV).manual_seed(102), cfg, device=DEV)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        runs = gnn_pair(torch, G, C, O, fn, params, args, GNN_MOL_STEPS)
        peak = torch.cuda.max_memory_allocated()
        row = gnn_agree(torch, C, f"15b {cfg.name}", runs, GNN_MOL_STEPS)
        row.update(params=sum(t.numel() for t in C.leaves(params)), max_memory_allocated=peak,
                   held_before=held, step_ms_median=median_after_first(row["step_ms"]))
        rows[cfg.name] = row
        print(f"15b {cfg.name} BASE ({row['params']} parameters) on {card}: {B} graphs x {n} "
              f"nodes x {m} edges, {GNN_MOL_STEPS} steps: step ms {row['step_ms']} (median "
              f"after the first {row['step_ms_median']}; cpu {row['cpu_step_ms']}); losses "
              f"{row['losses']} == cpu within {row['loss_rel_err']}; gradient norms within "
              f"{row['norm_rel_err']}; parameters within rtol {GNN_RTOL} + "
              f"{row['param_excess']} (atol {row['atol']}); max_memory_allocated {peak} ({held} "
              f"held before)", flush=True)
    return rows


def synthetic_csr(np, G, n, m, seed):
    """A seeded CSR of n vertices and m edges, built in numpy: degrees
    from a lognormal law (sigma 2: hubs of hundreds of thousands of edges,
    and vertices of degree 0), destinations uniform.  Padded as the
    sampled cell's arguments: ``row_ptr`` to ``_ru(N + 1)`` entries,
    ``out_deg`` to N = ``_ru(n)``, ``col_idx`` to ``_ru(m)`` (padding:
    degree 0, destination 0).  Returns (row_ptr, col_idx, out_deg)."""
    rng = np.random.default_rng(seed)
    w = rng.lognormal(0.0, 2.0, n)
    deg = np.floor(w * (m / w.sum())).astype(np.int64)
    deg[np.argsort(-w)[: m - int(deg.sum())]] += 1
    N = G._ru(n)
    row_ptr = np.full(G._ru(N + 1), m, np.int32)
    row_ptr[0] = 0
    row_ptr[1: n + 1] = np.cumsum(deg)
    out_deg = np.zeros(N, np.int32)
    out_deg[:n] = deg
    col_idx = np.zeros(G._ru(m), np.int32)
    col_idx[:m] = rng.integers(0, n, m, dtype=np.int32)
    return row_ptr, col_idx, out_deg


def gnn_sampled(torch, np, G, C, O, data, S, gcn, cfgs, card):
    """15c: gcn-cora on minibatch_lg at full scale: a seeded synthetic CSR
    (the card and the CPU hold the same), seeds from GraphBatchPipeline,
    fanouts (15, 10), GNN_SAMPLED_STEPS steps through ``build_gnn_step``'s
    sampled step on both; every step's blocks bitwise, losses within
    GNN_RTOL; sampling and step ms, batch size, peak memory."""
    info = G.GNN_SHAPE_TABLE["minibatch_lg"]
    n, m, fanouts = info["n"], info["m"], info["fanouts"]
    N, M = G._ru(n), G._ru(m)
    cfg = cfgs.cfg_for_shape("minibatch_lg", info)
    fn, specs = G.build_gnn_step(gcn, cfg, "sampled", info)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    row_ptr, col_idx, out_deg = synthetic_csr(np, G, n, m, 111)
    t_csr = time.perf_counter() - t0
    gen = torch.Generator(device=DEV).manual_seed(112)
    feats = torch.randn((N, info["d_feat"]), generator=gen, device=DEV)
    labels = torch.randint(0, info["n_classes"], (N,), generator=gen, device=DEV,
                           dtype=torch.int32)
    host = [torch.from_numpy(a) for a in (row_ptr, col_idx, out_deg)] + [feats.cpu(), labels.cpu()]
    card_args = [t.to(DEV) for t in host[:3]] + [feats, labels]
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    check([tuple(s.shape) for s in specs[2:7]] == [tuple(t.shape) for t in card_args],
          f"15c: specs {[tuple(s.shape) for s in specs[2:7]]}")
    hubs, zeros = int(out_deg.max()), int((out_deg[:n] == 0).sum())

    pipe = data.GraphBatchPipeline(n, info["batch"], seed=113)
    params = gcn.init(torch.Generator(device=DEV).manual_seed(114), cfg, device=DEV)
    state = {}
    for dev in (DEV, "cpu"):
        p = C.tree_map(lambda t: t.to(dev, copy=True), params)
        state[dev] = (p, O.adamw_init(p))
    losses = {DEV: [], "cpu": []}
    sample_ms, step_ms, selfloops = [], [], 0
    for step in range(GNN_SAMPLED_STEPS):
        seeds = pipe.batch(step)
        key = data.pipeline.fold_in(data.pipeline.prng_key(115), step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blocks = S.sample_blocks_raw(*card_args[:3], seeds, key, fanouts)
        torch.cuda.synchronize()
        sample_ms.append((time.perf_counter() - t0) * 1e3)
        want = S.sample_blocks_raw(*host[:3], seeds, key, fanouts)
        same = torch.equal(blocks.seeds.cpu(), want.seeds) and all(
            torch.equal(a.cpu(), b) for a, b in zip(blocks.layers, want.layers))
        check(same, f"15c step {step}: the card's sampled blocks differ from the CPU's")
        for parents in (want.seeds,) + want.layers[:-1]:
            selfloops += int((out_deg[parents.numpy()] == 0).sum())
        for dev, args in ((DEV, card_args), ("cpu", host)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, opt, met = fn(*state[dev], *args, seeds, key)
            losses[dev].append(float(met["loss"]))
            torch.cuda.synchronize()
            if dev == DEV:
                step_ms.append((time.perf_counter() - t0) * 1e3)
            state[dev] = (p, opt)
    peak = torch.cuda.max_memory_allocated()
    lc, lh = losses[DEV], losses["cpu"]
    check(all(map(math.isfinite, lc)), f"15c: a loss is not finite: {lc}")
    err = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    check(err <= GNN_RTOL, f"15c: card losses {lc} against cpu {lh}: rel err {err}")
    batch = C.blocks_to_batch(feats, labels, blocks, fanouts)
    row = dict(n=n, m=m, N=N, M=M, max_degree=hubs, degree_zero=zeros, csr_host_s=t_csr,
               build_s=t_build, batch_nodes=batch.n_nodes, batch_edges=batch.n_edges,
               degree_zero_parents=selfloops, losses=lc, cpu_losses=lh, loss_rel_err=err,
               sample_ms=sample_ms, sample_ms_median=median_after_first(sample_ms),
               step_ms=step_ms, step_ms_median=median_after_first(step_ms),
               max_memory_allocated=peak, held_before=held)
    print(f"15c gcn-cora on minibatch_lg on {card}: synthetic CSR n={n} m={m} (padded {N}, "
          f"{M}; max degree {hubs}, {zeros} vertices of degree 0; numpy {t_csr} s, on the card "
          f"{t_build} s); batch {info['batch']} seeds, fanouts {fanouts}: {batch.n_nodes} nodes, "
          f"{batch.n_edges} edges; {GNN_SAMPLED_STEPS} steps, blocks bitwise card == cpu, "
          f"{selfloops} parents of degree 0 (self loops); losses {lc} == cpu within {err} (limit {GNN_RTOL}); "
          f"sampling ms {sample_ms} (median after the first {row['sample_ms_median']}); step ms "
          f"(sampling included) {step_ms} (median after the first {row['step_ms_median']}); "
          f"max_memory_allocated {peak} ({held} held before)", flush=True)
    return row


def gnn_full(torch, G, C, O, gcn, cfgs, card):
    """15d: gcn-cora on ogb_products full-batch at full scale, the card
    alone: src, dst and features from a seeded generator on the card,
    padding masked as in the cell; GNN_FULL_STEPS steps, step
    GNN_PROFILED_STEP under the profiler; step ms against the byte bound."""
    info = G.GNN_SHAPE_TABLE["ogb_products"]
    n, m = info["n"], info["m"]
    N, M = G._ru(n), G._ru(m)
    cfg = cfgs.cfg_for_shape("ogb_products", info)
    fn, specs = G.build_gnn_step(gcn, cfg, "full", info)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    gen = torch.Generator(device=DEV).manual_seed(121)
    i32 = torch.int32
    src = torch.randint(0, n, (M,), generator=gen, device=DEV, dtype=i32)
    dst = torch.randint(0, n, (M,), generator=gen, device=DEV, dtype=i32)
    src[m:] = N - 1                # padding edges on a padding vertex, masked
    dst[m:] = N - 1
    args = (torch.randn((N, info["d_feat"]), generator=gen, device=DEV),
            torch.zeros((N, 3), device=DEV), src, dst,
            torch.randint(0, info["n_classes"], (N,), generator=gen, device=DEV, dtype=i32),
            torch.arange(N, device=DEV) < n, torch.arange(M, device=DEV) < m)
    check([(tuple(s.shape), s.dtype) for s in specs[2:]] == [(tuple(a.shape), a.dtype)
                                                             for a in args],
          "15d: the arguments do not match build_gnn_step's specs")
    params = gcn.init(torch.Generator(device=DEV).manual_seed(122), cfg, device=DEV)
    opt = O.adamw_init(params)
    losses, walls, events, err = [], [], None, None
    for step in range(GNN_FULL_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if step == GNN_PROFILED_STEP:
            out = []
            events, err = profiled(torch, lambda: out.append(fn(params, opt, *args)))
            params, opt, met = out[0]
        else:
            params, opt, met = fn(params, opt, *args)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    check(all(map(math.isfinite, losses)), f"15d: a loss is not finite: {losses}")
    ops = sorted(((ev.key, ev.count, (getattr(ev, "self_device_time_total", 0) or 0) / 1e3)
                  for ev in events or ()), key=lambda r: -r[2])
    device_ms = sum(r[2] for r in ops)
    check(err is None and device_ms > 0, f"15d: the profiler recorded no device time ({err})")
    # the least traffic: per layer and direction (forward, backward), src and
    # dst read once and a width-w f32 row gathered and scattered per edge (w =
    # min(d_in, d_out) = d_hidden, the aggregate-in-the-narrower-width order),
    # and the features read once
    width = cfg.d_hidden
    nbytes = cfg.n_layers * 2 * M * (4 + 4 + 2 * 4 * width) + N * info["d_feat"] * 4
    bound = nbytes / H100_BYTES_PER_S * 1e3
    timed = [w for i, w in enumerate(walls) if i not in (0, GNN_PROFILED_STEP)]
    med = sorted(timed)[len(timed) // 2]
    row = dict(n=n, m=m, N=N, M=M, losses=losses, step_ms=walls, step_ms_median=med,
               bound_bytes=nbytes, bound_ms=bound, bound_share=bound / med,
               bound_formula="n_layers * 2 * M * (4 + 4 + 2 * 4 * d_hidden) + N * d_feat * 4",
               max_memory_allocated=peak, held_before=held, profiled_step=GNN_PROFILED_STEP,
               profiled_device_ms=device_ms, profiled_share_of_step=device_ms / med,
               top_ops=[dict(op=k, calls=c, device_ms=ms) for k, c, ms in ops[:10]])
    print(f"15d gcn-cora on ogb_products full batch on {card}: N={N} M={M} (n={n}, m={m}), "
          f"{GNN_FULL_STEPS} steps, losses {losses}; step ms {walls} (median of the steps "
          f"neither first nor profiled {med}); byte bound {nbytes} B = {bound} ms "
          f"({row['bound_formula']}), {row['bound_share']} of it reached; max_memory_allocated "
          f"{peak} ({held} held before); profiled step {GNN_PROFILED_STEP}: device {device_ms} "
          f"ms ({row['profiled_share_of_step']} of the median step)", flush=True)
    for k, c, ms in ops[:10]:
        print(f"  15d op {k[:120]}: {c} calls, {ms} ms", flush=True)
    return row


def gnn_phase(torch, np, kern, G, C, O, data, S, archs, card):
    """15: the GNN trainer.  Its path runs no hand-written kernel (the
    reference's GNNs run no Pallas kernel): the launch counts must not
    move."""
    t0 = time.perf_counter()
    before = kern.launch_counts()
    small = gnn_small(torch, G, C, O, archs)
    molecule = gnn_molecule(torch, np, G, C, O, archs, card)
    gcn, gcn_cfgs = archs[0]
    sampled = gnn_sampled(torch, np, G, C, O, data, S, gcn, gcn_cfgs, card)
    torch.cuda.empty_cache()
    full = gnn_full(torch, G, C, O, gcn, gcn_cfgs, card)
    torch.cuda.empty_cache()
    check(kern.launch_counts() == before, "15: the GNN trainer launched a kernel")
    row = {"small": small, "molecule": molecule, "sampled": sampled, "full": full,
           "seconds": time.perf_counter() - t0, "card": card}
    print(f"15: {row['seconds']} s on {card}", flush=True)
    print(json.dumps({"gnn_train": row}), flush=True)
    return row


# ---- phase 16: MIND and the dry run's account on meta tensors ---------------

MIND_SMALL_STEPS = 5           # 16a: SMOKE, card against CPU
MIND_SMALL_BATCH = 32
MIND_SMALL_K = 20              # 16a: top k of a 72-candidate slate (16 repeated)
MIND_SCORE_TOL = 1e-5          # scores: of the row's largest |score|
MIND_PAD_SHARE = 0.1           # history slots that hold pad_id
MIND_REPS = 5                  # 16b: timed calls after one warm-up (median)
MIND_BULK_CHECK_ROWS = 1024    # 16b: serve_bulk rows re-scored on the CPU
MIND_CHECK_BATCH, MIND_CHECK_STEPS = 4096, 3   # 16c: card against CPU, full table
MIND_TRAIN_STEPS = 5           # 16c: steps at MIND_TRAIN_BATCH
# 16c: train_batch's B = 65,536 halved: a step at 65,536 asks for a further
# 16 GiB with 67.6 GiB allocated and runs out of the card's 80 GB
MIND_TRAIN_BATCH = 32_768


def mind_batch(torch, np, cfg, B, seed):
    """B histories (a MIND_PAD_SHARE of their slots pad_id) and targets
    from numpy seed ``seed``, as host int32 tensors."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, cfg.n_items, (B, cfg.hist_len), dtype=np.int32)
    hist[rng.random(hist.shape) < MIND_PAD_SHARE] = cfg.pad_id
    target = rng.integers(1, cfg.n_items, B, dtype=np.int32)
    return {"hist": torch.from_numpy(hist), "target": torch.from_numpy(target)}


def scores_agree(label, got, want):
    """Card scores against CPU scores: each within MIND_SCORE_TOL of its
    row's largest |score| (finite columns only).  Returns the worst."""
    got = got.cpu()
    scale = want.abs().amax(dim=1, keepdim=True)
    worst = float(((got - want).abs() / scale).max())
    check(worst <= MIND_SCORE_TOL, f"{label}: scores differ by {worst} of the row's largest "
                                   f"|score| (limit {MIND_SCORE_TOL})")
    return worst


def topk_agree(torch, label, got_idx, want_idx, want_scores):
    """Top-k slate positions, card against CPU: equal, or where they differ
    the CPU's scores of the two positions within MIND_SCORE_TOL of the
    row's largest |score| (a near tie).  Such places are printed and
    returned."""
    got_idx = got_idx.cpu()
    finite = torch.where(torch.isfinite(want_scores), want_scores, 0.0)
    scale = finite.abs().amax(dim=1)
    places = []
    for r, j in torch.nonzero(got_idx != want_idx).tolist():
        a, b = int(got_idx[r, j]), int(want_idx[r, j])
        gap = float((want_scores[r, a] - want_scores[r, b]).abs() / scale[r])
        places.append(dict(row=r, rank=j, card=a, cpu=b, gap=gap))
        check(gap <= MIND_SCORE_TOL, f"{label}: rank {j} of row {r}: card position {a}, cpu {b}, "
                                     f"scores {gap} of the row's largest apart")
    if places:
        print(f"{label}: top-k positions differ at {len(places)} near-tied places: "
              f"{json.dumps(places[:10])}", flush=True)
    return places


def mind_small(torch, np, G, C, O, M, MC):
    """16a: mind_smoke on the card; SMOKE from a CPU init trained
    MIND_SMALL_STEPS steps on both devices; then the card's trained
    weights scored and retrieved on both."""
    cfg = MC.SMOKE
    smoke = MC.mind_smoke()
    check(smoke["finite"], f"16a: mind_smoke is not finite: {smoke}")
    params = M.init(torch.Generator().manual_seed(161), cfg, device="cpu")
    batch = mind_batch(torch, np, cfg, MIND_SMALL_BATCH, 162)
    step = MC.make_train_step(cfg)
    runs = {}
    for dev in (DEV, "cpu"):
        p = {k: v.to(dev, copy=True) for k, v in params.items()}
        runs[dev] = gnn_run(torch, G, O, step, p, [{k: v.to(dev) for k, v in batch.items()}],
                            MIND_SMALL_STEPS)
    row = gnn_agree(torch, C, "16a mind-smoke", runs, MIND_SMALL_STEPS)
    trained = runs[DEV][2]
    base = torch.from_numpy(np.random.default_rng(163).integers(0, cfg.n_items, 56,
                                                                 dtype=np.int32))
    slate = torch.cat([base, base[:16]])
    out = {}
    for dev in (DEV, "cpu"):
        p = {k: v.to(dev) for k, v in trained.items()}
        hist, s = batch["hist"].to(dev), slate.to(dev)
        scores = M.serve_scores(p, cfg, hist, s)
        _, ids = M.retrieval(p, cfg, hist, s, top_k=MIND_SMALL_K)
        _, idx = M.top_k_stable(scores, MIND_SMALL_K)
        check(torch.equal(ids, s[idx]), f"16a: retrieval's ids on {dev} are not the top slate's")
        out[dev] = (scores, idx)
    row["score_err"] = scores_agree("16a serve_scores", out[DEV][0], out["cpu"][0])
    row["topk_near_ties"] = topk_agree(torch, "16a retrieval", out[DEV][1], out["cpu"][1],
                                       out["cpu"][0])
    row["mind_smoke"] = smoke
    print(f"16a mind-smoke: mind_smoke {smoke}; {MIND_SMALL_STEPS} steps, card losses "
          f"{row['losses']} == cpu within {row['loss_rel_err']} (limit {GNN_RTOL}); gradient "
          f"norms within {row['norm_rel_err']}; parameters within rtol {GNN_RTOL} + "
          f"{row['param_excess']} (atol {row['atol']}); scores within {row['score_err']} of "
          f"the row's largest (limit {MIND_SCORE_TOL}); top {MIND_SMALL_K} positions equal but "
          f"{len(row['topk_near_ties'])} near ties", flush=True)
    return row


def meta_like(torch, tree):
    return {k: torch.empty_like(v, device="meta") for k, v in tree.items()}


def timed_calls(torch, fn, reps=MIND_REPS):
    """(warm-up call's output, median ms of ``reps`` timed calls (host
    clock to synchronize), every timed ms, the warm-up's peak bytes above
    what was allocated before it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return out, sorted(walls)[reps // 2], walls, peak


def serve_bound(torch, dryrun, M, cfg, params, hist, slate, out_bytes, fn):
    """(bound ms, by, bytes, FLOPs) of one scoring call: the distinct table
    rows it gathers, the other parameters, the ids and the output once
    over the memory rate, against its matrix products' FLOPs (counted on
    meta tensors of the same shapes) over the f32 rate."""
    rows = torch.unique(torch.cat([hist.reshape(-1), slate])).numel()
    d = cfg.embed_dim
    small = sum(v.numel() * 4 for k, v in params.items() if k != "embed")
    nbytes = rows * d * 4 + small + (hist.numel() + slate.numel()) * 4 + out_bytes
    flops = dryrun.account(fn, (meta_like(torch, params), torch.empty_like(hist, device="meta"),
                                torch.empty_like(slate, device="meta")))[0]
    t, by = bound_ms(nbytes, flops)
    return t, by, nbytes, flops


def mind_full(torch, np, M, MC, dryrun, card):
    """16b: FULL on the card: serve_p99 card against CPU, serve_bulk with
    MIND_BULK_CHECK_ROWS rows re-scored on the CPU, retrieval_cand card
    against CPU.  Returns (rows, card params, host copy)."""
    cfg = MC.FULL
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = M.init(torch.Generator(device=DEV).manual_seed(164), cfg, device=DEV)
    host = {k: v.cpu() for k, v in params.items()}
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    rng = np.random.default_rng(165)
    rows = {}
    for shape, seed in (("serve_p99", 166), ("serve_bulk", 167)):
        B, C = MC.SHAPES[shape]["batch"], MC.SHAPES[shape]["slate"]
        hist = mind_batch(torch, np, cfg, B, seed)["hist"]
        slate = torch.from_numpy(rng.integers(0, cfg.n_items, C, dtype=np.int32))
        hist_d, slate_d = hist.to(DEV), slate.to(DEV)

        def fn(p=params, h=hist_d, c=slate_d):
            return M.serve_scores(p, cfg, h, c)

        scores, ms, walls, peak = timed_calls(torch, fn)
        if shape == "serve_p99":
            checked = B
            err = scores_agree(f"16b {shape}", scores, M.serve_scores(host, cfg, hist, slate))
        else:
            sel = torch.from_numpy(np.sort(rng.choice(B, MIND_BULK_CHECK_ROWS, replace=False)))
            checked = MIND_BULK_CHECK_ROWS
            err = scores_agree(f"16b {shape}", scores[sel.to(DEV)],
                               M.serve_scores(host, cfg, hist[sel], slate))
        check(bool(torch.isfinite(scores).all()), f"16b {shape}: non-finite scores")
        t, by, nbytes, flops = serve_bound(
            torch, dryrun, M, cfg, params, hist_d, slate_d, scores.numel() * 4,
            lambda p, h, c: M.serve_scores(p, cfg, h, c))
        rows[shape] = dict(batch=B, slate=C, ms=ms, walls=walls, peak_bytes=peak,
                           rows_checked=checked, score_err=err, bound_ms=t, bound_by=by,
                           bound_bytes=nbytes, flops=flops, bound_share=t / ms)
        print(f"16b mind {shape} (B {B}, slate {C}) on {card}: {ms} ms (median of "
              f"{MIND_REPS}: {walls}); peak {peak} B above the held; bound {t} ms by {by} "
              f"({nbytes} B, {flops} FLOP); {t / ms} of it; {checked} rows against the CPU "
              f"within {err} of the row's largest", flush=True)
        del scores, hist_d, slate_d, fn
        torch.cuda.empty_cache()

    # retrieval_cand: the registry cell's step on a slate padded to SHARD_PAD
    info = MC.SHAPES["retrieval_cand"]
    NC = info["n_cands"]
    NC_pad = (NC + MC.SHARD_PAD - 1) // MC.SHARD_PAD * MC.SHARD_PAD
    hist = mind_batch(torch, np, cfg, info["batch"], 168)["hist"]
    slate = torch.zeros(NC_pad, dtype=torch.int32)
    slate[:NC] = torch.from_numpy(rng.integers(0, cfg.n_items, NC, dtype=np.int32))
    hist_d, slate_d = hist.to(DEV), slate.to(DEV)
    step = MC.retrieval_fn(cfg, NC)
    (vals, ids), ms, walls, peak = timed_calls(torch, lambda: step(params, hist_d, slate_d))
    idx = {}
    masked = {}
    for dev, p, h, c in ((DEV, params, hist_d, slate_d), ("cpu", host, hist, slate)):
        sc = M.serve_scores(p, cfg, h, c)
        masked[dev] = torch.where(torch.arange(NC_pad, device=sc.device)[None] < NC, sc,
                                  float("-inf"))
        idx[dev] = M.top_k_stable(masked[dev], MC.RETRIEVAL_K)[1]
    check(torch.equal(ids, slate_d[idx[DEV]]), "16b retrieval_cand: ids are not the top slate's")
    host_vals, host_ids = step(host, hist, slate)
    err = scores_agree("16b retrieval_cand", masked[DEV][:, :NC], masked["cpu"][:, :NC])
    ties = topk_agree(torch, "16b retrieval_cand", idx[DEV], idx["cpu"], masked["cpu"])
    same_ids = bool(torch.equal(ids.cpu(), host_ids))
    check(same_ids or ties, "16b retrieval_cand: ids differ from the CPU's without a near tie")
    t, by, nbytes, flops = serve_bound(
        torch, dryrun, M, cfg, params, hist_d, slate_d[:NC], 2 * MC.RETRIEVAL_K * 4,
        lambda p, h, c: M.serve_scores(p, cfg, h, c))
    rows["retrieval_cand"] = dict(n_cands=NC, padded=NC_pad, k=MC.RETRIEVAL_K, ms=ms,
                                  walls=walls, peak_bytes=peak, ids_equal=same_ids,
                                  near_ties=ties, score_err=err, bound_ms=t, bound_by=by,
                                  bound_bytes=nbytes, flops=flops, bound_share=t / ms)
    print(f"16b mind retrieval_cand (1 x {NC} padded to {NC_pad}, top {MC.RETRIEVAL_K}) on "
          f"{card}: {ms} ms (median of {MIND_REPS}: {walls}); peak {peak} B; bound {t} ms by "
          f"{by}; ids == cpu {same_ids} ({len(ties)} near ties); scores within {err}",
          flush=True)
    del vals, ids, idx, masked, hist_d, slate_d
    torch.cuda.empty_cache()
    rows["init_s"] = t_init
    return rows, params, host


def mind_step_walls(torch, O, step, params, batch, steps):
    """``steps`` steps from fresh AdamW state on the card: (losses, step
    ms), the host clock to synchronize around each."""
    opt = O.adamw_init(params)
    losses, walls = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        walls.append((time.perf_counter() - t0) * 1e3)
    return losses, walls


def mind_train(torch, np, G, C, O, M, MC, dryrun, params, host, card):
    """16c: MIND_CHECK_STEPS steps at MIND_CHECK_BATCH card against CPU
    from copies of the full table, then MIND_TRAIN_STEPS steps at
    MIND_TRAIN_BATCH on the card."""
    cfg = MC.FULL
    step = MC.make_train_step(cfg)
    batch = mind_batch(torch, np, cfg, MIND_CHECK_BATCH, 169)
    runs = {}
    for dev, src in ((DEV, params), ("cpu", host)):
        p = {k: v.clone() for k, v in src.items()}
        runs[dev] = gnn_run(torch, G, O, step, p, [{k: v.to(dev) for k, v in batch.items()}],
                            MIND_CHECK_STEPS)
    check_row = gnn_agree(torch, C, f"16c mind B={MIND_CHECK_BATCH}", runs, MIND_CHECK_STEPS)
    print(f"16c mind B={MIND_CHECK_BATCH}, full table: {MIND_CHECK_STEPS} steps, card losses "
          f"{check_row['losses']} == cpu within {check_row['loss_rel_err']}; gradient norms "
          f"within {check_row['norm_rel_err']}; parameters within rtol {GNN_RTOL} + "
          f"{check_row['param_excess']} (atol {check_row['atol']}); card step ms "
          f"{check_row['step_ms']}, cpu {check_row['cpu_step_ms']}", flush=True)
    del runs, host
    gc.collect()
    torch.cuda.empty_cache()

    B = MIND_TRAIN_BATCH
    batch = {k: v.to(DEV) for k, v in mind_batch(torch, np, cfg, B, 170).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    losses, walls = mind_step_walls(torch, O, step, params, batch, MIND_TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    check(all(map(math.isfinite, losses)), f"16c: a loss is not finite: {losses}")
    med = median_after_first(walls)
    state = sum(v.numel() * 4 for v in params.values())
    nbytes = 2 * 3 * state + sum(v.numel() * 4 for v in batch.values()) + 4
    mparams = meta_like(torch, params)
    flops = dryrun.account(step, (mparams, O.adamw_init(mparams), meta_like(torch, batch)))[0]
    t, by = bound_ms(nbytes, flops)
    row = dict(check=check_row, batch=B, steps=MIND_TRAIN_STEPS, losses=losses,
               step_ms=walls, step_ms_median=med, held_bytes=held, peak_bytes=peak,
               bound_ms=t, bound_by=by, bound_bytes=nbytes, flops=flops, bound_share=t / med)
    print(f"16c mind train_batch B = {B} (of {MC.SHAPES['train_batch']['batch']}) on {card}: "
          f"losses {losses}; step ms {walls} (median after the first {med}); peak {peak} B "
          f"({held} held before); bound {t} ms by {by} ({nbytes} B, {flops} FLOP); {t / med} "
          f"of it", flush=True)
    return row


def account_phase(torch, dryrun, LC, T, O, mind_shapes, dn_full, full_row):
    """16d: the dry run's records for mind's four cells and danube's
    train_4k, then the meta account of 14c's exact step."""
    rows = {}
    for arch, shape in [("mind", s) for s in mind_shapes] + [("h2o-danube-3-4b", "train_4k")]:
        rec = dryrun.run_cell(arch, shape, False, save=False)
        rows[f"{arch}/{shape}"] = dict(totals=rec["totals"], per_device=rec["per_device"],
                                       roofline=rec["roofline"], account_s=rec["account_s"])
    cfg = dn_full
    params = LC.param_abstract(cfg)
    batch = {k: torch.empty((TRAIN_FULL_BATCH, TRAIN_FULL_SEQ), dtype=torch.int32,
                            device="meta") for k in ("tokens", "labels")}
    step = T.make_train_step(cfg, lr_peak=TRAIN_LR_PEAK, total_steps=TRAIN_FULL_STEPS)
    t0 = time.perf_counter()
    flops, nbytes, ops, _ = dryrun.account(step, (params, O.adamw_init(params), batch))
    t_acc = time.perf_counter() - t0
    tokens = TRAIN_FULL_BATCH * TRAIN_FULL_SEQ
    six_n = 6 * (cfg.param_count - cfg.vocab_size * cfg.d_model) * tokens
    step_ms = full_row["step_ms_median"] if full_row else None
    row = dict(flops=flops, bytes=nbytes, aten_ops=ops, six_n_tokens=six_n,
               ratio=flops / six_n, step_ms=step_ms, account_s=t_acc,
               tflops_per_s=flops / (step_ms / 1e3) / 1e12 if step_ms else None)
    rows["14c_step"] = row
    print(f"16d the step 14c times (danube FULL, {TRAIN_FULL_BATCH} x {TRAIN_FULL_SEQ} tokens, "
          f"remat {cfg.remat}) on meta tensors: {flops} FLOP (6·N·tokens {six_n}; ratio "
          f"{row['ratio']}), {nbytes} B unfused, {ops} aten ops, in {t_acc} s; 14c's measured "
          f"step {step_ms} ms -> {row['tflops_per_s']} TFLOP/s counted", flush=True)
    return rows


def mind_phase(torch, np, kern, G, C, O, M, MC, dryrun, LC, T, dn_full, full_row, card):
    """16: MIND on the card and the dry run's account on meta tensors.  Its
    path runs no hand-written kernel: the launch counts must not move."""
    t0 = time.perf_counter()
    before = kern.launch_counts()
    small = mind_small(torch, np, G, C, O, M, MC)
    serve, params, host = mind_full(torch, np, M, MC, dryrun, card)
    train = mind_train(torch, np, G, C, O, M, MC, dryrun, params, host, card)
    del params, host
    gc.collect()
    torch.cuda.empty_cache()
    account = account_phase(torch, dryrun, LC, T, O, tuple(MC.SHAPES), dn_full, full_row)
    check(kern.launch_counts() == before, "16: MIND or the dry run launched a kernel")
    row = {"small": small, "serve": serve, "train": train, "account": account,
           "seconds": time.perf_counter() - t0, "card": card}
    print(f"16: {row['seconds']} s on {card}", flush=True)
    print(json.dumps({"mind": row}), flush=True)
    return row


# ---- phase 17: the examples, the harness, the f32 flash route ----------------

EXAMPLE_TRAIN_STEPS = 20       # 17d: train_lm at model_100m's full width
EXAMPLE_SERVE_RTOL = LM_SMALL_RTOL   # 17c: 13a's f32 limit, of the row's largest
EXAMPLE_SUITE = "serving"      # 17e: the harness's suite on the card, and its gate
EXAMPLE_GATE = dict(max_frac=0.5, min_qps=5.0, algos="bfs,sssp")   # ci.yml's bounds


def counted(torch, kern, fn):
    """``fn()`` with every kernel's launch count set to 0 just before and
    read just after: ``(result, counts)``."""
    kern.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, kern.launch_counts()


def example_quickstart(torch, kern, qs):
    """17a: quickstart on the card, its launches, and its results and lines
    against the same module's ``--device cpu`` run within phase 5's limits."""
    card, launches = counted(torch, kern, lambda: qs.main([]))
    for k in ("edge_relax", "advance"):
        check(launches[k] > 0, f"17a quickstart: kernel {k} was not launched")
    cpu = qs.main(["--device", "cpu"])
    for name in ("bfs", "sssp", "cc", "pr"):
        compare_runs(torch, f"17a quickstart {name}", (*card[name], 0, 0),
                     (*cpu[name], 0, 0), PR_TOL if name == "pr" else None)
    for got, want in zip(card["lines"], cpu["lines"], strict=True):
        if got == want:
            continue
        # only pagerank's top vertex may part, at a tie within PR_TOL
        check(got.startswith("pr ") and want.startswith("pr "),
              f"17a quickstart: card printed {got!r}, the CPU {want!r}")
        rank = cpu["pr"][0]
        top = int(got.rsplit(" ", 1)[1])
        rtol, atol = PR_TOL
        lim = rtol * float(rank.max()) + atol
        check(float(rank.max() - rank[top]) <= lim,
              f"17a quickstart: top vertex {top} is not within {lim} of the CPU's")
        print(f"17a quickstart: pr's top vertex parts at a tie: {got!r} / {want!r}", flush=True)
    print(f"17a quickstart: card == cpu, launches {json.dumps(launches)}", flush=True)
    return launches


def example_paper_suite(torch, kern, ps):
    """17b: paper_suite --scale small on the card: every oracle check,
    read from run_input's return."""
    res, launches = counted(torch, kern, lambda: ps.main(["--scale", "small"]))
    checks = [(name, r["label"], r["ok"]) for name, rows in res.items() for r in rows]
    failed = [c for c in checks if c[2] is not True]
    check(len(checks) == 21 and not failed, f"17b paper_suite: checks failed: {failed}")
    for k in ("edge_relax", "advance", "intersect"):
        check(launches[k] > 0, f"17b paper_suite: kernel {k} was not launched")
    ms = {name: {r["label"]: r["ms"] for r in rows} for name, rows in res.items()}
    print(f"17b paper_suite: {len(checks)} oracle checks pass, launches "
          f"{json.dumps(launches)}, ms {json.dumps(ms)}", flush=True)
    return launches


def example_serve_lm(torch, kern, serve, sl):
    """17c: serve_lm on the card (its seeded weights), then the same
    weights and requests served on the CPU: each request's tokens equal,
    or parting where the CPU's top two logits lie within
    EXAMPLE_SERVE_RTOL of the row's largest (later ticks follow the
    parted stream and are not compared).  No kernel launches."""
    t0 = time.perf_counter()
    card, launches = counted(torch, kern, lambda: sl.main([]))
    card_s = time.perf_counter() - t0
    check(not any(launches.values()), f"17c serve_lm launched a kernel: {launches}")
    specs = [(r.rid, r.prompt, r.max_new) for r in card["done"]]
    cpu_server = serve.Server(sl.CFG, lm_to(card["server"].params, "cpu"), sl.MAX_BATCH,
                              sl.MAX_SEQ, device="cpu")
    cpu_tokens, cpu_logits = lm_serve(torch, serve, cpu_server, specs)[:2]
    least, parted = math.inf, {}
    for r in card["done"]:
        want = cpu_tokens[r.rid]
        for i, row in enumerate(cpu_logits[r.rid]):
            top = row.topk(2).values
            gap = float(top[0] - top[1]) / float(row.abs().max())
            least = min(least, gap)
            if r.out[i] != want[i]:
                check(gap <= EXAMPLE_SERVE_RTOL,
                      f"17c serve_lm: request {r.rid} parts at tick {i} ({r.out[i]} vs "
                      f"{want[i]}) where the CPU's top-2 gap is {gap} of the row's largest")
                parted[r.rid] = dict(tick=i, gap=gap)
                break
    print(f"17c serve_lm: {len(specs)} requests, card tokens == cpu but {parted}; the "
          f"least CPU top-2 gap {least} of the row's largest (limit {EXAMPLE_SERVE_RTOL}); "
          f"card run {card_s} s", flush=True)
    return dict(requests=len(specs), parted=parted, least_top2_gap=least, seconds=card_s)


def example_train_lm(torch, kern, tl):
    """17d: train_lm --steps EXAMPLE_TRAIN_STEPS at model_100m's full width
    on the card, checkpoints in a temporary directory: finite losses, the
    last below the first; step ms (median after the first, host clock to
    ``synchronize()``), tokens/s, peak memory.  No kernel launches."""
    import tempfile
    walls = []
    real = tl.Trainer

    class Timed(real):
        def _build(self, params):
            super()._build(params)
            step = self._step

            def timed(*state):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(*state)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                return out
            self._step = timed

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tl.Trainer = Timed
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_lm_") as d:
            res, launches = counted(torch, kern, lambda: tl.main(
                ["--steps", str(EXAMPLE_TRAIN_STEPS), "--ckpt", d]))
            saved = res["trainer"].ckpt.latest_step()
    finally:
        tl.Trainer = real
    secs = time.perf_counter() - t0
    losses = res["losses"]
    check(not any(launches.values()), f"17d train_lm launched a kernel: {launches}")
    check(len(losses) == EXAMPLE_TRAIN_STEPS and all(math.isfinite(x) for x in losses),
          f"17d train_lm: losses {losses}")
    check(losses[-1] < losses[0], f"17d train_lm: the loss did not fall: {losses}")
    check(saved == EXAMPLE_TRAIN_STEPS, f"17d train_lm: last snapshot at step {saved}")
    cfg = res["trainer"].cfg
    tokens = cfg.global_batch * cfg.seq_len
    step_ms = median_after_first(walls)
    row = dict(model=cfg.model.name, params=cfg.model.param_count, steps=len(losses),
               tokens_per_step=tokens, first_loss=losses[0], last_loss=losses[-1],
               step_ms=step_ms, first_step_ms=walls[0], tokens_per_s=tokens / step_ms * 1e3,
               max_memory_allocated=torch.cuda.max_memory_allocated(), seconds=secs)
    print(f"17d train_lm: {json.dumps(row)}; losses {losses}", flush=True)
    return row


def example_harness(torch, kern, harness):
    """17e: the harness on EXAMPLE_SUITE on the card, its JSON read back by
    ``benchmarks/ci_gate.py serve`` in process under ci.yml's bounds."""
    import tempfile
    from benchmarks import ci_gate
    with tempfile.TemporaryDirectory(prefix="chip_smoke_harness_") as d:
        path = os.path.join(d, f"BENCH_torch_{EXAMPLE_SUITE}.json")
        t0 = time.perf_counter()
        rc, launches = counted(torch, kern, lambda: harness.main(
            ["--suite", EXAMPLE_SUITE, "--emit-json", path]))
        secs = time.perf_counter() - t0
        check(rc == 0, f"17e harness --suite {EXAMPLE_SUITE} exited {rc}")
        gate = ci_gate.cmd_serve(argparse.Namespace(bench=path, **EXAMPLE_GATE))
        check(gate == 0, f"17e ci_gate serve failed on the card's {EXAMPLE_SUITE} JSON")
    check(launches["edge_relax_lanes"] > 0, "17e harness: edge_relax_lanes was not launched")
    print(f"17e harness: {EXAMPLE_SUITE} in {secs} s, ci_gate serve ok, launches "
          f"{json.dumps(launches)}", flush=True)
    return launches, secs


# 17f: the f32 route of flash attention, (name, bh, S, d, window, causal):
# (a) kernels_bench's inputs (kernel_inputs); (b) train_lm's model_100m
# attention, 16 sequences x 8 heads of 64 at S 256 (examples/train_lm.py);
# (c) h2o-danube-3-4b's heads in f32 at train_4k's length (DANUBE; its
# window of 4096 hides nothing at S 4096) — each timed; then FLASH_SMALL's
# two ragged shapes and a width that is not a multiple of 4 (element-wise
# tile loads in f32), checked only
FLASH_F32_TIMED = (("(a) kernels_bench f32", 2, 256, 64, None, True),
                   ("(b) train_lm model_100m", 16 * 8, 256, 64, None, True),
                   ("(c) h2o-danube-3-4b train_4k f32", DANUBE["n_heads"], 4096,
                    DANUBE["d_head"], DANUBE["sliding_window"], True))
FLASH_F32_CHECKED = FLASH_SMALL + (("width 30, ragged S", 3, 150, 30, None, True),)
FLASH_F32_ROUTE = ("tensor cores: mma.sync m16n8k8 split TF32 (lo.hi + hi.lo + hi.hi), f32 "
                   "accumulators; split-KV merged in a thread-block cluster where the query "
                   "tiles do not fill the card")
# CUDA-event reps of a timed 17f case: 50 where a call is launch-bound
# (tens of microseconds), 5 at (c)
FLASH_F32_REPS_SHORT, FLASH_F32_SHORT_PAIRS = 50, 10**8


def flash_f32_rows(torch, np, kernels_bench, fk, fref):
    """17f: the f32 route of flash attention (``flash_f32_kernel``) at
    FLASH_F32_TIMED's shapes, each against its plain version within
    F32_TOL (atol + rtol) and timed beside it and beside
    ``scaled_dot_product_attention`` in f32 (CUDA events, 50 calls where
    one takes tens of microseconds, else 5), with its bounds: bytes
    16 bh S d, the split's 12 d a pair at the TF32 rate, and 4 d a pair at
    the f32 CUDA-core rate; then FLASH_F32_CHECKED's shapes, checked.
    Each first call must add one to ``launches`` and to ``tc_launches``.
    Its launches compare and are not counted."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEV)
    gen.manual_seed(27)
    rows = []
    cases = [(*c, True) for c in FLASH_F32_TIMED] + [(*c, False) for c in FLASH_F32_CHECKED]
    for name, bh, s, d, window, causal, timed in cases:
        if name.startswith("(a)"):
            (q, k, v), _, _ = kernels_bench.kernel_inputs(DEV, np.random.default_rng(0))
            check(q.shape == (bh, s, d), f"17f: kernels_bench's flash inputs are {q.shape}")
        else:
            q, k, v = (torch.randn((bh, s, d), generator=gen, device=DEV) for _ in range(3))
        kw = dict(causal=causal, window=window)

        def kernel():
            return fk.flash_attention_bhsd(q, k, v, **kw)

        before = fk.flash_attention_bhsd.launches, fk.flash_attention_bhsd.tc_launches
        got = kernel()
        torch.cuda.synchronize()
        check((fk.flash_attention_bhsd.launches, fk.flash_attention_bhsd.tc_launches) ==
              (before[0] + 1, before[1] + 1), f"17f flash f32 {name}: no tensor-core launch "
              f"counted")
        want = fref.flash_attention_plain(q, k, v, **kw)
        err = (got - want).abs()
        check(got.dtype == torch.float32 and got.shape == q.shape and bool(
            torch.isfinite(got).all()) and bool((err <= F32_TOL + F32_TOL * want.abs()).all()),
            f"17f flash f32 {name}: outside {F32_TOL} of its plain version (max err "
            f"{float(err.max())})")
        row = dict(case=name, bh=bh, s=s, d=d, window=window, causal=causal,
                   splits=fk.kv_splits(bh, s, causal, window,
                                       torch.cuda.get_device_properties(0).multi_processor_count),
                   max_abs_err=float(err.max()), route=FLASH_F32_ROUTE)
        del got, want, err
        if timed:
            pairs = attention_pairs(s, window, causal) * bh
            reps = FLASH_F32_REPS_SHORT if pairs < FLASH_F32_SHORT_PAIRS else 5
            check(causal and (window is None or window >= s),
                  f"17f {name}: SDPA's is_causal is not this mask")
            q4, k4, v4 = (t.view(1, bh, s, d) for t in (q, k, v))
            row["library"] = "scaled_dot_product_attention f32, is_causal"
            row["ms"] = cuda_ms(torch, kernel, reps)
            row["library_ms"] = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True), reps)
            row["plain_ms"] = cuda_ms(torch, lambda: fref.flash_attention_plain(q, k, v, **kw))
            row["reps"] = reps
            nbytes = 16 * bh * s * d                # q, k, v read, out written, f32
            row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 12 * d * pairs,
                                                        H100_TF32_TC_OPS_PER_S)
            row.update(bound_bytes_ms=bound_ms(nbytes, 0)[0],
                       bound_split_tf32_ms=bound_ms(0, 12 * d * pairs, H100_TF32_TC_OPS_PER_S)[0],
                       bound_cuda_cores_ms=bound_ms(0, 4 * d * pairs)[0], pairs=pairs,
                       flops=4 * d * pairs, tc_flops=12 * d * pairs,
                       tflops=4 * d * pairs / row["ms"] / 1e9)
        rows.append(row)
        print(f"17f flash f32: {json.dumps(row)}", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


def examples_phase(torch, np, kern, mods, card):
    """17: the four examples and the harness on the card, then the f32
    flash row.  Returns the launches of the examples and the harness."""
    qs, ps, sl, tl, harness, serve, kernels_bench, fk, fref = mods
    t0 = time.perf_counter()
    launches = [example_quickstart(torch, kern, qs), example_paper_suite(torch, kern, ps)]
    serve_row = example_serve_lm(torch, kern, serve, sl)
    torch.cuda.empty_cache()
    train_row = example_train_lm(torch, kern, tl)
    torch.cuda.empty_cache()
    harness_launches, harness_s = example_harness(torch, kern, harness)
    launches.append(harness_launches)
    flash = flash_f32_rows(torch, np, kernels_bench, fk, fref)
    total = {k: sum(x[k] for x in launches) for k in launches[0]}
    row = {"launches": total, "serve_lm": serve_row, "train_lm": train_row,
           "harness": {"suite": EXAMPLE_SUITE, "seconds": harness_s}, "flash_f32": flash,
           "seconds": time.perf_counter() - t0, "card": card}
    print(f"17: {row['seconds']} s on {card}", flush=True)
    print(json.dumps({"examples": row}), flush=True)
    return total


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
    from repro_torch.benchmarks import memtier, serving
    from repro_torch.core import engine as eng
    from repro_torch.core import mesh as tc_mesh
    from repro_torch.core import multisource as ms
    from repro_torch.core import partition, sharded
    from repro_torch.core import faultio, tiered
    from repro_torch.kernels import device_loop as dl
    from repro_torch.kernels import build
    from repro_torch.kernels import graph_ops as gk
    from repro_torch.kernels.crc32 import ops as crc_ops
    from repro_torch.kernels.crc32 import ref as crc_ref
    from repro_torch.kernels.embedding_bag import embedding_bag as ek
    from repro_torch.kernels.embedding_bag import ops as eops
    from repro_torch.kernels.embedding_bag import ref as eref
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.spmm_bsr import ref as sref
    from repro_torch.kernels.spmm_bsr import spmm_bsr as sk
    from repro_torch.configs import deepseek_moe_16b as lm_deepseek
    from repro_torch.configs import h2o_danube3_4b as lm_danube
    from repro_torch.launch import serve as lm_serve_mod
    from repro_torch.launch import train as lm_train_mod
    from repro_torch.models import layers, transformer
    from repro_torch import data as lm_data
    from repro_torch import optim as lm_optim
    from repro_torch.configs import egnn as gnn_egnn
    from repro_torch.configs import gcn_cora as gnn_gcn
    from repro_torch.configs import gnn_common
    from repro_torch.configs import mace as gnn_mace
    from repro_torch.configs import nequip as gnn_nequip
    from repro_torch.graphs import sampler as gnn_sampler
    from repro_torch.models.gnn import common as gnn_c
    from repro_torch.models.gnn import egnn, gcn, mace, nequip
    from repro_torch.configs import lm_common
    from repro_torch.configs import mind as mind_cfg
    from repro_torch.launch import dryrun
    from repro_torch.models.recsys import mind as mind_model
    from repro_torch.benchmarks import run as harness
    from repro_torch.examples import paper_suite, quickstart, serve_lm, train_lm
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

    # 3. the graph: COO arrays generated on the host, copied to the card
    # once and built there
    t0 = time.perf_counter()
    src, dst, n = gen_mod.web_crawl_like(args.communities, 13, 16, 3, seed=0)
    w = gen_mod.random_weights(len(src), seed=1)
    t_gen = time.perf_counter() - t0
    g, gsym = build_pair(torch, tc, "graph", src, dst, n, w, t_gen)
    source = int(np.argmax(np.bincount(src, minlength=n)))
    del src, dst, w
    check(g.device.type == "cuda", "from_coo did not place the graph on the card")
    print(f"graph: n={g.n} m={g.m} n_pad={g.n_pad} m_pad={g.m_pad} sym m={gsym.m} "
          f"source={source}", flush=True)
    if args.communities == 512:
        check_sizes("web", g, gsym, FULL_WEB_SIZES)
    # 3b. the build on the card against the same build on the CPU
    build_check(torch, np, tc, gen_mod)

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
    t_gen = time.perf_counter() - t0
    kg, kgsym = build_pair(torch, tc, "kron", ksrc, kdst, kn, kweights, t_gen)
    t1 = time.perf_counter()
    kg_unw = tc.from_coo(ksrc, kdst, kn, build_csc=True)
    torch.cuda.synchronize()
    t_unw = time.perf_counter() - t1
    ksource = int(np.argmax(kg.out_deg[:kn].cpu().numpy()))
    del ksrc, kdst, kweights
    print(f"kron: scale={args.kron_scale} n={kg.n} m={kg.m} sym m={kgsym.m} "
          f"source={ksource}; unweighted CSR+CSC {t_unw} s; "
          f"{time.perf_counter() - t0} s in all", flush=True)
    if args.kron_scale == 20:
        check_sizes("kron", kg, kgsym, FULL_KRON_SIZES)
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
          f"adjacencies built on the card)", flush=True)

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
        shard_rows, ooc_relax, far, far_ref, crc_row = ooc_phase(
            torch, np, gk, ops, eng, tiered, store, bfs, sssp, cc, pagerank,
            (crc_ops, crc_ref, faultio), g, gsym, source, rng, directory)
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
        crc0 = crc_ops.crc32_async.launches
        resume_launches = resume_phase(torch, np, gk, ops, store, bfs, pagerank, directory,
                                       far, far_ref, g, source,
                                       *cuda_runs["bfs_dd_sparse"][:1],
                                       cuda_runs["bfs_dd_sparse"][1].rounds)
        crc_9f = crc_ops.crc32_async.launches - crc0
        print(f"9f: {time.perf_counter() - t0} s; crc32 launches (this process) {crc_9f}",
              flush=True)
        t0 = time.perf_counter()
        crc0 = crc_ops.crc32_async.launches
        dyn_launches = dynamic_phase(torch, np, gk, ops, store, pagerank, dynamic_bench,
                                     gsym, source,
                                     directory.parent / f"{directory.name}_dynamic")
        crc_9g = crc_ops.crc32_async.launches - crc0
        print(f"9g: {time.perf_counter() - t0} s; crc32 launches {crc_9g}", flush=True)
        check(crc_9f > 0 and crc_9g > 0, "9f or 9g streamed no shard through the crc32 kernel")
        crc_row["launches"] += crc_9f + crc_9g
    finally:
        for d in (directory, directory.parent / f"{directory.name}_dynamic",
                  directory.parent / f"{directory.name}_ckpt"):
            shutil.rmtree(d, ignore_errors=True)

    # 9h. multi-source traversal and the graph query server
    torch.cuda.empty_cache()
    lanes_rows, ms_launches, ms_ref = serving_phase(
        torch, np, tc, gk, ops, fr, ms, serving, bfs, pagerank, gen_mod, g, kg_unw, source,
        ksource, cuda_runs["bfs_dd_sparse"][0])
    torch.cuda.empty_cache()

    # 9i. the multi-device path on a virtual mesh on the card
    mesh_launches = mesh_phase(
        torch, np, gk, ops, (bfs, sssp, cc, kcore, bc, pagerank, tri, ms, tc_mesh, sharded,
                             partition),
        g, gsym, kgsym, source,
        {"bfs_dd_sparse": cuda_runs["bfs_dd_sparse"][0],
         "bfs_dd_sparse(fused=False)": cuda_runs["bfs_dd_sparse(fused=False)"][0],
         "cc_dd_sparse": cuda_runs["cc_dd_sparse"][0],
         "kcore_dd_sparse(k=3)": refs["web"]["kcore_peel(k=3)"][0]},
        refs["kron"]["tc_count"][0], ms_ref)
    del refs, ms_ref
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
    torch.cuda.empty_cache()

    # 13. the LM server: SMOKE configs card against CPU, danube FULL, the
    # window, deepseek-moe at full width
    lm_phase(torch, np, kern, transformer, layers, lm_serve_mod,
             (lm_danube.SMOKE, lm_deepseek.SMOKE), lm_danube.FULL, lm_deepseek.FULL, card)
    torch.cuda.empty_cache()

    # 14. the LM trainer: small configs card against CPU and a resume, danube
    # at full width cut to 2 layers card against CPU, danube FULL
    lm_train = train_phase(torch, np, kern, transformer, layers, lm_optim, lm_train_mod,
                           lm_data, (lm_train_mod.tiny_model(512), lm_danube.SMOKE,
                                     lm_deepseek.SMOKE), lm_danube.FULL, card)
    torch.cuda.empty_cache()

    # 15. the GNN trainer: SMOKE configs card against CPU, BASE widths on the
    # molecule shape card against CPU, gcn-cora on minibatch_lg and on
    # ogb_products at full scale
    gnn_phase(torch, np, kern, gnn_common, gnn_c, lm_optim, lm_data, gnn_sampler,
              ((gcn, gnn_gcn), (egnn, gnn_egnn), (nequip, gnn_nequip), (mace, gnn_mace)), card)
    torch.cuda.empty_cache()

    # 16. MIND at full width (serve_p99, serve_bulk, retrieval_cand, train_batch)
    # and the dry run's account of mind's cells, danube's train_4k and 14c's step
    mind_phase(torch, np, kern, gnn_common, gnn_c, lm_optim, mind_model, mind_cfg, dryrun,
               lm_common, transformer, lm_danube.FULL, lm_train["full"], card)
    torch.cuda.empty_cache()

    # 17. the examples and the harness as a user runs them, then the f32
    # flash route on kernels_bench's inputs
    example_launches = examples_phase(
        torch, np, kern, (quickstart, paper_suite, serve_lm, train_lm, harness,
                          lm_serve_mod, kernels_bench, fk, fref), card)

    # every path's cuda launches: the three graph paths count graph_ops only
    total = {k: sum(path.get(k, 0) for path in (launches, web_launches, kron_launches,
                                                suite_launches, resume_launches,
                                                dyn_launches, ms_launches, mesh_launches,
                                                layer_launches, bench_launches,
                                                example_launches))
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
        entry("edge_relax_lanes", src_file,
              "src/repro/kernels/graph_ops/graph_ops.py:65 (vmapped at "
              "src/repro/core/operators.py:349)",
              max(r["max_abs_err"] for r in lanes_rows), lanes_rows[0]),
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
    # no TPU kernel: the check of each streamed shard's copy that replaces
    # the reference's host zlib on every miss; its launches are the misses
    # of 9c's runs, 9f's (this process) and 9g's
    print(json.dumps({"shard_crc32": dict(
        name="crc32", route="cuda", source="src/repro_torch/kernels/crc32/csrc/crc32.cu",
        replaces="src/repro/core/tiered.py:93 (shard_crc: zlib.crc32 on the host, every "
                 "miss, from _read_shard at :442)", **crc_row)}), flush=True)
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
