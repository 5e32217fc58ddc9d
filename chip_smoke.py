#!/usr/bin/env python3
"""Drive the torch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                  # the full-size run
    python3 chip_smoke.py --communities 8  # a short build-and-check run

Phases, in order; any mismatch or exception ends the script with a
non-zero exit before its last line:

1. environment: the card's name and power limit, torch, CUDA and nvcc;
2. build: the kernels from ``src/repro_torch/kernels/graph_ops/csrc`` into
   the git-ignored ``build/repro_torch``;
3. graph: ``web_crawl_like(512, 13, 16, 3)`` with random weights (about
   4.19 M vertices and 57 M edges), built as CSR+CSC and symmetrized
   (CSR+CSC, for cc and pagerank) on the card;
4. kernels: each kernel against its plain torch version on the card, at
   the main path's shapes — bitwise except float add;
5. small: the quickstart graph on the card against the plain version on
   the CPU (which the CPU tests hold against the JAX package);
6. main path: bfs_dd_sparse (fused and per-round), sssp_delta,
   cc_pointer_jump, cc_dd_sparse, pr_push and pr_pull under the "cuda"
   substrate (launch counts set to 0 just before, read just after), then
   under the plain "torch" substrate on the card; labels and RunStats must
   agree;
7. suite kernels: edge_relax's int32 add (kcore's decrements) under both
   masks at the symmetrized graph's shapes, bitwise; then the low-diameter
   input ``kron(20, 16, seed=1)`` (``table3_suite(10)["kron30"]``, built as
   ``examples/paper_suite.py`` builds it) and ``intersect`` on a chunk of
   each graph's oriented edge list and on a tail chunk of padding, each
   equal to its plain version exactly;
8. paper suite on the web graph: kcore_peel, kcore_dd_sparse (k = 3, and
   k = 64 fused and per-round), core_numbers, bc_brandes and tc_count
   under "cuda" (counts set to 0 just before, read just after), then
   "torch"; the quickstart graph on the card against the CPU first;
9. paper suite on kron: the seven calls of ``paper_suite.run_input``
   under both substrates, the same way.

Agreement: labels, alive masks, core numbers and triangle counts bitwise;
pagerank rtol 1e-4 / atol 1e-10; bc rtol 1e-3 / atol 1e-4 (its sigma and
delta sums are float atomicAdds in an order that changes from run to run;
the tolerance is the suite's own oracle check, and the largest error seen
is printed beside it); RunStats equal except ``substrate`` and, in phase
9, pagerank's round count, which may differ by one round: its
residual-threshold exit reads float sums taken in another order (seen on
kron: 143 rounds under "cuda", 142 under "torch").  Its rounds are all
dense then, each charging m, and that is checked on both sides.

It prints the kernels line (one JSON object) and, last, the device line.
It exits non-zero without a result when no CUDA device is present or when
the repository's sources are not beside it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import namedtuple
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12     # float32 outside the tensor cores
ADD_RTOL_OF_ABS_SUM = 1e-5     # float add: |kernel - plain| <= 1e-5 * sum|terms|
PR_TOL = (1e-4, 1e-10)         # (rtol, atol)
BC_TOL = (1e-3, 1e-4)          # float atomicAdd order in sigma and delta
INTERSECT_CHUNK = 32_768       # tc_count's edge_chunk

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


def bound_ms(nbytes, nops):
    """Least time for the work: the larger of bytes over the memory rate
    and operations over the float32 rate."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = nops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bits(torch, t):
    """Integer view for bitwise comparison (-0.0 and +0.0 differ)."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.to(torch.int32) if t.dtype == torch.bool else t


# ---- phase 4: kernels against their plain versions ---------------------------


def edge_relax_cases(torch, g, gen):
    """(name, kwargs of ops.edge_relax) at the main path's shapes: the graph's
    edge arrays, random vertex data with negatives and signed zeros."""
    dev = g.device
    n_pad, m_pad = g.n_pad, g.m_pad

    def signed(n):
        x = torch.randn(n, generator=gen, device=dev) * 4
        pick = torch.rand(n, generator=gen, device=dev)
        x = torch.where(pick < 0.05, torch.tensor(-0.0, device=dev), x)
        return torch.where((pick >= 0.05) & (pick < 0.1),
                           torch.tensor(0.0, device=dev), x)

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
            out_init=signed(n_pad), kind="min", use_weight=True, vertex_mask=True)),
    ]


def run_edge_relax_case(torch, gk, name, kw):
    kind, use_w, vm = kw["kind"], kw["use_weight"], kw["vertex_mask"]
    args = (kw["src"], kw["dst"], kw["w"], kw["mask"], kw["src_val"], kw["out_init"])

    def kernel():
        return gk.edge_relax(*args, kind=kind, use_weight=use_w, vertex_mask=vm)

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
        max_err = float((got.double() - want.double()).abs().max())

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
    m, n_pad = src.shape[0], args[5].shape[0]
    s = args[5].element_size()
    nbytes = (m * (4 + 4 + (4 if use_w else 0) + (0 if vm else 1))
              + n_pad * ((1 if vm else 0) + 3 * s))
    b_ms, b_by = bound_ms(nbytes, m)
    return dict(case=name, ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=max_err,
                compare="allclose" if float_add else "bitwise")


def advance_cases(torch, g, fr, gen):
    """(name, mask, capacity, budget): a small rung whose budget a hub
    overflows, and cap = n_pad with the largest sparse budget."""
    dev = g.device
    hubs = torch.topk(g.out_deg, 16).indices
    lad_b = fr.ladder_capacities(g.m_pad, g.block_size)
    cap_lad = fr.ladder_capacities(g.n_pad, g.block_size)
    largest = fr.pick_capacity(lad_b[-1] // 2, lad_b)
    small = torch.zeros(g.n_pad, dtype=torch.bool, device=dev)
    pick = torch.randint(0, g.n, (1500,), generator=gen, device=dev)
    small[pick] = True
    small[hubs[:4]] = True
    big = torch.rand(g.n_pad, generator=gen, device=dev) < 0.25
    big[hubs] = True
    return [("small rung, hub overflow", small, cap_lad[1], lad_b[2]),
            ("cap = n_pad, largest sparse budget", big, g.n_pad, largest)]


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
    nbytes = 4 * cap + 4 + 4 * live * 2 + 8 * emitted + 13 * budget + 4
    b_ms, b_by = bound_ms(nbytes, cap + budget * max(1, cap.bit_length()))
    return dict(case=name, ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=0.0, compare="bitwise",
                count=int(f.count), total=total, budget=budget, cap=cap)


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


def intersect_cases(torch, tri, g_web, g_kron):
    """(name, adj, src, dst, row_len, sentinel): the web graph's median
    chunk by candidate mass, kron's heaviest chunk (its hubs), and a tail
    chunk of the web list's last 1,024 edges padded with sentinels."""
    cases = []
    for label, g in (("web", g_web), ("kron", g_kron)):
        adj, osrc, odst, row_len, work, ne = oriented_chunks(torch, tri, g)
        if label == "web":
            c = int(torch.argsort(work)[work.shape[0] // 2])
            name = f"web chunk {c} (median candidate mass)"
        else:
            c = int(torch.argmax(work))
            name = f"kron chunk {c} (heaviest: hubs)"
        sl = slice(c * INTERSECT_CHUNK, (c + 1) * INTERSECT_CHUNK)
        cases.append((name, adj, osrc[sl], odst[sl], row_len, g.sentinel))
        if label == "web":
            k = min(ne, 1024)
            fill = torch.full((INTERSECT_CHUNK - k,), g.sentinel, dtype=torch.int32,
                              device=g.device)
            cases.append(("web tail (1,024 edges, 31,744 padding)", adj,
                          torch.cat([osrc[ne - k:ne], fill]),
                          torch.cat([odst[ne - k:ne], fill]), row_len, g.sentinel))
        print(f"  oriented {label}: ne={ne} dmax={adj.shape[1]} "
              f"chunks={osrc.shape[0] // INTERSECT_CHUNK}", flush=True)
    return cases


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
    t_p = cuda_ms(torch, plain)
    t_l = cuda_ms(torch, lambda: torch.searchsorted(nv, nu))
    del nu, nv
    # bound: src/dst once, each touched row's real entries once, the count;
    # operations: one compare per probe of each candidate's search
    rows = torch.unique(torch.cat([src, dst]).long())
    rows = rows[rows != sentinel]
    lens = row_len[rows]
    nbytes = 8 * src.shape[0] + 4 * int(lens.sum()) + 4
    ls, ld = row_len[src.long()], row_len[dst.long()]
    probes = int((ls * torch.ceil(torch.log2(ld.double() + 1)).long()).sum())
    b_ms, b_by = bound_ms(nbytes, probes)
    return dict(case=name, ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=abs(int(got) - count), compare="bitwise",
                count=count, edges=int((src != sentinel).sum()), dmax=adj.shape[1],
                bytes=nbytes, probes=probes)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--communities", type=int, default=512,
                    help="web_crawl_like communities (the depth; default 512)")
    ap.add_argument("--kron-scale", type=int, default=20,
                    help="log2 vertices of the low-diameter kron input (default 20)")
    args = ap.parse_args()

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
    from repro_torch.kernels import graph_ops as gk
    from repro_torch.kernels.graph_ops import build
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

    # 2. build
    t0 = time.perf_counter()
    build.load("graph_ops")
    print(f"build: {time.perf_counter() - t0} s (nvcc {build.build_seconds} s) "
          f"into {build.BUILD_DIR}", flush=True)

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
    for name, kw in edge_relax_cases(torch, g, rng):
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
    cuda_runs = run_path(torch, main_runs, "cuda", ops)
    launches = gk.launch_counts()
    print(f"main path launches: {json.dumps(launches)}", flush=True)
    for k in ("edge_relax", "advance"):
        check(launches[k] > 0, f"kernel {k} was not launched on the main path")
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
    for case in intersect_cases(torch, tri, gsym, kgsym):
        row = run_intersect_case(torch, gk, *case)
        inter_rows.append(row)
        print("  intersect " + json.dumps(row), flush=True)
    del case  # it holds an oriented adjacency on the card
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
    alive64 = web_cuda["kcore_dd_sparse(k=64)"][0]
    check(bool(alive64.any()) and torch.equal(
        alive64, web_cuda["core_numbers(k_max=64)"][0] >= 64),
        "kcore(64) disagrees with core_numbers")
    check(web_cuda["tc_count"][0] > 0, "no triangles on the web graph")
    print(f"web suite: cuda == torch; kcore(64) keeps {int(alive64.sum())} of {gsym.n}",
          flush=True)
    del web_cuda, web_torch

    # 9. the seven paper benchmarks on the low-diameter kron input
    kron_launches, kron_cuda, kron_torch = run_suite_both(
        torch, gk, ops, "kron suite",
        kron_suite_runs(algos, suite, kg, kg_unw, kgsym, ksource),
        ("edge_relax", "advance", "intersect"))
    bc_hazard(torch, ops, bc, kg, ksource, {"cuda": kron_cuda, "torch": kron_torch})
    check(kron_cuda["tc_count"][0] > 0, "no triangles on kron")
    check(bool(torch.isfinite(kron_cuda["pr_push"][0]).all()), "kron: non-finite ranks")
    print("kron suite: cuda == torch (labels bitwise, pagerank and bc allclose, "
          "RunStats equal but for pagerank's round slack)", flush=True)
    total = {k: launches[k] + web_launches[k] + kron_launches[k] for k in launches}

    src_file = "src/repro_torch/kernels/graph_ops/csrc/graph_ops.cu"
    main_relax, main_adv, main_inter = relax_rows[0], adv_rows[1], inter_rows[0]
    kernels = [
        dict(name="edge_relax", route="cuda", source=src_file,
             replaces="src/repro/kernels/graph_ops/graph_ops.py:65",
             launches=total["edge_relax"], max_abs_err=max(r["max_abs_err"] for r in relax_rows),
             ms=main_relax["ms"], plain_ms=main_relax["plain_ms"],
             bound_ms=main_relax["bound_ms"], bound_by=main_relax["bound_by"],
             library_ms=main_relax["library_ms"]),
        dict(name="advance", route="cuda", source=src_file,
             replaces="src/repro/kernels/graph_ops/graph_ops.py:162",
             launches=total["advance"], max_abs_err=0.0,
             ms=main_adv["ms"], plain_ms=main_adv["plain_ms"],
             bound_ms=main_adv["bound_ms"], bound_by=main_adv["bound_by"],
             library_ms=main_adv["library_ms"]),
        dict(name="intersect", route="cuda", source=src_file,
             replaces="src/repro/kernels/graph_ops/graph_ops.py:117",
             launches=total["intersect"],
             max_abs_err=max(r["max_abs_err"] for r in inter_rows),
             ms=main_inter["ms"], plain_ms=main_inter["plain_ms"],
             bound_ms=main_inter["bound_ms"], bound_by=main_inter["bound_by"],
             library_ms=main_inter["library_ms"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
