"""Wall times of the quickstart main path on one CUDA card, repeated.

    python3 src/repro_torch/tools/time_main_path.py [--src DIR] [--repeat 8]
        [--path-only | --serving | --flash-f32]

Builds the graphs of ``chip_smoke.py``'s main path
(``web_crawl_like(512, 13, 16, 3)`` with random weights as CSR+CSC, and
its symmetrized twin), runs each algorithm of that path once to warm up
(its wall is printed as ``first_ms``: on a tree with rung loops, the run
that captures them), then ``--repeat`` more times in the same order under
the "cuda" substrate, and prints every synchronised wall time with their
min, median and max as one JSON line; on a tree with the device loop,
``captures`` gives each algorithm's captures and their host ms in the
warm-up run, and its captures in the repeats.  ``--path-only`` stops there.  ``--src`` picks the source tree whose ``repro_torch`` is
timed (default: this checkout's ``src``), so that two commits can be
compared on one card in one call: parent, change, change, parent.

It then runs the path once more, and kcore's sparse rounds and peel loops
(``kcore_dd_sparse(k=64)``, ``core_numbers(k_max=64)``) once, under
``chip_smoke.py``'s profile (one line per kernel: calls, total and mean
device ms), and times the tree's ``edge_relax`` and ``advance_frontier``
on ``chip_smoke.py``'s phase-4 cases (CUDA events, 5 reps after a
warm-up), so two commits also compare kernel by kernel.  Then, on
``chip_smoke.py``'s phase-7 inputs (the symmetrized web graph and
``kron(20)``), it times the tree's ``intersect_count`` on the three
intersect cases and on each whole oriented list (a launch per chunk, and
one call where the tree's wrapper takes ``chunk``, whose first call is also
read after the card idles and on a fresh copy of adj), by CUDA events and by
the profiler's device time, prints what the list's candidates meet in the
kernel's tiles (``chip_smoke.intersect_work``), profiles ``tc_count`` on both
graphs, and times ``spmm_bsr`` on phase 10's block-sparse graph (F = 128;
f32, bf16 and both mixed dtypes).  All of it takes ``chip_smoke.py`` from
this checkout.

``--flash-f32`` times only the tree's f32 ``flash_attention_bhsd`` at
``chip_smoke.py``'s timed 17f cases (``FLASH_F32_TIMED``, the same inputs),
each beside ``scaled_dot_product_attention`` in f32, in turns, ``--repeat``
times (CUDA events, 17f's reps), and builds no graph.

``--serving`` times the batched serving runs instead: on the same web
graph, from phase 3's source and 9h's seven seeded vertices
(``chip_smoke.ms_sources``), ``ms_bfs``, ``ms_sssp`` and ``ms_ppr`` once to
warm up and ``--repeat`` more times each (walls as above), the graph query
server's 16 ragged requests on 8 slots ``--repeat`` times
(``benchmarks/serving.py``'s server row after its warm pass: qps, p50,
p99), then one more pass of the three under the profile.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]),
                    help="directory that holds the repro_torch to time")
    ap.add_argument("--repeat", type=int, default=8)
    ap.add_argument("--communities", type=int, default=512)
    ap.add_argument("--path-only", action="store_true",
                    help="time the main path only")
    ap.add_argument("--serving", action="store_true",
                    help="time the batched serving runs instead of the main path")
    ap.add_argument("--flash-f32", action="store_true",
                    help="time the f32 flash-attention cases of chip_smoke's 17f instead")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("time_main_path: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np

    import repro_torch as tc
    from repro_torch.core import frontier as fr
    from repro_torch.core import operators as ops
    from repro_torch.core.algorithms import bfs, cc, kcore, pagerank, sssp
    from repro_torch.graphs import generators as gen_mod
    from repro_torch.kernels import graph_ops as gk
    from repro_torch.kernels.graph_ops import build
    sys.path.insert(0, str(Path(__file__).resolve().parents[3]))
    import chip_smoke as cs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    if args.flash_f32:
        return flash_f32_times(torch, np, cs, args, card)
    build.load("graph_ops")
    src, dst, n = gen_mod.web_crawl_like(args.communities, 13, 16, 3, seed=0)
    w = gen_mod.random_weights(len(src), seed=1)
    g = tc.from_coo(src, dst, n, w, build_csc=True)
    source = int(np.argmax(np.bincount(src, minlength=n)))
    if args.serving:
        return serving_walls(torch, np, cs, gk, ops, g, source, args, card)
    gsym = tc.from_coo(src, dst, n, symmetrize=True, build_csc=True)
    del src, dst, w
    runs = {
        "bfs_dd_sparse": lambda: bfs.bfs_dd_sparse(g, source),
        "bfs_dd_sparse(fused=False)": lambda: bfs.bfs_dd_sparse(g, source, fused=False),
        "sssp_delta": lambda: sssp.sssp_delta(g, source, delta=4.0),
        "cc_pointer_jump": lambda: cc.cc_pointer_jump(gsym),
        "cc_dd_sparse": lambda: cc.cc_dd_sparse(gsym),
        "pr_push": lambda: pagerank.pr_push(gsym),
        "pr_pull": lambda: pagerank.pr_pull(gsym),
    }
    try:
        from repro_torch.kernels.device_loop import do_while
    except ImportError:   # a tree from before the device loop
        do_while = None
    walls = {name: [] for name in runs}
    first = {}
    captures = {name: [0, 0.0, 0] for name in runs}
    with ops.substrate_scope("cuda"):
        for rep in range(args.repeat + 1):
            for name, fn in runs.items():
                caps = (do_while.captures, do_while.capture_s) if do_while else (0, 0.0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                if do_while:
                    n, sec = do_while.captures - caps[0], do_while.capture_s - caps[1]
                    if rep:
                        captures[name][2] += n
                    else:
                        captures[name][:2] = [n, sec * 1e3]
                if rep:
                    walls[name].append(wall)
                else:
                    first[name] = wall
    summary = {name: dict(min=min(v), median=statistics.median(v), max=max(v))
               for name, v in walls.items()}
    print(json.dumps({"src": args.src, "card": card, "m": g.m, "sym_m": gsym.m,
                      "repeat": args.repeat, "first_ms": first, "wall_ms": walls,
                      "captures": captures if do_while else None,
                      "summary": summary}),
          flush=True)
    if args.path_only:
        return 0
    kruns = {"kcore_dd_sparse(k=64)": lambda: kcore.kcore_dd_sparse(gsym, 64),
             "core_numbers(k_max=64)": lambda: kcore.core_numbers(gsym, 64)}
    with ops.substrate_scope("cuda"):
        kwall = 0.0
        for fn in kruns.values():   # their wall time without the profiler
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            kwall += (time.perf_counter() - t0) * 1e3
        gk.reset_launches()
        cs.print_profile(torch, gk, "main path", {k: cs.Run(v) for k, v in runs.items()},
                         sum(v["median"] for v in summary.values()))
        print(f"main path launches: {json.dumps(gk.launch_counts())}", flush=True)
        gk.reset_launches()
        cs.print_profile(torch, gk, "kcore", {k: cs.Run(v) for k, v in kruns.items()},
                         kwall)
        print(f"kcore launches: {json.dumps(gk.launch_counts())}", flush=True)
    kernel_cases(torch, cs, gk, fr, g, gsym)
    intersect_cases(torch, cs, gk, gen_mod, gsym)
    spmm_cases(torch, cs, gen_mod)
    return 0


def flash_f32_times(torch, np, cs, args, card) -> int:
    """The tree's f32 flash attention at 17f's timed cases beside SDPA in
    f32, kernel and library in turns, ``--repeat`` times each."""
    import torch.nn.functional as F
    from repro_torch.benchmarks import kernels_bench
    from repro_torch.kernels.flash_attention import flash_attention as fk
    gen = torch.Generator(device="cuda")
    gen.manual_seed(27)
    rows = {}
    for name, bh, s, d, window, causal in cs.FLASH_F32_TIMED:
        assert causal and (window is None or window >= s), "SDPA's is_causal mask differs"
        if name.startswith("(a)"):
            (q, k, v), _, _ = kernels_bench.kernel_inputs("cuda", np.random.default_rng(0))
        else:
            q, k, v = (torch.randn((bh, s, d), generator=gen, device="cuda") for _ in range(3))
        q4, k4, v4 = (t.view(1, bh, s, d) for t in (q, k, v))
        pairs = cs.attention_pairs(s, window, causal) * bh
        reps = cs.FLASH_F32_REPS_SHORT if pairs < cs.FLASH_F32_SHORT_PAIRS else 5
        row = rows[name] = dict(ms=[], library_ms=[], reps=reps)
        for _ in range(args.repeat):
            row["ms"].append(cs.cuda_ms(torch, lambda: fk.flash_attention_bhsd(
                q, k, v, causal=causal, window=window), reps))
            row["library_ms"].append(cs.cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal), reps))
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()
    print(json.dumps({"src": args.src, "card": card, "flash_f32": rows}), flush=True)
    return 0


def serving_walls(torch, np, cs, gk, ops, g, source, args, card) -> int:
    """``--serving``: the batched runs' walls, the server's rows, the
    profile."""
    from repro_torch.benchmarks import serving
    from repro_torch.core import multisource as ms
    sources = cs.ms_sources(np, g, source, cs.MS_SEED)
    runs = {"ms_bfs": lambda: ms.ms_bfs(g, sources),
            "ms_sssp": lambda: ms.ms_sssp(g, sources),
            "ms_ppr": lambda: ms.ms_ppr(g, sources)}
    walls = {name: [] for name in runs}
    first = {}
    with ops.substrate_scope("cuda"):
        for rep in range(args.repeat + 1):
            for name, fn in runs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                if rep:
                    walls[name].append(wall)
                else:
                    first[name] = wall
        server = []
        for _ in range(args.repeat):
            rows = serving.run(graphs=(g, sources), warmup=0, iters=1)
            stats = next(r[3] for r in rows if r[0] == "serving/server_bfs")
            server.append({k: stats[k] for k in ("qps", "p50_us", "p99_us")})
    summary = {name: dict(min=min(v), median=statistics.median(v), max=max(v))
               for name, v in walls.items()}
    print(json.dumps({"src": args.src, "card": card, "m": g.m, "sources": sources,
                      "repeat": args.repeat, "first_ms": first, "wall_ms": walls,
                      "summary": summary, "server": server}), flush=True)
    with ops.substrate_scope("cuda"):
        gk.reset_launches()
        cs.print_profile(torch, gk, "serving", {k: cs.Run(v) for k, v in runs.items()},
                         sum(summary[k]["median"] for k in runs))
    return 0


def kernel_cases(torch, cs, gk, fr, g, gsym):
    """The tree's edge_relax and advance_frontier on chip_smoke's phase-4
    inputs (a tree whose edge_relax takes no ``case`` is called without)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    takes_case = "case" in inspect.signature(gk.edge_relax).parameters
    for name, kw in cs.edge_relax_cases(torch, g, gsym, gk, fr, gen):
        extra = {"case": kw["case"]} if takes_case and "case" in kw else {}
        args = (kw["src"], kw["dst"], kw["w"], kw["mask"], kw["src_val"], kw["out_init"])
        ms = cs.cuda_ms(torch, lambda: gk.edge_relax(
            *args, kind=kw["kind"], use_weight=kw["use_weight"],
            vertex_mask=kw["vertex_mask"], **extra))
        print("  kernel case " + json.dumps(dict(kernel="edge_relax", case=name, ms=ms)),
              flush=True)
    for name, mask, cap, budget in cs.advance_cases(torch, g, fr, gen):
        f = fr.compact(mask, cap, g.sentinel)
        ms = cs.cuda_ms(torch, lambda: gk.advance_frontier(
            f.idx, f.count, g.out_deg, g.row_ptr, g.col_idx, g.edge_w, budget=budget,
            sentinel=g.sentinel, m_pad=g.m_pad))
        print("  kernel case " + json.dumps(dict(kernel="advance", case=name, ms=ms)),
              flush=True)


def intersect_cases(torch, cs, gk, gen_mod, gsym):
    """The tree's intersect_count on chip_smoke's intersect cases and each
    whole oriented list, then tc_count's profile, on the web graph and kron."""
    import repro_torch as tc
    from repro_torch.core import operators as ops
    from repro_torch.core.algorithms import tc as tri
    params = inspect.signature(gk.intersect_count).parameters
    ch = cs.INTERSECT_CHUNK
    ksrc, kdst, kn = gen_mod.table3_suite(10)["kron30"]()
    kgsym = tc.from_coo(ksrc, kdst, kn, symmetrize=True, build_csc=True)
    del ksrc, kdst
    for label, g in (("web", gsym), ("kron", kgsym)):
        oriented = cs.oriented_chunks(torch, tri, g)
        adj, osrc, odst, row_len = oriented[:4]
        work = cs.intersect_work(torch, osrc, odst, row_len)
        print(f"  intersect work {label} " + json.dumps(work), flush=True)
        for name, _, src, dst, _, sentinel in cs.intersect_cases(torch, label, g, *oriented):
            def fn():
                return gk.intersect_count(adj, src, dst, sentinel=sentinel)
            print("  kernel case " + json.dumps(dict(
                kernel="intersect", case=name, ms=cs.cuda_ms(torch, fn),
                device_ms=cs.device_ms(torch, fn))), flush=True)
        rows = {"launch per chunk": lambda: [
            gk.intersect_count(adj, osrc[c:c + ch], odst[c:c + ch], sentinel=g.sentinel)
            for c in range(0, osrc.shape[0], ch)]}
        if "chunk" in params:
            rows["one call"] = lambda: gk.intersect_count(adj, osrc, odst, sentinel=g.sentinel,
                                                          chunk=ch)
        for route, fn in rows.items():
            dev_ms = cs.device_ms(torch, fn, reps=2)
            print("  kernel case " + json.dumps(dict(
                kernel="intersect", case=f"{label} whole list, {route}",
                ms=cs.cuda_ms(torch, fn, reps=2), device_ms=dev_ms,
                device_ps_per_candidate=None if dev_ms is None
                else dev_ms * 1e9 / work["candidates"])), flush=True)
        if "chunk" in params:
            first_calls(torch, cs, gk, label, adj, osrc, odst, g.sentinel, ch)
        del oriented, adj, osrc, odst, row_len
        torch.cuda.empty_cache()
        with ops.substrate_scope("cuda"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tri.tc_count(g)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            gk.reset_launches()
            cs.print_profile(torch, gk, f"tc {label}",
                             {"tc_count": cs.Run(lambda: tri.tc_count(g))}, wall)
            print(f"tc {label} launches: {json.dumps(gk.launch_counts())}", flush=True)
    del kgsym
    torch.cuda.empty_cache()


def first_calls(torch, cs, gk, label, adj, osrc, odst, sentinel, ch):
    """The intersect kernels' device time of one whole-list call (one pass
    each, under the profiler): after the card has idled 5 s; on a fresh
    copy of adj (its row lengths computed inside the call, as in
    tc_count), then again on that copy; on another fresh copy whose row
    lengths were computed before the call; and on the first adj right
    after a full pass over another copy.  It tells a first call's extra
    time inside tc_count apart from the card's idling, adj's freshness and
    the pass before it."""
    from repro_torch.kernels.graph_ops import ops as gops

    def once(a):
        events, _ = cs.profiled(torch, lambda: gk.intersect_count(
            a, osrc, odst, sentinel=sentinel, chunk=ch))
        us = sum(getattr(ev, "self_device_time_total", 0) or 0 for ev in events or ()
                 if "intersect_" in ev.key)
        return us / 1e3

    torch.cuda.synchronize()
    time.sleep(5)
    rows = {"after 5 s idle": once(adj)}
    fresh = adj.clone()
    rows["fresh copy of adj"] = once(fresh)
    rows["fresh copy, again"] = once(fresh)
    other = adj.clone()
    gops.row_lengths(other, sentinel)
    torch.cuda.synchronize()
    rows["another fresh copy, row lengths first"] = once(other)
    (fresh != sentinel).sum(1, dtype=torch.int32)
    rows["first adj after a pass over a copy"] = once(adj)
    print(f"  intersect first calls {label} " + json.dumps(rows), flush=True)
    del fresh, other


def spmm_cases(torch, cs, gen_mod):
    """The tree's spmm_bsr on chip_smoke's block-sparse graph, F = 128."""
    from repro_torch.kernels.spmm_bsr import spmm_bsr as sk
    src, dst, n = gen_mod.web_crawl_like(16, 13, 16, 3, seed=0)
    idx_np, blocks_np = sk.to_bsr(src, dst, gen_mod.random_weights(len(src), seed=1), n)
    idx, blocks = torch.from_numpy(idx_np).cuda(), torch.from_numpy(blocks_np).cuda()
    x = torch.randn((idx.shape[0] * blocks.shape[3], 128),
                    generator=torch.Generator(device="cuda").manual_seed(11), device="cuda")
    for a_name, x_name in (("float32", "float32"),) + tuple(d[:2] for d in cs.SPMM_DTYPES):
        a_t, x_t = blocks.to(getattr(torch, a_name)), x.to(getattr(torch, x_name))
        ms = cs.cuda_ms(torch, lambda: sk.spmm_bsr(idx, a_t, x_t))
        print("  kernel case " + json.dumps(dict(kernel="spmm_bsr", case=f"blocks {a_name} x "
                                                 f"{x_name}, F = 128", ms=ms)), flush=True)


if __name__ == "__main__":
    sys.exit(main())
