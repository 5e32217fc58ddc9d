"""The paper's full evaluation pipeline end to end, as
``examples/paper_suite.py``.

Generates the Table-3-style input suite (scaled), runs all seven paper
benchmarks (bc, bfs, cc, kcore, pr, sssp, tc) with the best algorithm class
per graph regime, verifies results against independent oracles (the numpy
ones in the repo's ``tests/oracles.py``), and prints the Fig. 6-style
comparison.

    PYTHONPATH=src python -m repro_torch.examples.paper_suite [--scale big] [--device cpu]

On the card the algorithms run through ``edge_relax``, ``advance`` and
(tc) ``intersect``.
"""

from __future__ import annotations

import argparse
import importlib.util
import time
from pathlib import Path

import numpy as np
import torch

from ..core.algorithms import bc, bfs, cc, kcore, pagerank, sssp, tc
from ..core.graph import from_coo
from ..graphs import generators as gen

# src/repro_torch/examples/paper_suite.py -> the repo's tests/oracles.py
ORACLES = Path(__file__).resolve().parents[3] / "tests" / "oracles.py"


def load_oracles():
    """The numpy oracles of ``tests/oracles.py``, loaded from the checkout
    this module lies in (not from the working directory)."""
    if not ORACLES.is_file():
        raise FileNotFoundError(f"the numpy oracles are not at {ORACLES}")
    spec = importlib.util.spec_from_file_location("repro_torch_paper_oracles", ORACLES)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host(t, n):
    """The first ``n`` entries of a label tensor as a numpy array."""
    return t[:n].cpu().numpy()


def run_input(name, src, dst, n, verify=True, device=None, oracles=None):
    """The seven benchmarks on one input, each timed and (with ``verify``)
    checked against its oracle with the JAX script's tolerances.  Returns
    one dict a benchmark: ``label``, ``ms``, ``rounds``, ``ok`` (None
    unverified), ``out`` and ``stats``."""
    if verify and oracles is None:
        oracles = load_oracles()
    w = gen.random_weights(len(src), seed=7)
    g = from_coo(src, dst, n, w, build_csc=True, device=device)          # weighted (sssp)
    g_unw = from_coo(src, dst, n, build_csc=True, device=device)         # unit weights (bfs)
    gsym = from_coo(src, dst, n, symmetrize=True, build_csc=True, device=device)
    s_arr = _host(g.src_idx, g.m)
    d_arr = _host(g.col_idx, g.m)
    w_arr = _host(g.edge_w, g.m)
    ssym = _host(gsym.src_idx, gsym.m)
    dsym = _host(gsym.col_idx, gsym.m)
    source = int(np.argmax(np.bincount(s_arr, minlength=n)))
    print(f"\n=== {name}: n={g.n} m={g.m} (sym m={gsym.m}) source={source}", flush=True)
    results = []

    def timed(label, fn, check=None):
        t0 = time.perf_counter()
        out, stats = fn()
        if g.device.type == "cuda":
            torch.cuda.synchronize(g.device)
        dt = (time.perf_counter() - t0) * 1e3
        ok = None
        if verify and check is not None:
            ok = bool(check(out))
        mark = "" if ok is None else ("✓" if ok else "✗ MISMATCH")
        print(f"  {label:22s} {dt:9.1f} ms  rounds={stats.rounds:<6d} {mark}", flush=True)
        results.append(dict(label=label, ms=dt, rounds=stats.rounds, ok=ok, out=out,
                            stats=stats))

    def inf_above(out):
        x = _host(out, n)
        return np.where(x > 1e30, np.inf, x)

    ref_bfs = oracles.bfs(s_arr, d_arr, n, source) if verify else None
    timed("bfs (sparse worklist)", lambda: bfs.bfs_dd_sparse(g_unw, source),
          lambda out: np.array_equal(inf_above(out), ref_bfs))
    ref_d = oracles.dijkstra(s_arr, d_arr, w_arr, n, source) if verify else None
    timed("sssp (delta-stepping)", lambda: sssp.sssp_delta(g, source),
          lambda out: np.allclose(inf_above(out), ref_d, rtol=1e-5, equal_nan=False))
    ref_cc = oracles.connected_components(ssym, dsym, n) if verify else None
    timed("cc (pointer-jump)", lambda: cc.cc_pointer_jump(gsym),
          lambda out: np.array_equal(
              np.unique(ref_cc, return_inverse=True)[1],
              np.unique(_host(out, n), return_inverse=True)[1]))
    ref_pr = oracles.pagerank(ssym, dsym, n) if verify else None
    timed("pr (residual push)", lambda: pagerank.pr_push(gsym),
          lambda out: np.allclose(_host(out, n), ref_pr, rtol=5e-3, atol=1e-7))
    ref_kc = oracles.kcore_alive(ssym, dsym, n, 3) if verify else None
    timed("kcore (k=3 peel)", lambda: kcore.kcore_peel(gsym, 3),
          lambda out: np.array_equal(_host(out, n), ref_kc))
    ref_bc = oracles.brandes_bc(s_arr, d_arr, n, source) if verify else None
    timed("bc (brandes)", lambda: bc.bc_brandes(g, source),
          lambda out: np.allclose(_host(out, n), ref_bc, rtol=1e-3, atol=1e-4))
    ref_tc = oracles.triangle_count(ssym, dsym, n) if verify else None
    timed("tc (orient+intersect)", lambda: tc.tc_count(gsym),
          lambda out: int(out) == ref_tc)
    return results


def main(argv=None) -> dict:
    """Runs the suite; returns ``{input name: run_input's list}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", default="small", choices=["small", "big"])
    ap.add_argument("--no-verify", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    oracles = None if args.no_verify else load_oracles()
    shift = 0 if args.scale == "small" else 2
    suite = gen.table3_suite(shift)
    out = {}
    # kron/rmat = low diameter; clueweb/uk/wdc stand-ins = high diameter
    for name in ("kron30", "clueweb12", "wdc12"):
        src, dst, n = suite[name]()
        out[name] = run_input(name, src, dst, n, verify=not args.no_verify,
                              device=args.device, oracles=oracles)
    print("\nPAPER_SUITE_OK", flush=True)
    return out


if __name__ == "__main__":
    main()
