"""Shared benchmark utilities: timing and result rows, as in the JAX
package's ``benchmarks/common.py``."""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch


def _sync() -> None:
    """Wait for the card, where work may still be queued (a no-op until
    CUDA has been used)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_call(fn: Callable, *args, warmup: int = 1, iters: int = 3) -> float:
    """Median wall time in microseconds; on the card each call ends with
    ``torch.cuda.synchronize()``."""
    return timed(lambda: fn(*args), warmup, iters)[1]


def timed(fn: Callable, warmup: int = 1, iters: int = 3):
    """``(first call's output, median wall µs of the timed calls)``: the
    row's results and counters come from the first call (the warm-up when
    there is one), so a row costs ``warmup + iters`` calls."""
    out, ts = timed_samples(fn, warmup, iters)
    return out, float(np.median(ts))


def timed_samples(fn: Callable, warmup: int = 1, iters: int = 3):
    """``timed`` with every timed call's wall µs, sorted."""
    out = None
    for _ in range(warmup):
        res = fn()
        _sync()
        out = res if out is None else out
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        res = fn()
        _sync()
        ts.append((time.perf_counter() - t0) * 1e6)
        out = res if out is None else out
    return out, sorted(ts)


def wall_fields(samples) -> dict:
    """The JAX suites' ``emit`` fields of a row's samples: min, median and
    count (``benchmarks/ci_gate.py`` gates on ``wall_us_min``)."""
    if not samples:
        return {}
    return dict(wall_us_min=samples[0], wall_us_median=samples[len(samples) // 2],
                wall_us_reps=len(samples))


def bench_graphs(scale: str = "small"):
    """The Table-3 contrast pair at benchmark scale, from the JAX suite's
    generators and seeds: low-diameter rmat against a high-diameter
    web-crawl-like graph, as host COO ``(src, dst, n)``."""
    from ..graphs import generators as gen

    if scale == "small":
        return {
            "rmat": gen.rmat(10, 12, seed=1),
            "web": gen.web_crawl_like(24, 5, 10, 2, seed=2),
        }
    return {
        "rmat": gen.rmat(13, 16, seed=1),
        "web": gen.web_crawl_like(64, 6, 12, 2, seed=2),
    }


def suite_main(name: str, run: Callable, doc: str, argv=None) -> int:
    """The ``__main__`` of a suite: print its rows as CSV and, with
    ``--emit-json PATH``, write them as JSON; ``--device cpu`` runs the
    plain versions on the CPU."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--emit-json", metavar="PATH",
                    help="also write the rows as JSON to PATH")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    rows = run(device=args.device)
    print_rows(rows)
    if args.emit_json:
        with open(args.emit_json, "w") as fh:
            json.dump(rows_as_json(name, rows), fh, indent=1)
    return 0


def row(name: str, us: float, derived: str = "", stats: dict | None = None) -> tuple:
    """One benchmark row: name, wall time in microseconds, derived counters
    and, where a run has them, its stats (``RunStats.as_dict()`` and the
    like) for ``--emit-json``; the CSV printer leaves them out."""
    return (name, us, derived, stats)


def print_rows(rows):
    for name, us, derived, _ in rows:
        print(f"{name},{us:.1f},{derived}")


def rows_as_json(suite: str, rows) -> dict:
    """JSON document for ``--emit-json``: every row's name, wall time,
    derived counters and stats (where the row has them)."""
    return {"suite": suite, "rows": [
        {"name": name, "us_per_call": us, "derived": derived,
         **({"stats": stats} if stats is not None else {})}
        for name, us, derived, stats in rows]}
