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
    for _ in range(warmup):
        fn(*args)
        _sync()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        ts.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(ts))


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
