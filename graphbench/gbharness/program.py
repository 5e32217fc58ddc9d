"""The system under test: ``repro_torch``, the only module of the harness
that imports it.  It builds the program's graph from the generated COO
and calls each algorithm a traffic mix names, through the program's
public entry points (``from_coo``, ``tier_graph``, the algorithm
functions).

A traffic mix names each algorithm as data (``graphbench/traffic/*.json``,
an entry of ``"algorithms"``)::

    {"name": "bfs_dirop", "module": "core.algorithms.bfs",
     "function": "bfs_dirop", "kwargs": {"alpha": 14.0, "beta": 24.0},
     "csc": true, "weighted": false, "source": true,
     "answer": {"kind": "levels"}}

``module`` lies under ``repro_torch``; a trial calls ``function(graph,
source, **kwargs)``, or ``function(graph, **kwargs)`` where ``source`` is
false.  ``csc`` asks for the CSC mirror; ``weighted`` for the cell's
weights, else every edge weighs 1.  ``answer`` names the plain reference
and the comparison its labels are held to
(``graphbench/answers/<kind>.py``).
"""

from __future__ import annotations

import dataclasses
import importlib
import sys
from pathlib import Path

import torch

KERNEL_LIBS = ("graph_ops", "device_loop", "crc32")
SPEC_KEYS = {"name", "module", "function", "kwargs", "csc", "weighted", "source",
             "answer"}


def specs(traffic: dict) -> dict:
    """The mix's algorithms by name, in the mix's order."""
    out = {}
    for spec in traffic["algorithms"]:
        if set(spec) - SPEC_KEYS or not {"name", "module", "function", "answer"} <= set(spec):
            raise ValueError(f"algorithm entry {spec!r} has keys outside {sorted(SPEC_KEYS)}")
        out[spec["name"]] = dict(dict(kwargs={}, csc=False, weighted=False, source=True),
                                 **spec)
    return out


def import_program(root: Path):
    """Import ``repro_torch`` from the checkout's ``src``; returns its
    ``core`` (``from_coo``, ``tier_graph``)."""
    src = str(Path(root) / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    return importlib.import_module("repro_torch.core")


def load_kernels(device) -> None:
    """Build (first run in a checkout) or load the program's CUDA kernels."""
    if torch.device(device).type != "cuda":
        return
    from repro_torch.kernels import build
    for lib in KERNEL_LIBS:
        build.load(lib)


def unit_view(g):
    """``g`` with weight 1 on every edge, sharing its index arrays.  It
    rests on one invariant of the program's ``Graph`` (its docstring:
    ``edge_w`` is 0 on padding), which the cell's weights, all at least 1,
    keep: a slot is an edge exactly where its weight is above 0, and
    ``from_coo`` without weights gives those slots weight 1."""
    unit = dict(edge_w=(g.edge_w > 0).to(torch.float32))
    if g.has_csc:
        unit["in_edge_w"] = (g.in_edge_w > 0).to(torch.float32)
    return dataclasses.replace(g, **unit)


class Program:
    """The program's graph (its unit-weight view, or its tiered cut) and
    the function of each algorithm of the traffic mix."""

    def __init__(self, tc, coo, n: int, *, symmetrize: bool, algos: dict, tier,
                 device, timings: dict):
        from repro_torch.core import engine
        from repro_torch.kernels.device_loop import do_while
        self.engine, self.do_while = engine, do_while
        self.specs = algos
        self.fns = {name: getattr(importlib.import_module(f"repro_torch.{s['module']}"),
                                  s["function"]) for name, s in algos.items()}
        need = list(algos.values())
        src, dst, w = coo
        weighted = any(s["weighted"] for s in need)
        g = tc.from_coo(src, dst, n, w if weighted else None,
                        build_csc=any(s["csc"] for s in need),
                        symmetrize=symmetrize, device=device, timings=timings)
        self.graphs = {True: g, False: g}
        if weighted and not all(s["weighted"] for s in need):
            self.graphs[False] = unit_view(g)
        if tier is not None:
            if self.graphs[False] is not g:
                raise ValueError("a tiered graph carries one weighting: the mix mixes two")
            tg = tc.tier_graph(g, tier["nshards"], resident_shards=tier["pool"],
                               build_csc=any(s["csc"] for s in need))
            self.graphs = {True: tg, False: tg}
            del g

    def call(self, name: str, source):
        """One trial or solve: ``(labels, RunStats)``, not synchronised."""
        spec = self.specs[name]
        g = self.graphs[spec["weighted"]]
        args = (g, source) if spec["source"] else (g,)
        return self.fns[name](*args, **spec["kwargs"])

    def fetches(self) -> int:
        return self.engine.fetch.calls

    def captures(self) -> int:
        return self.do_while.captures

    def loop_launches(self) -> int:
        """Launches of the device loop's CUDA graphs, whose kernels the
        profiler does not see."""
        return self.do_while.launches

    def close(self) -> None:
        self.graphs = None
