"""Benchmark harness of the port, as the JAX round's ``benchmarks/run.py``:
one module per paper table or figure.

Prints ``name,us_per_call,derived`` CSV.  With ``--emit-json`` each suite
also writes its rows (with each row's stats where the suite collects them)
to ``BENCH_torch_<suite>.json``, or to PATH when a single suite is
selected; ``benchmarks/ci_gate.py`` reads them unchanged.  The ``torch``
in the name keeps a run from the repo's root off the JAX round's
``BENCH_<suite>.json``.

  memtier      Tables 1-2   memory tiers: HBM, pinned/pageable H2D, D2H
  placement    Fig 3/§4.1   local/interleaved/blocked placement (8 positions)
  granularity  Fig 4-5/§4.3 block-size ("page size") sweep + churn model
  algo_classes Fig 6-7/§5   algorithm classes × diameter regimes
  frameworks   Fig 8-9/§6.1 framework capability classes
  scaling      Fig 10/§6.2  strong scaling: sharded engine vs BSP baseline
  vs_cluster   Fig 11/§6.3  single machine vs BSP cluster engine
  comm_volume  §CVC         CVC vs full-mesh reduction volume, 1-8 positions
  outofcore    §Thesis      streamed shards vs all-resident pool (tiered)
  serving      §Serving     multi-source batched queries: amortization + QPS
  dynamic      §Dynamic     edge-log deltas: incremental vs full recompute
  kernels      —            hand-written kernels' µs/call
  roofline     §Roofline    reads experiments/dryrun_torch/*.json

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--suite NAME ...]
        [--emit-json [PATH]] [--list] [--device cpu]

The suites run on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import inspect
import json
import sys
import traceback

from ..core.graph import _device
from . import (algo_classes, common, comm_volume, dynamic, frameworks, granularity,
               kernels_bench, memtier, outofcore, placement, roofline, scaling, serving,
               vs_cluster)

SUITES = {
    "memtier": memtier,
    "placement": placement,
    "granularity": granularity,
    "algo_classes": algo_classes,
    "frameworks": frameworks,
    "scaling": scaling,
    "vs_cluster": vs_cluster,
    "comm_volume": comm_volume,
    "outofcore": outofcore,
    "serving": serving,
    "dynamic": dynamic,
    "kernels": kernels_bench,
    "roofline": roofline,
}


def run_suite(mod, device):
    """The suite's rows at its defaults, on ``device`` where the suite
    takes one (``roofline`` reads records and touches no device)."""
    if "device" in inspect.signature(mod.run).parameters:
        return mod.run(device=device)
    return mod.run()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--suite", action="append", default=None,
                    help="subset of suites (default: all)")
    ap.add_argument("--emit-json", nargs="?", const="auto", default=None, metavar="PATH",
                    help="persist rows (+ stats) as JSON: BENCH_torch_<suite>.json per "
                         "suite, or PATH when exactly one suite is selected")
    ap.add_argument("--list", action="store_true",
                    help="print available suite names and exit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    if args.list:
        print("\n".join(SUITES))
        return 0
    names = args.suite or list(SUITES)
    unknown = [n for n in names if n not in SUITES]
    if unknown:
        ap.error(f"unknown suite(s) {', '.join(unknown)}; available: {', '.join(SUITES)}")
    if args.emit_json not in (None, "auto") and len(names) != 1:
        ap.error("--emit-json PATH needs exactly one --suite "
                 "(omit PATH for per-suite BENCH_torch_<suite>.json files)")
    _device(args.device)               # no card and no --device: raise here
    print("name,us_per_call,derived", flush=True)
    ok = True
    for name in names:
        try:
            rows = run_suite(SUITES[name], args.device)
            common.print_rows(rows)
            # a dead child is a */ERROR row: it fails the run, not an empty record
            if any(str(r[0]).endswith("/ERROR") for r in rows):
                ok = False
            if args.emit_json is not None:
                path = (f"BENCH_torch_{name}.json" if args.emit_json == "auto"
                        else args.emit_json)
                with open(path, "w") as fh:
                    json.dump(common.rows_as_json(name, rows), fh, indent=1)
                print(f"# wrote {path}", file=sys.stderr)
        except Exception:  # noqa: BLE001  (one suite's failure is reported, the rest run)
            ok = False
            print(f"{name}/SUITE_ERROR,0.0,", flush=True)
            traceback.print_exc()
    sys.stdout.flush()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
