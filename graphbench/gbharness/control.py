"""The control of ``correct``: the plain reference in the precision below
the one the configuration states (bfloat16 for float32), put in the
program's place and judged by the same comparison as the program.  It has to come out not
correct.  It is not part of the benchmark's runs.

    PYTHONPATH=graphbench python3 -m gbharness.control --workload <cell> \\
        --seeds 1,2,3 [--trials 4]

prints one JSON line a seed with each check's reading and its limit, on
the configuration's graph and the first ``--trials`` trials of a run with
that seed.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

from . import check
from .main import judge, load_cell, make_inputs, make_plan, reference_csr

# the precision a configuration states, and the one below it
LOWER = {"float64": torch.float32, "float32": torch.bfloat16}


def readings(root, workload: str, seed: int, trials: int, device="cuda") -> dict:
    """The control's readings on ``workload``'s inputs for ``seed``."""
    _, _, config, traffic = load_cell(Path(root), workload)
    dev = torch.device(device)
    src, dst, w, n = make_inputs(Path(root), config, traffic, dev)
    plan = make_plan(src, dst, n, config, traffic, seed)
    coo = (src.cpu().numpy(), dst.cpu().numpy(), None if w is None else w.cpu().numpy())
    del src, dst, w
    csr = reference_csr(coo, n, config, traffic, dev)
    items = [(*plan(k), None) for k in range(trials)]
    got, _ = judge(Path(root), items, csr, traffic, control=LOWER[config["precision"]])
    limits = traffic["checks"]
    return dict(workload=workload, seed=seed, trials=trials,
                correct=check.verdict(got, limits),
                checks={k: dict(value=got.get(k), limit=v) for k, v in limits.items()})


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Readings of the lower-precision control.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--trials", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    root = Path(__file__).resolve().parents[2]
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(root, args.workload, seed, args.trials)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
