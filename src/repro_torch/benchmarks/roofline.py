"""Roofline rows from the dry-run records, as the JAX package's
``benchmarks/roofline.py``.

Reads experiments/dryrun_torch/*.json (written by
``repro_torch.launch.dryrun``) and emits one row per (arch × shape ×
mesh): the three roofline terms on an H100, the dominant bottleneck,
MODEL_FLOPS = 6·N·D (active N for MoE; 2·N·D for a forward-only cell)
and the useful-compute ratio MODEL_FLOPS / counted FLOPs.  A row's time
is its dominant term in µs: a bound from shapes, not a measurement.

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline [--emit-json PATH]
"""

from __future__ import annotations

import glob
import importlib
import json
import os

from ..launch.dryrun import LM_CONFIG_MODULES
from .common import print_rows, row, rows_as_json

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                          "dryrun_torch")

TOKENS = {
    "train_4k": 4096 * 256,
    "prefill_32k": 32768 * 32,
    "decode_32k": 128,          # one token per sequence
    "long_500k": 1,
}

def model_flops(arch: str, shape: str, n_chips: int):
    """6·N_active·D per train step (2× for forward-only serve), total across
    chips; None for non-LM archs (their MODEL_FLOPS has no 6ND form)."""
    mod = LM_CONFIG_MODULES.get(arch)
    if mod is None or shape not in TOKENS:
        return None
    cfg = importlib.import_module(f"..configs.{mod}", __package__).FULL
    mult = 6 if shape == "train_4k" else 2
    return mult * cfg.active_param_count * TOKENS[shape]


def run(include_multipod: bool = False, directory: str = DRYRUN_DIR):
    """The rows of every record in ``directory`` (single-pod only unless
    ``include_multipod``)."""
    rows = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        if os.path.basename(path).endswith("__pod2.json") and not include_multipod:
            continue
        with open(path) as f:
            rec = json.load(f)
        arch, shape = rec["arch"], rec["shape"]
        tag = "x".join(str(x) for x in rec["mesh"])
        r = rec["roofline"]
        mf = model_flops(arch, shape, rec["n_chips"])
        total = rec["per_device"]["flops"] * rec["n_chips"]
        ratio = (mf / total) if (mf and total) else None
        dom_us = max(r["compute_s"], r["memory_s"], r["collective_s"]) * 1e6
        rows.append(row(
            f"roofline/{arch}/{shape}/{tag}", dom_us,
            f"compute_s={r['compute_s']:.3e};memory_s={r['memory_s']:.3e};"
            f"collective_s={r['collective_s']:.3e};bottleneck={r['bottleneck']};"
            f"model_flops={mf if mf else 'n/a'};"
            f"useful_ratio={f'{ratio:.3f}' if ratio else 'n/a'}"))
    if not rows:
        rows.append(row("roofline/EMPTY", 0.0, "run launch/dryrun.py first"))
    return rows


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--emit-json", metavar="PATH", help="also write the rows as JSON to PATH")
    ap.add_argument("--multi-pod", action="store_true", help="include the multi-pod records")
    args = ap.parse_args(argv)
    rows = run(include_multipod=args.multi_pod)
    print_rows(rows)
    if args.emit_json:
        with open(args.emit_json, "w") as fh:
            json.dump(rows_as_json("roofline", rows), fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
