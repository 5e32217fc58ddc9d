"""Dry run of every (arch × shape) cell on the production meshes,
accounted on meta tensors, with its roofline terms on an H100: the
port's ``repro.launch.dryrun``.

The reference lowers and compiles each cell on 512 forced host devices
and reads XLA's memory and cost analyses and the HLO's collectives.  The
port has no compiler to ask, so each cell's step runs once on meta
tensors (shapes and dtypes, nothing allocated or computed):

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the whole step
  (forward, backward and optimizer; its matrix products).  Per device is
  the total over ``n_chips``.
* Bytes accessed: ``ByteCounter``, the bytes of every aten op's tensor
  inputs and outputs, views excepted.  An unfused upper bound, not XLA's
  post-fusion count (``BYTES_MODEL``).  Per device is the total over
  ``n_chips``.
* Argument and output bytes per device: exact, from ``shard_shape`` of
  each leaf under its spec.  ``temp_bytes``/``peak_bytes`` are null: there
  is no compiler buffer assignment.
* Collective bytes: ``collective_model``, from the parameter specs only
  (``COLLECTIVE_MODEL``, a lower bound); the reference's HLO parser has
  no input here and is not ported.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # single-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list

Outputs one JSON per cell under experiments/dryrun_torch/, read by
``repro_torch.benchmarks.roofline``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..distributed.mesh_utils import P, filter_pspec, names_of, shard_shape
from ..optim.adamw import _leaves as leaves
from .mesh import make_production_mesh

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# H100 SXM constants (per card; NVIDIA's data sheet, dense rates).  A
# cell's compute term takes the peak of its parameters' dtype: f32 runs
# with TF32 off, on the FMA units.
DEVICE = "H100 SXM"
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12,   # tensor cores
              "float32": 67e12}
HBM_BW = 3.35e12          # bytes/s, HBM3
LINK_BW = 450e9           # bytes/s, NVLink 4, each direction

BYTES_MODEL = ("unfused upper bound: every aten op's tensor inputs read and "
               "outputs written once, views excepted")
COLLECTIVE_MODEL = "params-only lower bound"

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
BATCH_AXES = ("pod", "data")


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor inputs and outputs; a view
    moves nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view and func is not torch.ops.aten._unsafe_view.default:
            self.ops += 1
            self.bytes += sum(map(_nbytes, tree_leaves((args, kwargs))))
            self.bytes += sum(map(_nbytes, tree_leaves(out)))
        return out


def account(fn, args):
    """(flops, bytes accessed, aten ops, outputs) of ``fn(*args)``."""
    flops = FlopCounterMode(display=False)
    nbytes = ByteCounter()
    with flops, nbytes:
        out = fn(*args)
    return flops.get_total_flops(), nbytes.bytes, nbytes.ops, out


def _spec_pairs(values, specs):
    """(leaf, spec) pairs of a value tree and its spec tree; one spec may
    stand for a whole tree."""
    vals, sps = leaves(values), leaves(specs)
    if len(sps) == 1 and len(vals) != 1:
        sps = sps * len(vals)
    if len(vals) != len(sps):
        raise ValueError(f"{len(vals)} leaves against {len(sps)} specs")
    return zip(vals, sps)


def _shard_bytes(t, spec, mesh) -> int:
    if not isinstance(t, torch.Tensor):
        return 0
    return math.prod(shard_shape(t.shape, spec, mesh)) * t.element_size()


def tree_shard_bytes(values, specs, mesh) -> int:
    """Per-device bytes of a value tree under its specs."""
    return sum(_shard_bytes(t, s, mesh) for t, s in _spec_pairs(values, specs))


def collective_model(params, pspecs, mesh, train: bool):
    """Per-device collective bytes and counts from the parameter specs
    only, for a train step: a parameter sharded over a batch axis is
    gathered once in the forward and once in the backward (a gather's
    bytes its result's) and its gradient reduce-scattered once; a
    parameter replicated over a batch axis of the mesh ('pod' on the
    multi-pod mesh, 'data' on either) has its gradient all-reduced over
    those axes (its shard's bytes).  Serve cells
    count none: prefill's weight gathers and decode's expert dispatch are
    not modelled, nor are the activation all-reduces under tensor
    parallelism or the MoE all-to-alls.  A lower bound."""
    batch = {a for a in BATCH_AXES if a in mesh.shape}
    nbytes = {k: 0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    for t, s in (_spec_pairs(params, pspecs) if train else ()):
        s = filter_pspec(s, mesh)
        used = {a for e in s for a in names_of(e)}
        shard = _shard_bytes(t, s, mesh)
        if used & batch:
            unbatched = P(*(tuple(a for a in names_of(e) if a not in batch) for e in s))
            nbytes["all-gather"] += 2 * _shard_bytes(t, unbatched, mesh)
            counts["all-gather"] += 2
            nbytes["reduce-scatter"] += shard
            counts["reduce-scatter"] += 1
        if batch - used:
            nbytes["all-reduce"] += shard
            counts["all-reduce"] += 1
    nbytes["total"] = sum(nbytes[k] for k in _COLLECTIVES)
    return nbytes, counts


def compute_dtype(params) -> str:
    """The floating dtype that holds most of the parameters' bytes: the
    one the step's products run in."""
    held = {}
    for t in leaves(params):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            k = str(t.dtype).removeprefix("torch.")
            held[k] = held.get(k, 0) + _nbytes(t)
    return max(held, key=held.get)


def roofline(per_device, dtype: str) -> dict:
    terms = {"compute_s": per_device["flops"] / PEAK_FLOPS[dtype],
             "memory_s": per_device["bytes_accessed"] / HBM_BW,
             "collective_s": per_device["collective_bytes"]["total"] / LINK_BW}
    return {**{k: float(v) for k, v in terms.items()},
            "bottleneck": max(terms, key=terms.get)}


def _per_device(totals, n_chips, coll, arg_bytes, out_bytes) -> dict:
    return {
        "flops": totals["flops"] / n_chips,
        "bytes_accessed": totals["bytes_accessed"] / n_chips,
        "collective_bytes": coll[0],
        "collective_counts": coll[1],
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "temp_bytes": None,
        "peak_bytes": None,
    }


def _save(record, multi_pod):
    os.makedirs(OUT_DIR, exist_ok=True)
    tag = "pod2" if multi_pod else "pod1"
    path = os.path.join(OUT_DIR, f"{record['arch']}__{record['shape']}__{tag}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


def run_cell(arch: str, shape: str, multi_pod: bool, save: bool = True,
             verbose: bool = True, unroll=None, cell=None) -> dict:
    from ..configs import make_dryrun_cell

    if unroll is None:
        unroll = not multi_pod
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = math.prod(mesh.shape.values())
    t0 = time.time()
    if cell is None:
        cell = make_dryrun_cell(arch, shape, unroll=unroll)
    t_build = time.time() - t0
    flops, nbytes, ops, out = account(cell.fn, cell.arg_specs)
    t_account = time.time() - t0 - t_build

    totals = {"flops": int(flops), "bytes_accessed": int(nbytes), "aten_ops": ops}
    coll = collective_model(cell.arg_specs[0], cell.in_specs[0], mesh, cell.kind == "train")
    dtype = compute_dtype(cell.arg_specs[0])
    per_device = _per_device(totals, n_chips, coll,
                             tree_shard_bytes(cell.arg_specs, cell.in_specs, mesh),
                             tree_shard_bytes(out, cell.out_specs, mesh))
    record = {
        "arch": arch,
        "shape": shape,
        "mesh": list(mesh.shape.values()),
        "axes": list(mesh.shape),
        "n_chips": int(n_chips),
        "kind": cell.kind,
        "unrolled": bool(unroll),
        "note": cell.note,
        "lower_s": round(t_build, 2),
        "compile_s": None,
        "account_s": round(t_account, 2),
        "device": DEVICE,
        "compute_dtype": dtype,
        "peak_flops": PEAK_FLOPS[dtype],
        "bytes_model": BYTES_MODEL,
        "collective_model": COLLECTIVE_MODEL,
        "totals": totals,
        "per_device": per_device,
        "roofline": roofline(per_device, dtype),
    }
    if verbose:
        r = record["roofline"]
        print(f"=== {arch} × {shape} on {record['mesh']} "
              f"({'multi-pod' if multi_pod else 'single-pod'}) ===")
        print(f"  cell {t_build:.2f}s, meta account {t_account:.2f}s ({ops} aten ops)")
        print(f"  per device: args={per_device['argument_bytes']} "
              f"out={per_device['output_bytes']} flops={per_device['flops']:.3e} "
              f"bytes={per_device['bytes_accessed']:.3e}")
        print(f"  collectives (params only): {coll[0]['total']:.3e} B {coll[1]}")
        print(f"  roofline terms (s): compute={r['compute_s']:.4e} "
              f"memory={r['memory_s']:.4e} collective={r['collective_s']:.4e} "
              f"→ bottleneck={r['bottleneck']}")
    if save:
        _save(record, multi_pod)
    return record


# the LM architectures' config modules
LM_CONFIG_MODULES = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "stablelm-3b": "stablelm_3b",
    "glm4-9b": "glm4_9b",
}


def run_cell_extrapolated(arch: str, shape: str, multi_pod: bool = False,
                          save: bool = True, build=None, n_layers=None) -> dict:
    """The reference's accounting for deep LM configs: 1-layer and 2-layer
    probes, per-layer cost = c2 − c1 (flops, bytes, collective bytes and
    counts, argument and output bytes: all layer-linear), total = c1 +
    (L−1)·per-layer.  ``build(n_layers)`` makes a probe's cell (by default
    the registry's, depth overridden); ``n_layers`` is L (by default the
    config's).  Recorded with accounting="extrapolated"."""
    from ..configs import make_dryrun_cell

    if build is None:
        def build(nl):
            return make_dryrun_cell(arch, shape, unroll=True, n_layers_override=nl)
    if n_layers is None:
        n_layers = importlib.import_module(f"..configs.{LM_CONFIG_MODULES[arch]}",
                                           __package__).FULL.n_layers
    L = n_layers

    print(f"--- extrapolated accounting for {arch} × {shape} (L={L})")
    probes = {nl: run_cell(arch, shape, multi_pod, save=False, verbose=False, unroll=True,
                           cell=build(nl)) for nl in (1, 2)}

    def combine(c1, c2):
        if isinstance(c1, dict):
            return {k: combine(c1[k], c2[k]) for k in c1}
        if not isinstance(c1, int):
            return c1
        return c1 + (L - 1) * (c2 - c1)

    rec = dict(probes[1])
    rec["accounting"] = "extrapolated(probe1,probe2)"
    totals = {k: combine(probes[1]["totals"][k], probes[2]["totals"][k])
              for k in ("flops", "bytes_accessed", "aten_ops")}
    pd1, pd2 = probes[1]["per_device"], probes[2]["per_device"]
    rec["totals"] = totals
    rec["per_device"] = _per_device(
        totals, rec["n_chips"],
        (combine(pd1["collective_bytes"], pd2["collective_bytes"]),
         combine(pd1["collective_counts"], pd2["collective_counts"])),
        combine(pd1["argument_bytes"], pd2["argument_bytes"]),
        combine(pd1["output_bytes"], pd2["output_bytes"]))
    rec["roofline"] = roofline(rec["per_device"], rec["compute_dtype"])
    r = rec["roofline"]
    print(f"  roofline terms (s): compute={r['compute_s']:.4e} "
          f"memory={r['memory_s']:.4e} collective={r['collective_s']:.4e} "
          f"→ bottleneck={r['bottleneck']}")
    if save:
        _save(rec, multi_pod)
    return rec


# archs the reference extrapolates (its unrolled full-depth HLO is too large
# to compile on one CPU core); kept as its method
EXTRAPOLATE = {"qwen3-moe-235b-a22b"}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--keep-going", action="store_true")
    args = ap.parse_args()

    from ..configs import list_cells

    if args.list:
        for a, s in list_cells():
            print(f"{a:26s} {s}")
        return

    cells = (
        list_cells() if args.all
        else [(args.arch, args.shape)] if args.shape
        else [(args.arch, s) for a, s in list_cells() if a == args.arch]
    )
    t0 = time.time()
    failures = []
    for a, s in cells:
        try:
            if a in EXTRAPOLATE and not args.multi_pod:
                run_cell_extrapolated(a, s, args.multi_pod)
            else:
                run_cell(a, s, args.multi_pod)
        except Exception as e:  # noqa: BLE001
            failures.append((a, s, repr(e)))
            traceback.print_exc()
            if not args.keep_going:
                raise
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print(f"DRYRUN_OK ({len(cells)} cells, "
          f"{'multi-pod' if args.multi_pod else 'single-pod'}, {time.time() - t0:.1f} s)")


if __name__ == "__main__":
    main()
