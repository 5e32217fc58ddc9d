"""Architecture registry: 10 architectures × their shape sets = 40 cells,
as ``repro.configs.registry``.

Each cell resolves to a ``DryrunCell``: a step function, its positional
arguments as meta tensors (the reference's ``ShapeDtypeStruct``s: shapes
and dtypes, never allocated) and ``P`` sharding specs, consumed by
``launch/dryrun.py`` (the meta-tensor account) and the roofline rows.
Smoke tests use the reduced configs via ``smoke_step(device=None)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from ..optim.adamw import _leaves as leaves  # noqa: F401

LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
RECSYS_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")


@dataclasses.dataclass
class DryrunCell:
    arch: str
    shape: str
    kind: str                      # 'train' | 'serve'
    fn: Callable                   # positional-args step function
    arg_specs: tuple               # tree of meta tensors per positional arg
    in_specs: tuple                # tree of P per positional arg
    out_specs: object              # tree of P
    donate: Tuple[int, ...] = ()
    note: str = ""


@dataclasses.dataclass
class ArchSpec:
    arch_id: str
    family: str                    # 'lm' | 'gnn' | 'recsys'
    shapes: Tuple[str, ...]
    build_cell: Callable[[str], DryrunCell]
    smoke_step: Callable[..., dict]  # runs the reduced config on ``device``, returns metrics
    description: str = ""


ARCHS: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec):
    ARCHS[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]


def list_cells():
    _ensure_loaded()
    return [(a, s) for a, spec in sorted(ARCHS.items()) for s in spec.shapes]


def make_dryrun_cell(arch_id: str, shape: str, **opts) -> DryrunCell:
    spec = get_arch(arch_id)
    if shape not in spec.shapes:
        raise KeyError(f"{arch_id} has shapes {spec.shapes}, not {shape!r}")
    return spec.build_cell(shape, **opts)


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (  # noqa: F401
        qwen3_moe_235b, deepseek_moe_16b, h2o_danube3_4b, stablelm_3b,
        glm4_9b, nequip, mace, egnn, gcn_cora, mind,
    )
