"""Edge relaxation operators: push, pull, and load-balanced sparse advance.

The operator layer of ``repro.core.operators``, single-``Graph`` branches:

* ``push_dense``  — relax every edge whose source is active (O(m));
  ``reverse=True`` gathers at the destination and scatters into the source.
* ``pull_dense``  — relax over in-edges (CSC required).
* ``advance_sparse`` — merge-path expansion of a ``SparseFrontier`` into a
  ``budget`` of edge slots, so a hub and a leaf cost the same per slot.
* ``relax_batch`` / ``relax_edges`` — relax an ``EdgeBatch`` or the full
  out-edge list under a per-slot validity mask.
* ``sparse_round`` — compact → advance → relax.
* ``direction_choice`` — Beamer's α/β heuristic.

Every relaxation lowers through a **substrate**:

* ``"cuda"`` (the default) — the hand-written kernels of
  ``kernels/graph_ops``.  On CUDA tensors they launch or raise; on CPU
  tensors their wrappers take the plain version.
* ``"torch"`` — the plain torch version (``kernels/graph_ops/ref.py``) on
  any device, used when asked for explicitly.

Select with ``set_substrate`` / ``substrate_scope`` or per call with
``substrate=``.  No environment variable selects it.
``set_deterministic_add(True)`` routes every ``kind="add"`` reduction
through the fixed-order ``det_scatter_add`` (plain torch) on both
substrates, so float sums are bitwise reproducible.

The tiered, sharded and batched branches and ``intersect_batch`` belong to
later slices of the port; they raise ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..kernels import graph_ops as gk
from ..kernels.graph_ops import neutral_for, scatter_reduce  # noqa: F401 (re-export)
from . import frontier as fr
from .frontier import SparseFrontier
from .graph import Graph

SUBSTRATES = ("torch", "cuda")
DEFAULT_SUBSTRATE = "cuda"
_substrate = DEFAULT_SUBSTRATE
_deterministic_add = False


def set_substrate(name: str) -> None:
    """Select the engine-wide relaxation substrate ("cuda" or "torch")."""
    global _substrate
    if name not in SUBSTRATES:
        raise ValueError(f"unknown substrate {name!r}; pick from {SUBSTRATES}")
    _substrate = name


def get_substrate() -> str:
    return _substrate


@contextlib.contextmanager
def substrate_scope(name: str):
    """Temporarily select a substrate: ``with substrate_scope("torch"): ...``"""
    prev = get_substrate()
    set_substrate(name)
    try:
        yield
    finally:
        set_substrate(prev)


def _resolve(substrate) -> str:
    if substrate is None:
        return _substrate
    if substrate not in SUBSTRATES:
        raise ValueError(f"unknown substrate {substrate!r}; pick from {SUBSTRATES}")
    return substrate


def run_substrate(g, substrate: str | None = None) -> str:
    """What a relaxation on ``g`` actually runs: ``"cuda"`` only when the
    kernels launch (cuda substrate, graph on a CUDA device)."""
    sub = _resolve(substrate)
    return "cuda" if sub == "cuda" and g.device.type == "cuda" else "torch"


def set_deterministic_add(on: bool) -> None:
    """Route every ``kind="add"`` relaxation (all substrates) through the
    fixed-order segmented tree reduction."""
    global _deterministic_add
    _deterministic_add = bool(on)


def get_deterministic_add() -> bool:
    return _deterministic_add


@contextlib.contextmanager
def deterministic_add_scope(on: bool = True):
    prev = _deterministic_add
    set_deterministic_add(on)
    try:
        yield
    finally:
        set_deterministic_add(prev)


def _single_graph(g, what: str):
    if not isinstance(g, Graph):
        raise NotImplementedError(
            f"{what} on tiered or sharded graphs is not ported yet "
            "(ROADMAP queue 1: out-of-core, multi-device)")


def push_dense(
    g: Graph,
    src_val: torch.Tensor,
    active: torch.Tensor,
    out_init: torch.Tensor,
    kind: str = "min",
    use_weight: bool = True,
    substrate: str | None = None,
    reverse: bool = False,
) -> torch.Tensor:
    """Relax every edge whose source is active.  ``reverse=True`` pushes
    along the reversed edges (gather at dst, scatter into src)."""
    sub = _resolve(substrate)
    _single_graph(g, "push_dense")
    s, d = (g.col_idx, g.src_idx) if reverse else (g.src_idx, g.col_idx)
    if kind == "add" and _deterministic_add:
        return gk.det_push_ref(s, d, g.edge_w, src_val, active, out_init,
                               use_weight)
    if sub == "cuda":
        return gk.edge_relax(s, d, g.edge_w, active, src_val, out_init,
                             kind=kind, use_weight=use_weight, vertex_mask=True)
    return gk.push_ref(s, d, g.edge_w, src_val, active, out_init, kind,
                       use_weight)


def pull_dense(
    g: Graph,
    src_val: torch.Tensor,
    active: torch.Tensor,
    out_init: torch.Tensor,
    kind: str = "min",
    use_weight: bool = True,
    substrate: str | None = None,
) -> torch.Tensor:
    """Pull-style relax over in-edges: each vertex reduces over its
    in-neighbours.  Requires CSC."""
    sub = _resolve(substrate)
    _single_graph(g, "pull_dense")
    if not g.has_csc:
        raise ValueError("pull_dense requires build_csc=True")
    if kind == "add" and _deterministic_add:
        # pull ≡ push over the in-edge list (nbr → dst); same fixed order
        return gk.det_push_ref(g.in_col_idx, g.in_src_idx, g.in_edge_w,
                               src_val, active, out_init, use_weight)
    if sub == "cuda":
        return gk.edge_relax(g.in_col_idx, g.in_src_idx, g.in_edge_w, active,
                             src_val, out_init, kind=kind,
                             use_weight=use_weight, vertex_mask=True)
    return gk.pull_ref(g.in_col_idx, g.in_src_idx, g.in_edge_w, src_val,
                       active, out_init, kind, use_weight)


@dataclasses.dataclass(frozen=True)
class EdgeBatch:
    """Result of a sparse advance: ``budget`` edge slots."""

    src: torch.Tensor     # (budget,) int32
    dst: torch.Tensor     # (budget,) int32
    w: torch.Tensor       # (budget,) float32
    valid: torch.Tensor   # (budget,) bool
    total: torch.Tensor   # () int32 — true number of frontier edges


def advance_sparse(g: Graph, f: SparseFrontier, budget: int,
                   substrate: str | None = None) -> EdgeBatch:
    """Merge-path expansion of a sparse frontier into ≤ budget edge slots."""
    sub = _resolve(substrate)
    _single_graph(g, "advance_sparse")
    fn = gk.advance_frontier if sub == "cuda" else gk.advance_ref
    kw = dict(budget=budget, sentinel=g.sentinel, m_pad=g.m_pad)
    src, dst, w, valid, total = fn(f.idx, f.count, g.out_deg, g.row_ptr,
                                   g.col_idx, g.edge_w, **kw)
    return EdgeBatch(src=src, dst=dst, w=w, valid=valid, total=total)


def relax_batch(
    batch: EdgeBatch,
    src_val: torch.Tensor,
    out_init: torch.Tensor,
    kind: str = "min",
    use_weight: bool = True,
    substrate: str | None = None,
) -> torch.Tensor:
    """Apply a relaxation over an EdgeBatch (sparse counterpart of push_dense)."""
    sub = _resolve(substrate)
    if kind == "add" and _deterministic_add:
        return gk.det_relax_ref(batch.src, batch.dst, batch.w, batch.valid,
                                src_val, out_init, use_weight)
    if sub == "cuda":
        return gk.edge_relax(batch.src, batch.dst, batch.w, batch.valid,
                             src_val, out_init, kind=kind,
                             use_weight=use_weight, vertex_mask=False)
    return gk.relax_ref(batch.src, batch.dst, batch.w, batch.valid, src_val,
                        out_init, kind, use_weight)


def relax_edges(
    g: Graph,
    src_val: torch.Tensor,
    edge_mask: torch.Tensor,
    out_init: torch.Tensor,
    kind: str = "min",
    use_weight: bool = True,
    substrate: str | None = None,
) -> torch.Tensor:
    """Relax the full out-edge list under a per-edge validity mask
    (delta-stepping's light/heavy split)."""
    sub = _resolve(substrate)
    _single_graph(g, "relax_edges")
    if kind == "add" and _deterministic_add:
        return gk.det_relax_ref(g.src_idx, g.col_idx, g.edge_w, edge_mask,
                                src_val, out_init, use_weight)
    if sub == "cuda":
        return gk.edge_relax(g.src_idx, g.col_idx, g.edge_w, edge_mask,
                             src_val, out_init, kind=kind,
                             use_weight=use_weight, vertex_mask=False)
    return gk.relax_ref(g.src_idx, g.col_idx, g.edge_w, edge_mask, src_val,
                        out_init, kind, use_weight)


def batched_push_dense(*args, **kwargs):
    raise NotImplementedError(
        "multi-source batched relax is not ported yet "
        "(ROADMAP queue 1: multi-source + serving)")


batched_relax_batch = batched_push_dense


def intersect_batch(*args, **kwargs):
    raise NotImplementedError(
        "intersect_batch (tc) is not ported yet "
        "(ROADMAP queue 2: _intersect_kernel)")


def sparse_round(
    g: Graph,
    src_val: torch.Tensor,
    mask: torch.Tensor,
    out_init: torch.Tensor,
    kind: str = "min",
    use_weight: bool = True,
    *,
    capacity: int,
    budget: int,
    substrate: str | None = None,
):
    """One data-driven round: compact → advance → relax.  Returns
    ``(new_out, escalated_shards)``; the count is 0 on a single partition."""
    sub = _resolve(substrate)
    _single_graph(g, "sparse_round")
    f = fr.compact(mask, capacity, g.sentinel)
    batch = advance_sparse(g, f, budget, sub)
    return relax_batch(batch, src_val, out_init, kind, use_weight, sub), 0


def direction_choice(
    g: Graph,
    frontier_edges: torch.Tensor,
    unvisited_edges: torch.Tensor,
    frontier_count: torch.Tensor,
    currently_pull: torch.Tensor,
    alpha: float = 14.0,
    beta: float = 24.0,
) -> torch.Tensor:
    """Beamer's direction-optimizing heuristic: True for "pull this round"."""
    go_pull = frontier_edges > unvisited_edges / alpha
    go_push = frontier_count < g.n / beta
    return torch.where(currently_pull, ~go_push, go_pull)


def updated_mask(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    m = new != old
    m[-1] = False  # sentinel never activates
    return m
