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
* ``intersect_batch`` — tc's oriented sorted-intersection count.

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

On an out-of-core graph (``core/tiered.py``: a ``TieredGraph``, or the
``StagedShards`` of a streamed stretch) ``push_dense`` and ``pull_dense``
stream the shards the mask needs through the device buffer pool, and
``sparse_round`` lowers to that masked push: the schedule already is the
frontier's shard set.  On a ``ShardedGraph`` (``core/sharded.py``: edge
shards on the virtual mesh) every operator dispatches to the graph's
``sharded_*`` method: shard-local relaxes, one cross-position reduction,
the merge; ``advance_sparse`` returns a ``ShardedEdgeBatch`` whose budget
is per shard, and ``sparse_round`` runs the per-shard ladder (each shard
escalating alone).  Deterministic adds go to ``sharded_det_*``.
The batched operators (``batched_push_dense``, ``batched_relax_batch``,
and their in-place forms ending in ``_``: core/multisource.py) relax B
lanes of (B, n_pad) labels over one read of the edge list.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..kernels import graph_ops as gk
from ..kernels.graph_ops import neutral_for, scatter_reduce  # noqa: F401 (re-export)
from . import frontier as fr
from .frontier import SparseFrontier
from .graph import Graph, set_at

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
    if getattr(g, "is_tiered", False):
        raise NotImplementedError(
            f"{what} has no out-of-core branch: on a tiered graph only "
            "push_dense, pull_dense and sparse_round stream shards")
    if not isinstance(g, Graph):
        raise TypeError(f"{what} takes a Graph, a tiered graph or a ShardedGraph, "
                        f"not {type(g).__name__}")


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
    tiered = getattr(g, "tiered_push_dense", None)
    if tiered is not None:
        # out of core: stream the shards the mask touches, folded in
        # ascending shard order (pool-size independent)
        return tiered(src_val, active, out_init, kind, use_weight, sub,
                      reverse=reverse, det=kind == "add" and _deterministic_add)
    sharded = getattr(g, "sharded_push_dense", None)
    if sharded is not None:
        if kind == "add" and _deterministic_add:
            # the canonical fixed-order tree over the flat edge list
            return g.sharded_det_push(src_val, active, out_init, use_weight, reverse)
        return sharded(src_val, active, out_init, kind, use_weight, sub, reverse)
    _single_graph(g, "push_dense")
    s, d = (g.col_idx, g.src_idx) if reverse else (g.src_idx, g.col_idx)
    if kind == "add" and _deterministic_add:
        return gk.det_push_ref(s, d, g.edge_w, src_val, active, out_init,
                               use_weight)
    if sub == "cuda":
        # the reversed sweep scatters into the sorted src list: pull's shape
        return gk.edge_relax(s, d, g.edge_w, active, src_val, out_init,
                             kind=kind, use_weight=use_weight, vertex_mask=True,
                             case="pull" if reverse else "push")
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
    tiered = getattr(g, "tiered_pull_dense", None)
    if tiered is not None:
        # out of core: stream the CSC mirror's shards (raises without one)
        return tiered(src_val, active, out_init, kind, use_weight, sub,
                      det=kind == "add" and _deterministic_add)
    if getattr(g, "is_tiered", False):
        raise NotImplementedError(
            "this tiered container holds only staged out-edge shards; "
            "pull runs on the TieredGraph itself (eager rounds), not "
            "inside a staged stretch")
    sharded = getattr(g, "sharded_pull_dense", None)
    if sharded is not None:
        if kind == "add" and _deterministic_add:
            return g.sharded_det_pull(src_val, active, out_init, use_weight)
        return sharded(src_val, active, out_init, kind, use_weight, sub)
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
                             use_weight=use_weight, vertex_mask=True,
                             case="pull")
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
    """Merge-path expansion of a sparse frontier into ≤ budget edge slots
    (on a ``ShardedGraph`` ≤ budget per shard: a ``ShardedEdgeBatch``)."""
    sub = _resolve(substrate)
    sharded = getattr(g, "sharded_advance", None)
    if sharded is not None:
        return sharded(f, budget, sub)
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
    sharded = getattr(batch, "sharded_relax", None)
    if sharded is not None:
        if kind == "add" and _deterministic_add:
            return batch.sharded_det_relax(src_val, out_init, use_weight)
        return sharded(src_val, out_init, kind, use_weight, sub)
    if kind == "add" and _deterministic_add:
        return gk.det_relax_ref(batch.src, batch.dst, batch.w, batch.valid,
                                src_val, out_init, use_weight)
    if sub == "cuda":
        return gk.edge_relax(batch.src, batch.dst, batch.w, batch.valid,
                             src_val, out_init, kind=kind,
                             use_weight=use_weight, vertex_mask=False,
                             case="batch")
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
    sharded = getattr(g, "sharded_relax_edges", None)
    if sharded is not None:
        if kind == "add" and _deterministic_add:
            return g.sharded_det_relax_edges(src_val, edge_mask, out_init, use_weight)
        return sharded(src_val, edge_mask, out_init, kind, use_weight, sub)
    _single_graph(g, "relax_edges")
    if kind == "add" and _deterministic_add:
        return gk.det_relax_ref(g.src_idx, g.col_idx, g.edge_w, edge_mask,
                                src_val, out_init, use_weight)
    if sub == "cuda":
        return gk.edge_relax(g.src_idx, g.col_idx, g.edge_w, edge_mask,
                             src_val, out_init, kind=kind,
                             use_weight=use_weight, vertex_mask=False,
                             case="edges")
    return gk.relax_ref(g.src_idx, g.col_idx, g.edge_w, edge_mask, src_val,
                        out_init, kind, use_weight)


def _det_lanes_(relax, src_val, masks, out, reseed, changed):
    """Deterministic add, lane by lane, into ``out``: ``relax(mask, src_val,
    seed)`` for each lane's row (with ``reseed``, ``src_val`` is the seed)."""
    if changed is not None:
        raise ValueError("a sum has no changed lanes: changed is for min, max and or")
    if reseed:
        out.copy_(src_val)
    return out.copy_(torch.stack([relax(k, v, o) for k, v, o in zip(masks, src_val, out)]))


def batched_push_dense(
    g: Graph,
    src_val: torch.Tensor,
    active: torch.Tensor,
    out_init: torch.Tensor,
    kind: str = "min",
    use_weight: bool = True,
    substrate: str | None = None,
) -> torch.Tensor:
    """Multi-source ``push_dense``: relax every edge once for B lanes.

    ``src_val`` / ``active`` / ``out_init`` are (B, n_pad) lane matrices
    (row b = lane b's labels / frontier / accumulator).  The edge list is
    read ONCE per sweep for all B lanes (the MS-BFS amortisation,
    core/multisource.py).  Per lane the result is bitwise ``push_dense``'s
    on that lane's row:

    * cuda  — the ``edge_relax_lanes`` kernel over the CSR;
    * torch — ``batched_push_ref`` (axis-1 scatter, shared dst vector);
    * det add — the fixed-order tree, lane by lane.

    Tiered (out-of-core) graphs are refused: serving batches run on
    resident graphs.  Out of place: ``batched_push_dense_`` into a copy of
    ``out_init``."""
    return batched_push_dense_(g, src_val, active, out_init.clone(), kind, use_weight,
                               substrate, beyond=gk.lanes_beyond(out_init, kind))


def batched_push_dense_(
    g: Graph,
    src_val: torch.Tensor,
    active: torch.Tensor,
    out: torch.Tensor,
    kind: str = "min",
    use_weight: bool = True,
    substrate: str | None = None,
    *,
    reseed: bool = False,
    changed: torch.Tensor | None = None,
    beyond: torch.Tensor | None = None,
) -> torch.Tensor:
    """``batched_push_dense`` in place: ``out`` holds the seeds (with
    ``reseed``, ``src_val`` is copied into it first) and becomes the
    result; ``changed`` (min, max, or), an all-False (B, n_pad) bool
    matrix, receives where a label moved (``batched_updated_mask``);
    ``beyond`` as ``edge_relax_lanes_``'s.  ``src_val`` must be another
    buffer.  The plain version on the torch substrate, the kernel on the
    cuda one."""
    sub = _resolve(substrate)
    if getattr(g, "is_tiered", False):
        raise NotImplementedError(
            "batched multi-source relax needs the whole CSR resident; "
            "the tiered streaming path is per-query")
    sharded = getattr(g, "sharded_batched_push", None)
    if sharded is not None:
        # out of place on the mesh (one neutral accumulator per shard, one
        # full-mesh reduce), then written into out; the changed lanes are
        # batched_updated_mask's
        seed = src_val if reseed else out.clone()
        if kind == "add" and _deterministic_add:
            if changed is not None:
                raise ValueError("a sum has no changed lanes: changed is for min, max and or")
            new = g.sharded_batched_det_push(src_val, active, seed, use_weight)
        else:
            new = sharded(src_val, active, seed, kind, use_weight, sub)
        if changed is not None:
            changed.copy_(batched_updated_mask(seed, new))
        return out.copy_(new)
    _single_graph(g, "batched_push_dense")
    if kind == "add" and _deterministic_add:
        return _det_lanes_(lambda a, v, o: gk.det_push_ref(
            g.src_idx, g.col_idx, g.edge_w, v, a, o, use_weight), src_val, active, out,
            reseed, changed)
    if sub == "cuda":
        return gk.edge_relax_lanes_(g.src_idx, g.col_idx, g.edge_w, active, src_val, out,
                                    kind=kind, use_weight=use_weight, reseed=reseed,
                                    changed=changed, beyond=beyond)
    return gk.batched_relax_into_ref(g.src_idx, g.col_idx, g.edge_w, None, src_val,
                                     active, out, kind, use_weight, reseed=reseed,
                                     changed=changed)


def batched_relax_batch(
    batch: EdgeBatch,
    src_val: torch.Tensor,
    active: torch.Tensor,
    out_init: torch.Tensor,
    kind: str = "min",
    use_weight: bool = True,
    substrate: str | None = None,
) -> torch.Tensor:
    """Multi-source ``relax_batch``: one sparse advance (over the lanes'
    *union* frontier) relaxed for B lanes at once.  A slot fires in lane b
    iff it is valid AND its source is active in lane b's row, which
    restores exactly lane b's message multiset, so each row is bitwise the
    single-lane sparse round's.  Out of place: ``batched_relax_batch_``
    into a copy of ``out_init``."""
    return batched_relax_batch_(batch, src_val, active, out_init.clone(), kind, use_weight,
                                substrate, beyond=gk.lanes_beyond(out_init, kind))


def batched_relax_batch_(
    batch: EdgeBatch,
    src_val: torch.Tensor,
    active: torch.Tensor,
    out: torch.Tensor,
    kind: str = "min",
    use_weight: bool = True,
    substrate: str | None = None,
    *,
    at: torch.Tensor | None = None,
    reseed: bool = False,
    changed: torch.Tensor | None = None,
    beyond: torch.Tensor | None = None,
) -> torch.Tensor:
    """``batched_relax_batch`` in place, as ``batched_push_dense_``.
    ``at``: the int32 union the batch was advanced from (a compacted
    frontier's ``idx``): the kernel packs lane words there only and, with
    ``reseed``, copies ``src_val`` into ``out`` at those columns and the
    sentinel column only — O(|union| B), not O(B n_pad)."""
    sub = _resolve(substrate)
    if hasattr(batch, "sharded_relax"):
        raise ValueError("batched sparse rounds are single-partition: sharded "
                         "lanes relax dense (batched_push_dense)")
    if kind == "add" and _deterministic_add:
        return _det_lanes_(lambda k, v, o: gk.det_relax_ref(
            batch.src, batch.dst, batch.w, k, v, o, use_weight), src_val,
            batch.valid & active[:, batch.src], out, reseed, changed)
    if sub == "cuda":
        return gk.edge_relax_lanes_(batch.src, batch.dst, batch.w, active, src_val, out,
                                    valid=batch.valid, kind=kind, use_weight=use_weight,
                                    at=at, reseed=reseed, changed=changed, beyond=beyond)
    return gk.batched_relax_into_ref(batch.src, batch.dst, batch.w, batch.valid, src_val,
                                     active, out, kind, use_weight, at=at, reseed=reseed,
                                     changed=changed)


def batched_updated_mask(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Per-lane ``updated_mask``: (B, n_pad) rows of changed labels."""
    m = new != old
    m[:, -1].fill_(False)  # sentinel never activates
    return m


def intersect_batch(
    adj: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    *,
    sentinel: int,
    substrate: str | None = None,
    chunk: int | None = None,
) -> torch.Tensor:
    """Oriented sorted-intersection count for a batch of oriented edges —
    triangle counting's operator.  ``adj`` is the (n_pad, dmax) sorted
    oriented adjacency (sentinel-padded rows, ``adj[sentinel]`` all
    sentinel), ``src``/``dst`` the oriented endpoints (sentinel on padding
    slots).  Returns the exact int32 sum of |N+(src_i) ∩ N+(dst_i)| as a
    0-d tensor on the device, bitwise equal across substrates; with
    ``chunk``, the (ceil(e / chunk),) int32 sums of each slice of ``chunk``
    edges."""
    sub = _resolve(substrate)
    if sub == "cuda":
        return gk.intersect_count(adj, src, dst, sentinel=sentinel, chunk=chunk)
    if chunk is None:
        return gk.intersect_ref(adj, src, dst, sentinel)
    return gk.intersect_chunks_ref(adj, src, dst, sentinel, chunk)


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
    ``(new_out, escalated_shards)``; the count is 0 on a single partition.
    On a tiered graph the round is the masked push over the frontier's
    shards: the shards never fetched are the saving, and a worklist would
    buy nothing more.  On a ``ShardedGraph`` the round is the per-shard
    ladder (``ShardedGraph.sharded_sparse_round``) and the count a 0-d
    int32 on the device: the shards that escalated to their local dense
    relax.  Under deterministic add a sharded round is the masked dense
    push (the one canonical edge order; the same messages)."""
    sub = _resolve(substrate)
    if getattr(g, "is_tiered", False):
        return push_dense(g, src_val, mask, out_init, kind, use_weight, sub), 0
    fused = getattr(g, "sharded_sparse_round", None)
    if fused is not None:
        if kind == "add" and _deterministic_add:
            return push_dense(g, src_val, mask, out_init, kind, use_weight, sub), 0
        return fused(src_val, mask, out_init, kind, use_weight, capacity, budget, sub)
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
    return set_at(new != old, -1, False)  # sentinel never activates
