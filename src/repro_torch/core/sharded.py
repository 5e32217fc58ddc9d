"""The sharded execution path on the port's virtual mesh, as in
``repro.core.sharded``.

``shard_graph`` turns a ``Graph`` into a ``ShardedGraph``: D edge shards
from ``partition_1d`` / ``partition_2d``, homed by a ``placement.py``
policy, with each shard's CSR metadata.  ``core.operators`` dispatches
``push_dense`` / ``pull_dense`` / ``advance_sparse`` / ``relax_batch`` /
``relax_edges`` / ``sparse_round`` / ``batched_push_dense`` here when it
is handed a ``ShardedGraph``, so ``SparseLadderEngine``, ``run_dense``,
the multi-source engine and every algorithm run on it unmodified.

The mesh (``core/mesh.py``) is D positions on one device: shard d's arrays
are row d of (D, ...) tensors, and the collectives are tensor reductions
over that axis (``core/collectives.py``).  Every sharded relaxation has the
reference's three phases:

1. **shard-local relax** through the substrate seam (the ``edge_relax``
   kernel on the card, the plain version under ``"torch"``) into a
   neutral accumulator, one per shard;
2. **cross-position reduction** of the (D, n_pad) stack through a
   ``CrossReducer``;
3. **merge** with the caller's ``out_init``.

Reducers (the communication-avoiding structure of the partition):

* ``"cvc2d"`` — a ``partition_2d`` grid on a 2-axis mesh: shard (i, j)
  only updates vertices its grid column j owns, so each column's owned
  slice is reduced over its R shards, and the C reduced slices are
  gathered and scattered back.
* ``"owner1d"`` — a ``partition_1d`` cut: each shard's accumulator is laid
  out per owner (``placement.owner_layout``); the ``all_to_all`` is a
  transpose of the (D, D, L) contributions, each owner combines its D
  rows once, and the combined slices are gathered and scattered back.
* ``"full"`` — the full-mesh reduce, the comparison baseline.

A widened bool (uint8) keeps the caller's kind: a bool ``min`` stays a min.
The scatter back is a ``scatter_reduce`` into a neutral-filled vector, op
for op the reference's (under ``add`` it turns -0.0 into +0.0).  Min, max
and or are order-free, so every reducer is bitwise the unsharded relax.
Under ``operators.set_deterministic_add(True)`` an ``add`` re-orders the
flat edge list into the canonical (src, dst, w) order (three stable sorts:
torch has no lexsort) and runs the fixed-order tree on it: bitwise across
every (placement, ndev) cell and equal to the unsharded deterministic
path.  The order is a pure function of the graph, so each graph keeps its
permutations.

A sparse round (``sharded_sparse_round``) compacts every shard's local
frontier in one pass (``frontier.compact_local``), then per shard launches
the merge-path advance and two gated relaxes: the sparse relax of the
advance's batch, gated on the shard NOT escalating, and the dense relax of
its masked edges, gated on it escalating (a worklist or edge mass past the
rung).  The gate is a 0-d int32 on the device (``edge_relax``'s ``gate``):
a captured round cannot branch on the host, and the relax that is off
seeds its output and returns.  The escalation count comes back as a device
int32 the engine carries through a stretch.

``comm_per_relax`` is the analytic model the engines charge to
``RunStats.comm_elems`` / ``comm_bytes`` / ``reduce_axis_hops``: a
collective over a K-position group with per-member payload L costs
K·(K−1)·L element-hops, whatever the mode.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..kernels import graph_ops as gk
from .collectives import kind_reduce, local_relax, merge
from .frontier import SparseFrontier, compact_local
from .graph import Graph
from .mesh import Mesh, num_positions
from .partition import PartitionedGraph, partition_1d, partition_2d
from . import placement as pl


def _neutral(kind: str, dtype):
    return gk.neutral_for(kind, dtype).item()


@dataclasses.dataclass(frozen=True)
class CrossReducer:
    """Cross-position label reduction, keyed on the partition: ``mode``
    ``"full"``, ``"cvc2d"`` or ``"owner1d"``; ``own_idx`` / ``own_valid``
    the ``placement.owner_layout`` of the reduce-side ownership map (None
    for ``"full"``), one row per reduce group."""

    mode: str
    axes: Tuple[str, ...]
    rows: int
    cols: int
    own_idx: Optional[torch.Tensor] = None    # (groups, L) int32
    own_valid: Optional[torch.Tensor] = None  # (groups, L) bool

    @property
    def ndev(self) -> int:
        return self.rows * self.cols

    def _scatter_back(self, gathered, kind, n_pad, dtype):
        """The replicated (n_pad,) vector from the gathered owned slices:
        valid entries tile the vertices once, padding names the sentinel
        and carries the neutral."""
        neutral = _neutral(kind, dtype)
        vals = torch.where(self.own_valid.reshape(-1), gathered.reshape(-1), neutral)
        out = torch.full((n_pad,), neutral, dtype=dtype, device=gathered.device)
        return gk.scatter_reduce(self.own_idx.reshape(-1), vals, out, kind)

    def reduce(self, acc: torch.Tensor, kind: str) -> torch.Tensor:
        """The (D, n_pad) stack of per-shard accumulators reduced to the
        canonical (n_pad,) labels."""
        if self.mode == "full" or self.ndev == 1:
            return kind_reduce(acc, kind)
        widened = acc.dtype == torch.bool
        work = acc.to(torch.uint8) if widened else acc
        n_pad = work.shape[1]
        L = self.own_idx.shape[1]
        if self.mode == "cvc2d":
            R, C = self.rows, self.cols
            # shard (i, j)'s slice of column j's owned vertices
            part = torch.gather(work.view(R, C, n_pad), 2,
                                self.own_idx.long().unsqueeze(0).expand(R, C, L))
            red = kind_reduce(part, kind)            # over the column's R shards
        else:
            D = self.ndev
            contrib = work[:, self.own_idx.reshape(-1).long()].reshape(D, D, L)
            # all_to_all: owner k receives every shard's chunk k
            red = kind_reduce(contrib.transpose(0, 1), kind, dim=1)
        out = self._scatter_back(red, kind, n_pad, work.dtype)
        return out.to(torch.bool) if widened else out

    def comm_per_relax(self, n_pad: int, itemsize: int = 4):
        """``(elems, bytes, axis_hops)`` of one dense label reduction; the
        hops count the mesh axes the reduction (not the gather) crosses."""
        D = self.ndev
        if D <= 1:
            return 0, 0, 0
        if self.mode == "full":
            elems = D * (D - 1) * n_pad
            return elems, elems * itemsize, len(self.axes)
        L = int(self.own_idx.shape[1])
        if self.mode == "cvc2d":
            reduce_elems = self.cols * self.rows * (self.rows - 1) * L
            gather_elems = self.rows * self.cols * (self.cols - 1) * L
        else:
            reduce_elems = D * (D - 1) * L
            gather_elems = D * (D - 1) * L
        elems = reduce_elems + gather_elems
        return elems, elems * itemsize, 1


def _edge_scatter(red, e_src, e_dst, e_w, src_val, mask, out_init, kind, use_weight,
                  substrate, *, vertex_mask=True, case=None):
    """A relaxation over (D, epd) edge shards: ``mask`` is the replicated
    (n_pad,) vertex bitmap when ``vertex_mask``, else (D, epd) per-slot
    masks."""
    neutral = torch.full_like(out_init, _neutral(kind, out_init.dtype))
    acc = torch.stack([
        local_relax(e_src[d], e_dst[d], e_w[d], mask if vertex_mask else mask[d],
                    src_val, neutral, kind, use_weight, vertex_mask, substrate, case=case)
        for d in range(e_src.shape[0])])
    return merge(out_init, red.reduce(acc, kind), kind)


def canonical_order(src, dst, w) -> torch.Tensor:
    """The permutation ``np.lexsort((w, dst, src))`` gives: by src, then
    dst, then w, ties in input order (three stable sorts)."""
    order = torch.sort(w, stable=True).indices
    order = order[torch.sort(dst[order], stable=True).indices]
    return order[torch.sort(src[order], stable=True).indices]


def _det_add_flat(src, dst, w, src_val, out_init, use_weight, active=None,
                  valid=None, order=None):
    """Deterministic ``add`` over a flat edge list: re-ordered into the
    canonical (src, dst, w) order (``order``, when the caller keeps it),
    then the fixed-order tree (``det_scatter_add`` stable-sorts by dst), so
    the sums associate as the unsharded deterministic path's."""
    if order is None:
        order = canonical_order(src, dst, w)
    s, d, ww = src[order], dst[order], w[order]
    if valid is not None:
        return gk.det_relax_ref(s, d, ww, valid[order], src_val, out_init, use_weight)
    return gk.det_push_ref(s, d, ww, src_val, active, out_init, use_weight)


@dataclasses.dataclass(frozen=True)
class ShardedEdgeBatch:
    """A sparse advance on the mesh: ``budget`` slots *per shard*;
    ``totals`` the per-shard frontier edge mass, ``total`` their sum."""

    src: torch.Tensor      # (D, budget) int32
    dst: torch.Tensor
    w: torch.Tensor
    valid: torch.Tensor    # (D, budget) bool
    totals: torch.Tensor   # (D,) int32
    red: CrossReducer

    @property
    def total(self) -> torch.Tensor:
        return self.totals.sum(dtype=torch.int32)

    def sharded_relax(self, src_val, out_init, kind, use_weight, substrate):
        return _edge_scatter(self.red, self.src, self.dst, self.w, src_val, self.valid,
                             out_init, kind, use_weight, substrate, vertex_mask=False,
                             case="batch")

    def sharded_det_relax(self, src_val, out_init, use_weight):
        """Deterministic ``add`` over the batch's flat slots: the expanded
        edge multiset is partition-independent (padding slots carry exact
        zeros)."""
        return _det_add_flat(self.src.reshape(-1), self.dst.reshape(-1),
                             self.w.reshape(-1), src_val, out_init, use_weight,
                             valid=self.valid.reshape(-1))


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Edge-sharded graph that quacks like ``Graph`` for the engines:
    (D, epd) edge shards in (src, dst) order with each shard's CSR
    (``shard_row_ptr`` / ``shard_deg`` over global vertex ids); vertex
    arrays stay whole (the lookup side of the gathers).  ``red`` is the
    ``CrossReducer`` every relaxation reduces through."""

    n: int
    m: int
    n_pad: int
    block_size: int
    ndev: int
    epd: int
    scheme: str
    placement: str
    axes: Tuple[str, ...]
    mesh: Mesh

    src: torch.Tensor            # (D, epd) int32, sentinel-padded
    dst: torch.Tensor
    w: torch.Tensor
    shard_row_ptr: torch.Tensor  # (D, n_pad + 1)
    shard_deg: torch.Tensor      # (D, n_pad)
    out_deg: torch.Tensor        # (n_pad,) global

    in_nbr: Optional[torch.Tensor] = None   # (D, epd_in) in-neighbour
    in_dst: Optional[torch.Tensor] = None   # (D, epd_in) destination
    in_w: Optional[torch.Tensor] = None

    red: Optional[CrossReducer] = None
    # canonical-order permutations of the flat lists, per sweep
    _orders: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    # ---- Graph-compatible surface -----------------------------------------
    @property
    def sentinel(self) -> int:
        return self.n_pad - 1

    @property
    def m_pad(self) -> int:
        return self.ndev * self.epd

    @property
    def has_csc(self) -> bool:
        return self.in_nbr is not None

    @property
    def device(self) -> torch.device:
        return self.src.device

    def vertex_full(self, fill, dtype) -> torch.Tensor:
        return torch.full((self.n_pad,), fill, dtype=dtype, device=self.device)

    def valid_vertex_mask(self) -> torch.Tensor:
        return torch.arange(self.n_pad, device=self.device) < self.n

    # flat views, the same edge multiset as the CSR arrays (sentinel-padded
    # per shard): pointer-jump cc, delta-stepping and tc read them
    @property
    def src_idx(self) -> torch.Tensor:
        return self.src.reshape(-1)

    @property
    def col_idx(self) -> torch.Tensor:
        return self.dst.reshape(-1)

    @property
    def edge_w(self) -> torch.Tensor:
        return self.w.reshape(-1)

    @property
    def shard_bytes(self) -> int:
        """Device bytes of the shards (edges, CSR metadata, in-edges)."""
        arrays = [self.src, self.dst, self.w, self.shard_row_ptr, self.shard_deg]
        if self.has_csc:
            arrays += [self.in_nbr, self.in_dst, self.in_w]
        return sum(a.numel() * a.element_size() for a in arrays)

    def _reducer(self) -> CrossReducer:
        if self.red is not None:
            return self.red
        return CrossReducer(mode="full", axes=self.axes, rows=self.ndev, cols=1)

    def _reverse_safe_reducer(self) -> CrossReducer:
        """A reversed scatter lands on edge sources, the grid's row side:
        cvc2d would drop cross-column contributions, so it degrades to the
        full-mesh reduce (owner1d reduces the whole vector and stays)."""
        red = self._reducer()
        if red.mode == "cvc2d":
            return CrossReducer(mode="full", axes=red.axes, rows=red.rows, cols=red.cols)
        return red

    def comm_per_relax(self, itemsize: int = 4, reverse: bool = False):
        """``(elems, bytes, axis_hops)`` of one label reduction on this
        graph; ``reverse`` at the reverse-safe reducer's rate."""
        red = self._reverse_safe_reducer() if reverse else self._reducer()
        return red.comm_per_relax(self.n_pad, itemsize)

    def budget_edge_mass(self, mask: torch.Tensor) -> torch.Tensor:
        """The largest per-shard frontier edge mass: what a per-shard
        merge-path budget must cover."""
        return torch.where(mask.unsqueeze(0), self.shard_deg, 0).sum(
            1, dtype=torch.int32).max()

    def _order(self, key: str, src, dst, w) -> torch.Tensor:
        order = self._orders.get(key)
        if order is None:
            order = self._orders[key] = canonical_order(src, dst, w)
        return order

    # ---- sharded operators (operators.py dispatch) -------------------------
    def sharded_push_dense(self, src_val, active, out_init, kind, use_weight,
                           substrate, reverse=False):
        if reverse:
            # scatters into the shard's sorted src list: pull's layout
            return _edge_scatter(self._reverse_safe_reducer(), self.dst, self.src, self.w,
                                 src_val, active, out_init, kind, use_weight, substrate,
                                 case="pull")
        return _edge_scatter(self._reducer(), self.src, self.dst, self.w, src_val, active,
                             out_init, kind, use_weight, substrate, case="push")

    def sharded_batched_push(self, src_val, active, out_init, kind, use_weight,
                             substrate):
        """B lanes ((B, n_pad) matrices) over every shard, out of place:
        each shard's lanes relax into a neutral (B, n_pad) accumulator
        (``edge_relax_lanes`` on the card), the (D, B, n_pad) stack takes
        one full-mesh reduce (the structured reducers key on one label
        vector), and the result merges into ``out_init``."""
        acc = torch.full((self.ndev,) + tuple(out_init.shape),
                         _neutral(kind, out_init.dtype), dtype=out_init.dtype,
                         device=out_init.device)
        for d in range(self.ndev):
            if substrate == "cuda":
                gk.edge_relax_lanes_(self.src[d], self.dst[d], self.w[d], active, src_val,
                                     acc[d], kind=kind, use_weight=use_weight)
            else:
                gk.batched_relax_into_ref(self.src[d], self.dst[d], self.w[d], None,
                                          src_val, active, acc[d], kind, use_weight)
        return merge(out_init, kind_reduce(acc, kind), kind)

    def sharded_batched_det_push(self, src_val, active, out_init, use_weight):
        """Deterministic batched ``add``: the canonical fixed-order tree,
        lane by lane."""
        order = self._order("out", self.src_idx, self.col_idx, self.edge_w)
        return torch.stack([
            _det_add_flat(self.src_idx, self.col_idx, self.edge_w, v, o, use_weight,
                          active=a, order=order)
            for v, a, o in zip(src_val, active, out_init)])

    def batched_comm_per_relax(self, lanes: int, itemsize: int = 4):
        """``(elems, bytes, hops)`` of one batched reduce: the (lanes,
        n_pad) accumulator at the full-mesh rate."""
        d = self.ndev
        if d <= 1:
            return 0, 0, 0
        elems = d * (d - 1) * self.n_pad * lanes
        return elems, elems * itemsize, len(self.axes)

    def sharded_pull_dense(self, src_val, active, out_init, kind, use_weight, substrate):
        if not self.has_csc:
            raise ValueError("pull on a ShardedGraph needs shard_graph(g) of a Graph "
                             "built with build_csc=True")
        # an in-edge shard is in (in-neighbour, dst) order: a push's layout
        return _edge_scatter(self._reducer(), self.in_nbr, self.in_dst, self.in_w, src_val,
                             active, out_init, kind, use_weight, substrate, case="push")

    def sharded_det_push(self, src_val, active, out_init, use_weight, reverse=False):
        """Deterministic ``add`` push over the flat out-edge views;
        ``reverse`` swaps the endpoint roles (the canonical order keys on
        the new roles)."""
        s, d = ((self.col_idx, self.src_idx) if reverse
                else (self.src_idx, self.col_idx))
        order = self._order("rev" if reverse else "out", s, d, self.edge_w)
        return _det_add_flat(s, d, self.edge_w, src_val, out_init, use_weight,
                             active=active, order=order)

    def sharded_relax_edges(self, src_val, edge_mask, out_init, kind, use_weight,
                            substrate):
        """The full edge list under an (m_pad,) per-slot mask aligned with
        the flat views."""
        return _edge_scatter(self._reducer(), self.src, self.dst, self.w, src_val,
                             edge_mask.reshape(self.ndev, self.epd), out_init, kind,
                             use_weight, substrate, vertex_mask=False, case="edges")

    def sharded_det_relax_edges(self, src_val, edge_mask, out_init, use_weight):
        order = self._order("out", self.src_idx, self.col_idx, self.edge_w)
        return _det_add_flat(self.src_idx, self.col_idx, self.edge_w, src_val,
                             out_init, use_weight, valid=edge_mask, order=order)

    def sharded_det_pull(self, src_val, active, out_init, use_weight):
        s, d, w = self.in_nbr.reshape(-1), self.in_dst.reshape(-1), self.in_w.reshape(-1)
        return _det_add_flat(s, d, w, src_val, out_init, use_weight, active=active,
                             order=self._order("in", s, d, w))

    def sharded_intersect(self, adj, osrc, odst, substrate, chunk=None):
        """tc's count over (D, per) slices of the oriented edge list: one
        ``intersect_count`` per shard (the plain version ``chunk`` edges at
        a time), the exact int32 partials summed (the reference's psum)."""
        parts = []
        for d in range(self.ndev):
            if substrate == "cuda":
                parts.append(gk.intersect_count(adj, osrc[d], odst[d], sentinel=self.sentinel))
            elif chunk is None:
                parts.append(gk.intersect_ref(adj, osrc[d], odst[d], self.sentinel))
            else:
                parts.append(gk.intersect_chunks_ref(adj, osrc[d], odst[d], self.sentinel,
                                                     chunk).sum(dtype=torch.int32))
        return torch.stack(parts).sum(dtype=torch.int32)

    def sharded_advance(self, f: SparseFrontier, budget: int, substrate):
        """Merge-path expansion of the replicated frontier over each shard:
        the ``budget`` slots are per shard (the ladder rung is per shard)."""
        adv = gk.advance_frontier if substrate == "cuda" else gk.advance_ref
        outs = [adv(f.idx, f.count, self.shard_deg[d], self.shard_row_ptr[d],
                    self.dst[d], self.w[d], budget=budget, sentinel=self.sentinel,
                    m_pad=self.epd) for d in range(self.ndev)]
        s, d, w, v, t = (torch.stack(x) for x in zip(*outs))
        return ShardedEdgeBatch(src=s, dst=d, w=w, valid=v, totals=t.to(torch.int32),
                                red=self._reducer())

    def sharded_sparse_round(self, src_val, mask, out_init, kind, use_weight,
                             capacity, budget, substrate):
        """One shard-local data-driven round: every shard compacts the
        frontier's vertices with local edges into its own ``capacity``
        worklist and expands it over its shard; a shard whose worklist or
        edge mass overflows the rung escalates alone to a local dense relax
        of its masked edges (the same messages: labels bitwise either
        way).  Returns ``(merged, escalated_shards)``, the count a 0-d
        int32 on the device (never read here: the engine fetches it once a
        stretch)."""
        sent = self.sentinel
        idx, count = compact_local(mask, self.shard_deg, capacity, sent)
        adv = gk.advance_frontier if substrate == "cuda" else gk.advance_ref
        neutral = torch.full_like(out_init, _neutral(kind, out_init.dtype))
        accs, escs = [], []
        for d in range(self.ndev):
            bs, bd, bw, bv, total = adv(idx[d], count[d], self.shard_deg[d],
                                        self.shard_row_ptr[d], self.dst[d], self.w[d],
                                        budget=budget, sentinel=sent, m_pad=self.epd)
            esc = ((count[d] > capacity) | (total > budget)).to(torch.int32)
            acc = local_relax(bs, bd, bw, bv, src_val, neutral, kind, use_weight, False,
                              substrate, case="batch", gate=1 - esc)
            acc = local_relax(self.src[d], self.dst[d], self.w[d], mask, src_val, acc, kind,
                              use_weight, True, substrate, case="push", gate=esc)
            accs.append(acc)
            escs.append(esc)
        merged = merge(out_init, self._reducer().reduce(torch.stack(accs), kind), kind)
        return merged, torch.stack(escs).sum(dtype=torch.int32)


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


def _build_reducer(pg: PartitionedGraph, axes, reducer: str, n_pad: int,
                   block_size: int) -> CrossReducer:
    """The communication-avoiding mode the partition supports: cvc2d for a
    ``partition_2d`` grid on a 2-axis mesh, owner1d for a 1-D cut (or a
    2-D cut on one axis), else the full-mesh reduce (also for
    ``reducer="full"`` and one position)."""
    ndev = pg.ndev
    axes = tuple(axes)
    if reducer == "full" or ndev == 1:
        return CrossReducer(mode="full", axes=axes, rows=ndev, cols=1)
    if reducer != "cvc":
        raise ValueError(f"unknown reducer {reducer!r}; pick 'cvc' or 'full'")
    if pg.scheme == "cvc" and len(axes) == 2 and pg.cols > 1:
        idx, valid = pl.owner_layout(pg.reduce_owner, pg.cols)
        return CrossReducer(mode="cvc2d", axes=axes, rows=pg.rows, cols=pg.cols,
                            own_idx=idx, own_valid=valid)
    if len(axes) == 1:
        own = pg.reduce_owner if pg.scheme == "oec" else pl.vertex_owner(
            n_pad, block_size, ndev, pg.policy, device=pg.device)
        idx, valid = pl.owner_layout(own, ndev)
        return CrossReducer(mode="owner1d", axes=axes, rows=ndev, cols=1,
                            own_idx=idx, own_valid=valid)
    return CrossReducer(mode="full", axes=axes, rows=ndev, cols=1)


def shard_graph(g: Graph, mesh: Mesh, axes: Tuple[str, ...] = ("data",),
                policy: str = "blocked", scheme: str = "oec",
                grid: Optional[Tuple[int, int]] = None,
                reducer: str = "cvc") -> ShardedGraph:
    """Partition ``g``'s edges over ``mesh`` and home them by ``policy``:
    ``scheme="oec"`` through ``partition_1d``, ``"cvc"`` through
    ``partition_2d`` over ``grid=(rows, cols)`` (``rows * cols`` positions,
    the mesh's two axes when it has two).  ``reducer``: ``"cvc"`` keys the
    communication-avoiding structure on the partition, ``"full"`` keeps the
    full-mesh reduce.  The shards are cut on ``g``'s device, which must be
    the mesh's."""
    if getattr(g, "is_tiered", False) or not isinstance(g, Graph):
        raise TypeError("shard_graph takes a resident Graph")
    if not _same_device(torch.device(mesh.device), g.device):
        raise ValueError(f"the mesh lives on {mesh.device}, the graph on {g.device}")
    ndev = num_positions(mesh, axes)
    rows = cols = None
    if scheme == "cvc":
        rows, cols = grid if grid is not None else (ndev, 1)
        if rows * cols != ndev:
            raise ValueError(f"grid {(rows, cols)} does not hold {ndev} positions")
        if len(axes) == 2 and (mesh.shape[axes[0]], mesh.shape[axes[1]]) != (rows, cols):
            raise ValueError("grid must match the mesh axes (rows, cols)")
        pg = partition_2d(g, rows, cols, policy=policy)
    elif scheme == "oec":
        pg = partition_1d(g, ndev, policy=policy)
    else:
        raise ValueError(f"unknown scheme {scheme!r}; pick 'oec' or 'cvc'")
    in_fields = {}
    if g.has_csc:
        pgi = (partition_2d(g, rows, cols, policy=policy, direction="in")
               if scheme == "cvc" else partition_1d(g, ndev, policy=policy, direction="in"))
        in_fields = dict(in_nbr=pgi.src, in_dst=pgi.dst, in_w=pgi.w)
    red = _build_reducer(pg, axes, reducer, g.n_pad, g.block_size)
    return ShardedGraph(
        n=g.n, m=g.m, n_pad=g.n_pad, block_size=g.block_size, ndev=ndev, epd=pg.epd,
        scheme=scheme, placement=policy, axes=tuple(axes), mesh=mesh, src=pg.src,
        dst=pg.dst, w=pg.w, shard_row_ptr=pg.row_ptr, shard_deg=pg.deg,
        out_deg=g.out_deg, red=red, **in_fields)
