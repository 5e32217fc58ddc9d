"""Edge partitions over a mesh, and the BSP vertex-program baseline, as in
``repro.core.partition``.

* ``partition_1d`` — Outgoing Edge Cut (OEC): each position owns the
  out-edges of its vertices (the paper's cut for 5–20 hosts).
* ``partition_2d`` — Cartesian Vertex Cut (CVC) on a (rows, cols) grid:
  position (i, j) owns the edges with src in row block i and dst in column
  block j (the paper's choice at 256 hosts).

Both cut on the graph's device with torch: one stable sort of the edges by
(shard, src, dst) — the reference's boolean selection (CSR order kept)
followed by its per-shard ``np.lexsort((d, s))``, ties included — then a
scatter into sentinel-padded (D, epd) shards, ``epd`` the largest shard
rounded up to 8.  ``row_ptr`` / ``deg`` are each shard's CSR over global
vertex ids (``deg[sentinel] = 0``), so a shard can merge-path-expand a
frontier over its own edges (``core/sharded.py``).

The BSP engine (``make_bsp_step``, ``bsp_bfs``, ``bsp_cc``) is the paper's
D-Galois baseline: every round relaxes every shard's masked edges into a
neutral accumulator, reduces the stack over the mesh (a dense Gluon-style
sync) and merges — dense worklists and vertex operators only.  The local
relax goes through the substrate seam (``collectives.local_relax``: the
``edge_relax`` kernel on the card), and the rounds run as one device loop
(``engine.run_dense``): min is order-free, so labels and round counts are
the reference's.
"""

from __future__ import annotations

import dataclasses

import torch

from . import operators as ops
from . import placement as pl
from .collectives import kind_reduce, local_relax, merge
from .graph import Graph, round_up, set_at
from .mesh import Mesh, num_positions


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Edge-partitioned graph: (D, epd) edge arrays, position-major, each
    shard in (src, dst) order, plus its CSR metadata over global vertex
    ids.  ``rows`` / ``cols`` is the position grid ((ndev, 1) for a 1-D
    cut) and ``reduce_owner`` maps each vertex to its owner along the
    reduce dimension (grid column for CVC, the whole axis for OEC): every
    edge's accumulator target lands on a shard whose reduce index is
    ``reduce_owner[target]``.  For ``direction="in"`` the CSR metadata is
    keyed by the in-neighbour and only the flat lists are used."""

    n: int
    n_pad: int
    ndev: int
    epd: int
    scheme: str          # "oec" | "cvc"
    policy: str          # shard homing (placement.py)

    src: torch.Tensor       # (D, epd) int32, sentinel-padded
    dst: torch.Tensor       # (D, epd) int32
    w: torch.Tensor         # (D, epd) float32
    out_deg: torch.Tensor   # (n_pad,) global out-degrees
    row_ptr: torch.Tensor   # (D, n_pad + 1) shard-local CSR offsets
    deg: torch.Tensor       # (D, n_pad) shard-local degree

    rows: int = 0
    cols: int = 0
    reduce_owner: torch.Tensor | None = None   # (n_pad,) int32

    @property
    def sentinel(self) -> int:
        return self.n_pad - 1

    @property
    def device(self) -> torch.device:
        return self.src.device


def _shard_order(owner, s, d, ndev: int, n_pad: int) -> torch.Tensor:
    """Stable permutation of the edges by (shard, src, dst)."""
    if ndev * n_pad * n_pad < 2**62:
        key = (owner * n_pad + s) * n_pad + d
        return torch.sort(key, stable=True).indices
    order = torch.sort(d, stable=True).indices
    key = owner[order] * n_pad + s[order]
    return order[torch.sort(key, stable=True).indices]


def _assemble(owner, s, d, w, *, ndev, n, n_pad, out_deg, scheme, policy, rows,
              cols, reduce_owner) -> PartitionedGraph:
    dev = s.device
    sentinel = n_pad - 1
    s64, d64 = s.to(torch.int64), d.to(torch.int64)
    order = _shard_order(owner, s64, d64, ndev, n_pad)
    shard = owner[order]
    counts = torch.bincount(owner, minlength=ndev)
    epd = round_up(max(int(counts.max()) if owner.numel() else 0, 1), 8)
    pos = torch.arange(shard.shape[0], device=dev) - (torch.cumsum(counts, 0) - counts)[shard]
    S = torch.full((ndev, epd), sentinel, dtype=torch.int32, device=dev)
    D = torch.full((ndev, epd), sentinel, dtype=torch.int32, device=dev)
    W = torch.zeros((ndev, epd), dtype=torch.float32, device=dev)
    S[shard, pos] = s[order]
    D[shard, pos] = d[order]
    W[shard, pos] = w[order]
    deg = torch.bincount(owner * n_pad + s64, minlength=ndev * n_pad)
    deg = deg.reshape(ndev, n_pad).to(torch.int32)
    deg[:, sentinel] = 0
    rp = torch.zeros((ndev, n_pad + 1), dtype=torch.int32, device=dev)
    rp[:, 1:] = torch.cumsum(deg, 1, dtype=torch.int32)
    return PartitionedGraph(
        n=n, n_pad=n_pad, ndev=ndev, epd=epd, scheme=scheme, policy=policy,
        src=S, dst=D, w=W, out_deg=out_deg, row_ptr=rp, deg=deg, rows=rows,
        cols=cols, reduce_owner=reduce_owner.to(torch.int32))


def _edge_arrays(g: Graph, direction: str):
    """``(src, dst, w, own_key)`` of the real edges: the CSR list, or the
    CSC in-edge list (in-neighbour, destination, weight) homed with its
    destination."""
    m = g.m
    if direction == "in":
        assert g.has_csc, "direction='in' requires build_csc=True"
        dst = g.in_src_idx[:m]
        return g.in_col_idx[:m], dst, g.in_edge_w[:m], dst
    src = g.src_idx[:m]
    return src, g.col_idx[:m], g.edge_w[:m], src


def partition_1d(g: Graph, ndev: int, policy: str = "blocked",
                 direction: str = "out") -> PartitionedGraph:
    """1-D edge cut (OEC): position d owns the out-edges of the vertices
    ``placement.shard_owner`` gives it; ``direction="in"`` cuts the CSC
    in-edge list by destination (the pull direction)."""
    src, dst, w, key = _edge_arrays(g, direction)
    owner = pl.shard_owner(key, g.n_pad, g.block_size, ndev, policy)
    red = pl.vertex_owner(g.n_pad, g.block_size, ndev, policy, device=g.device)
    return _assemble(owner, src, dst, w, ndev=ndev, n=g.n, n_pad=g.n_pad,
                     out_deg=g.out_deg, scheme="oec", policy=policy, rows=ndev,
                     cols=1, reduce_owner=red)


def partition_2d(g: Graph, rows: int, cols: int, policy: str = "blocked",
                 direction: str = "out") -> PartitionedGraph:
    """CVC on a (rows, cols) grid, flattened row-major (``i * cols + j``):
    the row keyed on the gather side (src, or the in-neighbour), the
    column on the scatter side (the accumulator target), so every shard's
    updates land on vertices its own grid column owns."""
    src, dst, w, _ = _edge_arrays(g, direction)
    r = pl.shard_owner(src, g.n_pad, g.block_size, rows, policy)
    c = pl.shard_owner(dst, g.n_pad, g.block_size, cols, policy)
    red = pl.vertex_owner(g.n_pad, g.block_size, cols, policy, device=g.device)
    return _assemble(r * cols + c, src, dst, w, ndev=rows * cols, n=g.n,
                     n_pad=g.n_pad, out_deg=g.out_deg, scheme="cvc",
                     policy=policy, rows=rows, cols=cols, reduce_owner=red)


# ---------------------------------------------------------------------------
# BSP vertex-program engine (the D-Galois analogue)
# ---------------------------------------------------------------------------


def make_bsp_step(pg: PartitionedGraph, mesh: Mesh, axes, kind: str = "min",
                  use_weight: bool = True):
    """One BSP round, ``(labels, mask) -> (labels, mask)``: each shard's
    masked edges relaxed into a neutral accumulator, the (D, n_pad) stack
    reduced over the whole mesh (communication O(n) a round, the cost the
    paper's Fig. 11 charges the cluster), merged into the labels."""
    if num_positions(mesh, axes) != pg.ndev:
        raise ValueError(f"the mesh axes {axes} hold {num_positions(mesh, axes)} "
                         f"positions, the partition {pg.ndev}")
    sub = ops.get_substrate()

    def step(labels, mask):
        neutral = torch.full_like(labels, ops.neutral_for(kind, labels.dtype).item())
        acc = torch.stack([
            local_relax(pg.src[d], pg.dst[d], pg.w[d], mask, labels, neutral, kind,
                        use_weight, True, sub, case="push")
            for d in range(pg.ndev)])
        new = merge(labels, kind_reduce(acc, kind), kind)
        return new, ops.updated_mask(labels, new)

    return step


def _bsp_run(pg, mesh, axes, labels, mask, kind, use_weight, max_rounds):
    from .engine import run_dense

    step = make_bsp_step(pg, mesh, axes, kind=kind, use_weight=use_weight)
    rounds, (labels, _) = run_dense(lambda s: step(*s), (labels, mask),
                                    lambda s: torch.any(s[1]), max_rounds)
    return labels, rounds


def bsp_bfs(pg: PartitionedGraph, mesh: Mesh, axes, src_vertex: int,
            max_rounds: int = 100_000):
    """Distributed BFS as a bulk-synchronous vertex program (dense
    worklist), relaxing with the edge weights.  Returns ``(labels,
    rounds)``; unreached vertices hold ``FLT_MAX / 4``."""
    inf = torch.finfo(torch.float32).max / 4
    labels = set_at(torch.full((pg.n_pad,), inf, dtype=torch.float32,
                               device=pg.device), src_vertex, 0.0)
    mask = set_at(torch.zeros((pg.n_pad,), dtype=torch.bool, device=pg.device),
                  src_vertex, True)
    return _bsp_run(pg, mesh, axes, labels, mask, "min", True, max_rounds)


def bsp_cc(pg: PartitionedGraph, mesh: Mesh, axes, max_rounds: int = 100_000):
    """Distributed label-propagation CC — the vertex program a distributed
    framework is restricted to (no pointer jumping across hosts)."""
    labels = torch.arange(pg.n_pad, dtype=torch.int32, device=pg.device)
    mask = set_at(torch.ones((pg.n_pad,), dtype=torch.bool, device=pg.device),
                  pg.n_pad - 1, False)
    return _bsp_run(pg, mesh, axes, labels, mask, "min", False, max_rounds)
