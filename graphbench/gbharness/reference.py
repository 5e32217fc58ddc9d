"""The plain reference: straightforward torch over a CSR that it builds
itself from the generated COO.  It imports nothing of the program and
takes nothing the program made.

* ``distances`` — single-source shortest paths by frontier Bellman-Ford
  (each round relaxes the out-edges of the vertices that changed, a
  scatter min); with unit weights these are BFS levels.  Every relax adds
  ``dist[u] + w`` in the chosen dtype, so in float32 the fixed point is the
  one any order of float32 relaxations reaches.
* ``pagerank_push`` — residual-push PageRank for a fixed number of rounds
  (vertices whose residual exceeds ``tol`` push ``damping * resid /
  max(out_deg, 1)`` to each out-neighbour), the leftover residual folded in
  and the ranks normalised to sum to 1.

``dtype`` picks the arithmetic: float32 for distances and float64 for
ranks are the reference; a lower precision in the program's place is the
control that must come out wrong.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Csr:
    n: int
    row_ptr: torch.Tensor   # (n + 1,) int64
    col: torch.Tensor       # (m,) int64
    w: torch.Tensor | None  # (m,) float32 or None
    out_deg: torch.Tensor   # (n,) int64

    @property
    def src(self) -> torch.Tensor:
        return torch.repeat_interleave(
            torch.arange(self.n, device=self.col.device), self.out_deg)


def build_csr(src, dst, n: int, w=None, *, symmetrize: bool = False,
              dedup: bool = False, device=None) -> Csr:
    """CSR of the edge list ``(src, dst[, w])``: both directions when
    ``symmetrize``; ``dedup`` drops self-loops and repeated pairs (the
    smallest weight kept)."""
    src = torch.as_tensor(src, device=device).to(torch.int64)
    dst = torch.as_tensor(dst, device=device).to(torch.int64)
    if w is not None:
        w = torch.as_tensor(w, device=device).to(torch.float32)
    if symmetrize:
        src, dst = torch.cat([src, dst]), torch.cat([dst, src])
        if w is not None:
            w = torch.cat([w, w])
    if dedup:
        keep = src != dst
        src, dst = src[keep], dst[keep]
        w = None if w is None else w[keep]
        if w is not None:
            order = torch.sort(w, stable=True).indices
            src, dst, w = src[order], dst[order], w[order]
        key = src * n + dst
        order = torch.sort(key, stable=True).indices
        key = key[order]
        first = torch.ones_like(key, dtype=torch.bool)
        first[1:] = key[1:] != key[:-1]
        src, dst = src[order][first], dst[order][first]
        w = None if w is None else w[order][first]
    else:
        order = torch.sort(src, stable=True).indices
        src, dst = src[order], dst[order]
        w = None if w is None else w[order]
    deg = torch.bincount(src, minlength=n)
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
    torch.cumsum(deg, 0, out=row_ptr[1:])
    return Csr(n=n, row_ptr=row_ptr, col=dst, w=w, out_deg=deg)


def _out_edges(csr: Csr, verts: torch.Tensor):
    """(edge ids, their source position in ``verts``) of every out-edge of
    ``verts``."""
    deg = csr.out_deg[verts]
    total = int(deg.sum())
    owner = torch.repeat_interleave(torch.arange(verts.numel(), device=verts.device),
                                    deg, output_size=total)
    first = torch.cumsum(deg, 0) - deg
    eid = csr.row_ptr[verts][owner] + torch.arange(total, device=verts.device) \
        - first[owner]
    return eid, owner


def distances(csr: Csr, source: int, *, weighted: bool,
              dtype=torch.float32) -> torch.Tensor:
    """(n,) shortest distances from ``source`` (``inf`` where unreached),
    in ``dtype``; unit weights unless ``weighted``."""
    dev = csr.col.device
    dist = torch.full((csr.n,), float("inf"), dtype=dtype, device=dev)
    dist[source] = 0
    frontier = torch.tensor([source], dtype=torch.int64, device=dev)
    while frontier.numel():
        eid, owner = _out_edges(csr, frontier)
        w = csr.w[eid].to(dtype) if weighted else torch.ones(
            eid.numel(), dtype=dtype, device=dev)
        cand = dist[frontier][owner] + w
        new = dist.clone()
        new.scatter_reduce_(0, csr.col[eid], cand, reduce="amin")
        frontier = torch.nonzero(new < dist).squeeze(1)
        dist = new
    return dist


def pagerank_push(csr: Csr, rounds: int, damping: float, tol: float,
                  dtype=torch.float64) -> torch.Tensor:
    """(n,) ranks after ``rounds`` residual-push rounds, normalised."""
    dev = csr.col.device
    src = csr.src
    outdeg = torch.clamp(csr.out_deg, min=1).to(dtype)
    rank = torch.zeros(csr.n, dtype=dtype, device=dev)
    resid = torch.full((csr.n,), 1.0 - damping, dtype=dtype, device=dev)
    for _ in range(rounds):
        active = resid > tol
        if not bool(active.any()):
            break
        rank = rank + torch.where(active, resid, 0.0)
        push = torch.where(active, damping * resid / outdeg, 0.0)
        added = torch.zeros_like(resid).index_add_(0, csr.col, push[src])
        resid = torch.where(active, 0.0, resid) + added
    rank = rank + resid
    return rank / rank.sum()
