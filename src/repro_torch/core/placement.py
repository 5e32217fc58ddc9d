"""Placement policies — the paper's §4 NUMA study mapped to a mesh, as in
``repro.core.placement``.

The paper's three allocation policies become three ways of laying graph
arrays out over the mesh's positions:

* ``local``       — everything on position 0 ("NUMA local"): the
                    pathological baseline (replicated over the mesh).
* ``interleaved`` — blocks dealt round-robin: a **block permutation** of an
                    array followed by a contiguous cut, so block b lands
                    on position b mod D.
* ``blocked``     — contiguous block ranges per position (the default of
                    owner-computes partitions).

``shard_owner`` is the partitioner's hook (which position holds a vertex's
edges) and ``vertex_owner`` / ``owner_layout`` the reduce side's ownership
map (``sharded.CrossReducer``).  ``place_graph`` applies a policy to a
graph's edge arrays (the interleaved block permutation) and
``position_bytes`` accounts the bytes each position would hold.
``ChurnModel`` is the §4.2 migration break-even model.

All maps are torch tensors on the caller's device (int64 owners, as the
reference's numpy int64); numpy inputs are taken too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

import numpy as np
import torch

from .graph import Graph, round_up
from .mesh import Mesh, num_positions

Policy = Literal["local", "interleaved", "blocked"]
POLICIES = ("local", "interleaved", "blocked")


def _as_index(vertex, device=None) -> torch.Tensor:
    if isinstance(vertex, torch.Tensor):
        return vertex.to(torch.int64)
    return torch.as_tensor(np.asarray(vertex, dtype=np.int64), device=device)


def shard_owner(vertex, n_pad: int, block_size: int, ndev: int,
                policy: Policy) -> torch.Tensor:
    """Which position owns a vertex's edges: all on 0 (``local``, or one
    position), contiguous ranges of ``ceil(n_pad / ndev)`` vertices
    (``blocked``: the reference's cut, NOT rounded to ``block_size``) or
    vertex blocks dealt round-robin (``interleaved``)."""
    vertex = _as_index(vertex)
    if policy not in POLICIES:
        raise ValueError(f"unknown placement policy {policy!r}")
    if policy == "local" or ndev == 1:
        return torch.zeros_like(vertex)
    if policy == "interleaved":
        return (vertex // block_size) % ndev
    per = -(-n_pad // ndev)
    return torch.clamp(vertex // per, max=ndev - 1)


def vertex_owner(n_pad: int, block_size: int, ndev: int, policy: Policy,
                 device=None) -> torch.Tensor:
    """(n_pad,) owner of each vertex's canonical label: ``shard_owner`` on
    the identity, so edge homing and label ownership agree."""
    ids = torch.arange(n_pad, dtype=torch.int64, device=device)
    return shard_owner(ids, n_pad, block_size, ndev, policy)


def owner_layout(owner, ndev: int):
    """``(idx, valid)``, both (ndev, L): row d lists the vertices ``owner``
    gives position d in ascending order, padded with the sentinel
    (``n_pad - 1``); ``valid`` marks real entries.  L is the largest count
    rounded up to 8.  The valid entries tile ``[0, n_pad)`` once."""
    owner = _as_index(owner)
    n_pad = owner.shape[0]
    dev = owner.device
    counts = torch.bincount(owner, minlength=ndev)
    L = round_up(max(int(counts.max()), 1), 8)
    order = torch.sort(owner, stable=True).indices      # ascending within a row
    row = owner[order]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n_pad, device=dev) - starts[row]
    idx = torch.full((ndev, L), n_pad - 1, dtype=torch.int32, device=dev)
    valid = torch.zeros((ndev, L), dtype=torch.bool, device=dev)
    idx[row, pos] = order.to(torch.int32)
    valid[row, pos] = True
    return idx, valid


def interleave_blocks(x: torch.Tensor, block_size: int, ndev: int) -> torch.Tensor:
    """Permute blocks so that a contiguous cut realises round-robin
    placement: block b of ``x`` ends up in position b mod ndev's range.
    An array whose block count ndev does not divide is returned as is
    (blocked)."""
    nb = x.shape[0] // block_size
    if nb % ndev != 0:
        return x
    blocks = x.reshape(nb, block_size, *x.shape[1:])
    order = torch.arange(nb, device=x.device).reshape(nb // ndev, ndev).T.reshape(-1)
    return blocks[order].reshape(x.shape)


_EDGE_ARRAYS = ("col_idx", "src_idx", "edge_w", "in_col_idx", "in_src_idx", "in_edge_w")


def place_graph(g: Graph, mesh: Mesh, axes=("data",), policy: Policy = "blocked") -> Graph:
    """``g`` with its edge arrays laid out for ``policy``: ``interleaved``
    permutes edge blocks (``interleave_blocks``), the other policies keep
    the order.  Vertex arrays stay in vertex order (they are the lookup
    side of the gathers).  A whole-array copy, made once per run, never
    inside the round loop (P2 / §4.2)."""
    if policy not in POLICIES:
        raise ValueError(f"unknown placement policy {policy!r}")
    if policy != "interleaved":
        return g
    ndev = num_positions(mesh, axes)
    rep = {name: interleave_blocks(getattr(g, name), g.block_size, ndev)
           for name in _EDGE_ARRAYS if getattr(g, name) is not None}
    return dataclasses.replace(g, **rep)


def position_bytes(g: Graph, mesh: Mesh, axes=("data",), policy: Policy = "blocked"):
    """Bytes of the CSR edge arrays (``col_idx``, ``src_idx``, ``edge_w``)
    each mesh position holds under ``policy``, as a list: the whole arrays
    on every position for ``local`` (replicated), else an even contiguous
    cut of ``ceil(len / D)`` elements (the last position the rest)."""
    ndev = num_positions(mesh, axes)
    out = [0] * ndev
    for name in ("col_idx", "src_idx", "edge_w"):
        x = getattr(g, name)
        item = x.element_size()
        n = x.shape[0]
        if policy == "local":
            for d in range(ndev):
                out[d] += n * item
            continue
        per = -(-n // ndev)
        for d in range(ndev):
            out[d] += max(0, min(per, n - d * per)) * item
    return out


@dataclasses.dataclass
class ChurnModel:
    """Mid-run re-placement: moving B bytes costs B / ici_bw seconds plus
    one recompile of the round step; amortised over R rounds it pays only
    if the per-round gain exceeds (copy + compile) / R."""

    ici_bw: float = 50e9
    compile_s: float = 2.0

    def breakeven_rounds(self, bytes_moved: float, per_round_gain_s: float) -> float:
        if per_round_gain_s <= 0:
            return math.inf
        return (bytes_moved / self.ici_bw + self.compile_s) / per_round_gain_s
