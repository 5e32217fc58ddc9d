"""Worklists: dense bitmaps and sparse compacted frontiers.

The reference's construction (``repro.core.frontier``): a ``DenseFrontier``
is a bool vertex mask; a ``SparseFrontier`` is a fixed-``capacity`` buffer
of vertex indices plus a ``count`` that may exceed it (overflow).
Capacities come from a geometric ladder, so a run uses few distinct
shapes.  ``compact`` builds the worklist on the device without a host
sync (``compact_local`` every shard's worklist of a sharded graph in one
pass); the band predicates re-derive on the device the rung decision the
host dispatcher makes (``live_stable`` the shard schedule of a streamed
stretch).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .graph import Graph, set_at


@dataclasses.dataclass(frozen=True)
class DenseFrontier:
    mask: torch.Tensor  # (n_pad,) bool

    @property
    def n_pad(self) -> int:
        return self.mask.shape[0]

    def count(self) -> torch.Tensor:
        return self.mask.sum(dtype=torch.int32)

    def edge_mass(self, g: Graph) -> torch.Tensor:
        """Total out-degree of active vertices (Beamer's push cost)."""
        return torch.where(self.mask, g.out_deg, 0).sum(dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class SparseFrontier:
    """Compacted worklist: ``idx[i]`` for i < count are active vertices in
    ascending order, the rest the sentinel."""

    idx: torch.Tensor     # (capacity,) int32, sentinel-padded
    count: torch.Tensor   # () int32 — true number of active vertices
    sentinel: int

    @property
    def capacity(self) -> int:
        return self.idx.shape[0]

    def overflowed(self) -> torch.Tensor:
        return self.count > self.capacity

    def valid_slots(self) -> torch.Tensor:
        return (torch.arange(self.capacity, device=self.idx.device)
                < torch.clamp(self.count, max=self.capacity))

    def edge_mass(self, g: Graph) -> torch.Tensor:
        deg = g.out_deg[self.idx]
        return torch.where(self.valid_slots(), deg, 0).sum(dtype=torch.int32)


def dense_from_indices(indices, n_pad: int, device=None) -> DenseFrontier:
    idx = torch.as_tensor(indices, device=device).long()
    mask = torch.zeros((n_pad,), dtype=torch.bool, device=idx.device)
    mask[idx] = True
    set_at(mask, n_pad - 1, False)  # never activate the sentinel
    return DenseFrontier(mask=mask)


def compact(mask: torch.Tensor, capacity: int, sentinel: int) -> SparseFrontier:
    """Dense mask → sparse worklist with static capacity.

    Slot order is ``jnp.nonzero(mask, size=capacity, fill_value=sentinel)``'s:
    ascending vertex id, truncated at ``capacity``, sentinel-filled.  Built
    from a cumsum rank and one scatter, so no host sync: the buffer has a
    spare slot per vertex past ``capacity`` that absorbs it when inactive
    or truncated, so no two writes meet."""
    mask = set_at(mask.clone(), sentinel, False)
    flags = mask.to(torch.int32)
    count = flags.sum(dtype=torch.int32)
    rank = torch.cumsum(flags, 0, dtype=torch.int32) - 1
    ids = torch.arange(mask.shape[0], dtype=torch.int32, device=mask.device)
    slot = torch.where(mask & (rank < capacity), rank, capacity + ids)
    buf = torch.full((capacity + mask.shape[0],), sentinel, dtype=torch.int32,
                     device=mask.device)
    buf.scatter_(0, slot.long(), ids)
    return SparseFrontier(idx=buf[:capacity], count=count, sentinel=sentinel)


def compact_local(mask: torch.Tensor, deg: torch.Tensor, capacity: int,
                  sentinel: int):
    """Shard-local compaction for the per-shard frontier ladder, every
    shard in one pass: ``mask`` (the replicated (n_pad,) frontier)
    restricted to each shard's vertices with local edges (``deg > 0``, the
    (D, n_pad) shard degrees), compacted as ``compact`` does.  Returns
    ``(idx, count)``: (D, capacity) int32 worklists and the (D,) int32 true
    local frontier sizes, which may exceed ``capacity`` (a shard's
    overflow signal)."""
    nd, n_pad = deg.shape
    m = mask.unsqueeze(0) & (deg > 0)
    m[:, sentinel].fill_(False)
    flags = m.to(torch.int32)
    count = flags.sum(1, dtype=torch.int32)
    rank = torch.cumsum(flags, 1, dtype=torch.int32) - 1
    ids = torch.arange(n_pad, dtype=torch.int32, device=mask.device)
    slot = torch.where(m & (rank < capacity), rank, capacity + ids)
    buf = torch.full((nd, capacity + n_pad), sentinel, dtype=torch.int32,
                     device=mask.device)
    buf.scatter_(1, slot.long(), ids.expand(nd, -1))
    return buf[:, :capacity], count


def ladder_capacities(n_pad: int, block_size: int, base: int = 4) -> Tuple[int, ...]:
    """Geometric capacity ladder ending at n_pad."""
    caps = []
    c = block_size
    while c < n_pad:
        caps.append(c)
        c *= base
    caps.append(n_pad)
    return tuple(caps)


def pick_capacity(count: int, ladder: Tuple[int, ...]) -> int:
    """Host-side: smallest ladder rung ≥ count (ladder[-1] == n_pad always fits)."""
    for c in ladder:
        if count <= c:
            return c
    return ladder[-1]


def ladder_below(rung: int, ladder: Tuple[int, ...]) -> int:
    """The next-smaller rung (0 below the smallest): the lower edge of
    ``rung``'s band."""
    i = ladder.index(rung)
    return ladder[i - 1] if i else 0


def round_scalars(g, mask: torch.Tensor) -> torch.Tensor:
    """Device-side ladder scalars for one round, as one (4,) int32 tensor
    ``(count, cap_need, mass_med, mass_tot)``, fetched in one transfer.
    On a single partition cap_need is the count and both masses are the
    whole frontier's edge mass.  On a sharded graph of D > 1 shards
    cap_need is the largest *local* frontier (vertices with local edges),
    mass_med the upper median of the per-shard frontier masses
    (``sorted[D // 2]``, the reference's: the budget rung fits the typical
    shard, a hub-heavy one escalates alone) and mass_tot their sum."""
    count = mask.sum(dtype=torch.int32)
    shard_deg = getattr(g, "shard_deg", None)
    if shard_deg is not None and getattr(g, "ndev", 1) > 1:
        counts = (mask.unsqueeze(0) & (shard_deg > 0)).sum(1, dtype=torch.int32)
        masses = torch.where(mask.unsqueeze(0), shard_deg, 0).sum(1, dtype=torch.int32)
        srt = torch.sort(masses).values
        return torch.stack([count, counts.max(), srt[srt.shape[0] // 2],
                            masses.sum(dtype=torch.int32)])
    mass = g.budget_edge_mass(mask)
    return torch.stack([count, count, mass, mass])


def sparse_band(scalars, capacity: int, lo_cap: int, budget: int,
                lo_budget: int, sparse_cutoff: int) -> torch.Tensor:
    """True while the host dispatcher would keep picking exactly this
    (capacity, budget) sparse rung for ``scalars``."""
    count, cap_need, mass_med, _ = scalars
    cn = torch.clamp(cap_need, min=1)
    bm = torch.clamp(mass_med, min=1)
    return ((count > 0)
            & (cn <= capacity) & (cn > lo_cap)
            & (bm <= budget) & (bm > lo_budget)
            & (mass_med <= sparse_cutoff))


def dense_band(scalars, sparse_cutoff: int) -> torch.Tensor:
    """True while the host dispatcher would keep picking the dense
    fallback: frontier alive and median mass above the sparse cutoff."""
    count, _, mass_med, _ = scalars
    return (count > 0) & (mass_med > sparse_cutoff)


def live_stable(sg, mask: torch.Tensor) -> torch.Tensor:
    """Band predicate of the streamed stretch (``engine._staged_stretch``):
    True while ``mask``'s live-shard set still equals the set ``sg`` (a
    ``tiered.StagedShards``) was staged for — the device-side re-derivation
    of the host scheduler's decision, as ``sparse_band`` / ``dense_band``
    re-derive the ladder's."""
    _, live = sg.round_live(mask)
    return torch.all(live == sg.live)


# ---------------------------------------------------------------------------
# Multi-source batched frontiers (core/multisource.py)
# ---------------------------------------------------------------------------
# The batched frontier is a (B, n_pad) bool bit-matrix: row b is lane b's
# dense frontier.  The ladder keys on the *union* row — one edge sweep per
# round expands the union worklist, with per-lane masks restoring each
# lane's message set — and per-lane termination is the row-wise any().


def batched_from_sources(sources: torch.Tensor, n_pad: int) -> torch.Tensor:
    """(B, n_pad) one-hot frontier bit-matrix, one source per lane, on
    ``sources``' device; the sentinel column never activates.  Built by a
    scatter and a column fill on the device, no host scalar copied over."""
    src = sources.long().view(-1, 1)
    fmat = torch.zeros((src.shape[0], n_pad), dtype=torch.bool, device=src.device)
    fmat.scatter_(1, src, True)
    fmat[:, n_pad - 1].fill_(False)
    return fmat


def batched_round_scalars(g, fmat: torch.Tensor):
    """Ladder scalars for one batched round, as device tensors for one
    ``engine.fetch``: ``(total, ucount, umass, alive)`` —

    * ``total``  Σ over lanes of frontier sizes (global termination);
    * ``ucount`` union-frontier size: what the shared capacity rung holds;
    * ``umass``  union-frontier budget mass (``g.budget_edge_mass``);
    * ``alive``  (B,) bool, per-lane termination."""
    union = fmat.any(0)
    total = fmat.sum(dtype=torch.int32)
    ucount = union.sum(dtype=torch.int32)
    umass = g.budget_edge_mass(union)
    alive = fmat.any(1)
    return total, ucount, umass, alive
