"""Worklists: dense bitmaps and sparse compacted frontiers.

The reference's construction (``repro.core.frontier``): a ``DenseFrontier``
is a bool vertex mask; a ``SparseFrontier`` is a fixed-``capacity`` buffer
of vertex indices plus a ``count`` that may exceed it (overflow).
Capacities come from a geometric ladder, so a run uses few distinct
shapes.  ``compact`` builds the worklist on the device without a host
sync; the band predicates re-derive on the device the rung decision the
host dispatcher makes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .graph import Graph


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
    mask[n_pad - 1] = False  # never activate the sentinel
    return DenseFrontier(mask=mask)


def compact(mask: torch.Tensor, capacity: int, sentinel: int) -> SparseFrontier:
    """Dense mask → sparse worklist with static capacity.

    Slot order is ``jnp.nonzero(mask, size=capacity, fill_value=sentinel)``'s:
    ascending vertex id, truncated at ``capacity``, sentinel-filled.  Built
    from a cumsum rank and one scatter, so no host sync: the buffer has a
    spare slot per vertex past ``capacity`` that absorbs it when inactive
    or truncated, so no two writes meet."""
    mask = mask.clone()
    mask[sentinel] = False
    flags = mask.to(torch.int32)
    count = flags.sum(dtype=torch.int32)
    rank = torch.cumsum(flags, 0, dtype=torch.int32) - 1
    ids = torch.arange(mask.shape[0], dtype=torch.int32, device=mask.device)
    slot = torch.where(mask & (rank < capacity), rank, capacity + ids)
    buf = torch.full((capacity + mask.shape[0],), sentinel, dtype=torch.int32,
                     device=mask.device)
    buf.scatter_(0, slot.long(), ids)
    return SparseFrontier(idx=buf[:capacity], count=count, sentinel=sentinel)


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
    whole frontier's edge mass."""
    count = mask.sum(dtype=torch.int32)
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
