"""Neighbour sampling for mini-batch GNN training (GraphSAGE-style
fanouts), as ``repro.graphs.sampler``.

For each seed node the sampler draws ``fanout`` neighbours uniformly with
replacement from its CSR row; a node of out-degree 0 self-loops.  Sampling
is a sparse-worklist advance: the seeds are the frontier and the fanout
caps the budget.  The draws are the reference's bitwise: each layer
splits the key and takes ``randint(sub, (P, f), 0, 1 << 30)``, reduced
modulo the degree.  The threefry words are made on the host (a few
hundred kB a step at ``minibatch_lg``'s fanouts) and copied once a layer;
the gathers run on the CSR's device.

The output is a layered block list: layer k holds the
(B · prod(fanouts[:k+1]),) child node ids, their parents implied by the
dense (num_{k-1}, fanout) layout.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core.graph import Graph
from ..data.pipeline import randint, split


@dataclasses.dataclass(frozen=True)
class SampledBlocks:
    """seeds (B,) int32; layers: a tuple of (parents·fanout,) int32 child ids."""

    seeds: torch.Tensor
    layers: tuple


def _key(key) -> tuple:
    """A key as a pair of Python ints: a pair already, or two words of
    an array or host tensor (the reference's (2,) uint32 key)."""
    return tuple(int(k) & 0xFFFFFFFF for k in key)


def sample_blocks_raw(row_ptr: torch.Tensor, col_idx: torch.Tensor, out_deg: torch.Tensor,
                      seeds, key, fanouts: Tuple[int, ...]) -> SampledBlocks:
    """The sampler over raw CSR tensors, on their device (``seeds`` are
    moved there)."""
    key = _key(key)
    device = row_ptr.device
    seeds = torch.as_tensor(seeds).to(device=device, dtype=torch.int32)
    layers, frontier = [], seeds
    for f in fanouts:
        key, sub = split(key)
        fl = frontier.long()
        deg = out_deg.index_select(0, fl)[:, None]
        r = torch.from_numpy(randint(sub, (frontier.shape[0], f), 0, 1 << 30)).to(device)
        has = deg > 0
        # uniform in [0, deg); the self loop's slot reads nothing
        off = torch.where(has, r % torch.clamp(deg, min=1), 0)
        eidx = torch.where(has, row_ptr.index_select(0, fl)[:, None] + off, 0)
        child = torch.where(has, col_idx[eidx.long()], frontier[:, None])
        frontier = child.reshape(-1).to(torch.int32)
        layers.append(frontier)
    return SampledBlocks(seeds=seeds, layers=tuple(layers))


def sample_blocks(g: Graph, seeds, key, fanouts: Tuple[int, ...]) -> SampledBlocks:
    return sample_blocks_raw(g.row_ptr, g.col_idx, g.out_deg, seeds, key, fanouts)
