"""Input generators, in torch on the device that runs the cell.

The shapes of the repository's numpy generators (Graph500's recursive
quadrant choice for ``kron``; RMAT communities chained by a few random
forward and back links for the crawl), made in a few large calls from one
``torch.Generator`` seeded with ``--seed``.  Every generator returns its
edges deduplicated and without self-loops, as int64 tensors sorted by
``(src, dst)``: the input the program is handed and the plain reference
rebuilds from.  The same seed on the same kind of device gives the same
inputs; the CPU and CUDA generators draw different streams.
"""

from __future__ import annotations

import math

import torch

SEED_MOD = 1 << 63


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % SEED_MOD)
    return g


def rmat_edges(count: int, scale: int, a: float, b: float, c: float,
               gen: torch.Generator, device):
    """``count`` RMAT edges over ``2**scale`` vertices: one uniform draw a
    bit picks the quadrant, src taking the lower half with probability
    a + b and dst with probability a + c."""
    src = torch.zeros(count, dtype=torch.int64, device=device)
    dst = torch.zeros(count, dtype=torch.int64, device=device)
    r = torch.empty(count, dtype=torch.float32, device=device)
    ab, abc = a + b, a + b + c
    for _ in range(scale):
        r.uniform_(generator=gen)
        down = r > ab
        right = ((r > a) & (r <= ab)) | (r > abc)
        src.mul_(2).add_(down)
        dst.mul_(2).add_(right)
    del r
    return src, dst


def _unique_edges(src, dst, n: int):
    """Edges without self-loops or duplicates, sorted by (src, dst)."""
    keep = src != dst
    key = torch.unique(src[keep] * n + dst[keep])
    return key // n, key % n


def kron(scale: int, edge_factor: int, a: float, b: float, c: float,
         permute: bool, gen: torch.Generator, device):
    """Graph500's Kronecker graph as undirected pairs ``src < dst``, one
    per unordered pair: ``(src, dst, n)``.  ``permute`` relabels the
    vertices by a seeded permutation, as Graph500 and GAP do, so that the
    hubs do not sit together at the lowest ids."""
    n = 1 << scale
    s, d = rmat_edges(n * edge_factor, scale, a, b, c, gen, device)
    if permute:
        perm = torch.randperm(n, generator=gen, device=device)
        s, d = perm[s], perm[d]
        del perm
    lo, hi = torch.minimum(s, d), torch.maximum(s, d)
    del s, d
    src, dst = _unique_edges(lo, hi, n)
    return src, dst, n


def crawl(n_communities: int, community_scale: int, edge_factor: int,
          inter_links: int, hub_links: bool, a: float, b: float, c: float,
          gen: torch.Generator, device):
    """The repository's ``web_crawl_like`` shape, directed: RMAT
    communities of ``2**community_scale`` vertices laid out one after the
    other, each pair of neighbours joined by ``inter_links`` random
    forward links and their back links; ``hub_links`` also joins each
    community's local vertex 0 to the next one's, both ways.
    Returns ``(src, dst, n)``."""
    c_n = 1 << community_scale
    per = c_n * edge_factor
    n = n_communities * c_n
    src, dst = rmat_edges(n_communities * per, community_scale, a, b, c, gen,
                          device)
    offset = torch.arange(n_communities, dtype=torch.int64, device=device) * c_n
    offset = offset.repeat_interleave(per)
    src += offset
    dst += offset
    del offset
    base = torch.arange(n_communities - 1, dtype=torch.int64, device=device) * c_n
    u = torch.randint(0, c_n, (n_communities - 1, inter_links), generator=gen,
                      device=device) + base[:, None]
    v = torch.randint(0, c_n, (n_communities - 1, inter_links), generator=gen,
                      device=device) + (base + c_n)[:, None]
    ls, ld = [src, u.reshape(-1), v.reshape(-1)], [dst, v.reshape(-1), u.reshape(-1)]
    if hub_links:
        ls += [base, base + c_n]
        ld += [base + c_n, base]
    src, dst = torch.cat(ls), torch.cat(ld)
    src, dst = _unique_edges(src, dst, n)
    return src, dst, n


def weights(m: int, lo: float, hi: float, gen: torch.Generator, device):
    """Uniform float32 weights on [lo, hi), one per edge."""
    return torch.empty(m, dtype=torch.float32, device=device).uniform_(
        lo, hi, generator=gen)


GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0


def spread_positions(start: float, first: int, count: int):
    """Positions in [0, 1) of trials ``first .. first + count - 1``: a
    golden-ratio sequence from ``start``.  Any run of consecutive trials
    covers [0, 1) evenly, so the work of a window barely depends on the
    seed's ``start``."""
    k = torch.arange(first, first + count, dtype=torch.float64)
    return torch.remainder(start + k * GOLDEN, 1.0)


def largest_component(src, dst, n: int) -> torch.Tensor:
    """(n,) bool: the vertices of the largest weakly connected component,
    by min-label propagation over the edges with pointer jumping (the
    smallest id of a component wins; ties in size go to it too)."""
    lab = torch.arange(n, dtype=torch.int64, device=src.device)
    while True:
        low = torch.minimum(lab[src], lab[dst])
        new = lab.clone()
        new.scatter_reduce_(0, src, low, reduce="amin")
        new.scatter_reduce_(0, dst, low, reduce="amin")
        del low
        while True:
            jumped = new[new]
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, lab):
            break
        lab = new
    size = torch.bincount(lab, minlength=n)
    return lab == int(torch.argmax(size))


def candidates(src, dst, n: int, rule: str, order: str, undirected: bool):
    """The vertices a source may be drawn from, in the order the spread
    sequence walks: ``rule`` "degree" (an edge at either end of an
    undirected pair), "giant" (a vertex of the largest component, so that
    no trial ends in a small piece) or "out_degree"; ``order`` "degree"
    (ascending, ties by id) or "id"."""
    deg = torch.bincount(src, minlength=n)
    if undirected:
        deg += torch.bincount(dst, minlength=n)
    if rule not in ("degree", "giant", "out_degree"):
        raise ValueError(f"unknown source rule {rule!r}")
    if rule == "out_degree" and undirected:
        raise ValueError("out_degree sources need a directed graph")
    if rule == "giant":
        cand = torch.nonzero((deg > 0) & largest_component(src, dst, n)).squeeze(1)
    else:
        cand = torch.nonzero(deg > 0).squeeze(1)
    if order == "degree":
        cand = cand[torch.sort(deg[cand], stable=True).indices]
    elif order != "id":
        raise ValueError(f"unknown source order {order!r}")
    return cand


def sources(cand: torch.Tensor, start: float, first: int, count: int) -> list:
    """The sources of trials ``first .. first + count - 1``."""
    pos = spread_positions(start, first, count)
    idx = torch.clamp((pos * cand.numel()).to(torch.int64), max=cand.numel() - 1)
    return cand[idx.to(cand.device)].tolist()
