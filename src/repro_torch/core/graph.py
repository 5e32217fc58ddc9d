"""Block-padded CSR/CSC/COO graph container, as torch tensors.

The same container as ``repro.core.graph``: every array is padded to a
multiple of ``block_size`` edges / vertices, vertex arrays carry one
sentinel slot at ``n_pad - 1``, padded edges point at the sentinel (weight
0), and the CSC mirror is optional.  The host build is numpy, op for op
the reference's, and the finished arrays are copied to the device once.

Index arrays are int32 and weights float32, as in the reference.  Tensors
land on ``cuda`` unless the caller passes ``device=`` (the tests pass
``"cpu"``); algorithms follow the device of the graph they are given.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

_ARRAYS = ("row_ptr", "col_idx", "src_idx", "edge_w", "out_deg",
           "in_row_ptr", "in_col_idx", "in_src_idx", "in_edge_w", "in_deg")


def default_device() -> torch.device:
    """``cuda`` when a card is present; raises otherwise, so a run never
    carries on on the CPU without the caller asking for it."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain torch version on the CPU")
    return torch.device("cuda")


def _device(device) -> torch.device:
    return default_device() if device is None else torch.device(device)


def _pad_to(x: np.ndarray, size: int, fill) -> np.ndarray:
    if x.shape[0] == size:
        return x
    out = np.full((size,) + x.shape[1:], fill, dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


def set_at(t: torch.Tensor, i: int, value) -> torch.Tensor:
    """``t[i] = value`` as a fill of a one-element view: a kernel on the
    device, where ``t[i] = value`` copies a host scalar over (a blocking
    copy, which a CUDA graph capture refuses).  Returns ``t``."""
    i %= t.shape[0]
    t[i:i + 1].fill_(value)
    return t


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class Graph:
    """Static-shape padded graph (field meanings as in the reference).

    n, m:          true vertex / edge counts.
    n_pad, m_pad:  padded counts; ``n_pad - 1`` is the sentinel vertex.
    row_ptr:       (n_pad + 1,) CSR offsets over out-edges.
    col_idx:       (m_pad,) destination of each out-edge; padding = sentinel.
    src_idx:       (m_pad,) source of each out-edge.
    edge_w:        (m_pad,) float32 weights (0 on padding).
    out_deg:       (n_pad,) true out-degree (0 on the sentinel).
    in_*:          optional CSC mirror, same conventions.
    """

    n: int
    m: int
    n_pad: int
    m_pad: int
    block_size: int

    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    src_idx: torch.Tensor
    edge_w: torch.Tensor
    out_deg: torch.Tensor

    in_row_ptr: Optional[torch.Tensor] = None
    in_col_idx: Optional[torch.Tensor] = None
    in_src_idx: Optional[torch.Tensor] = None
    in_edge_w: Optional[torch.Tensor] = None
    in_deg: Optional[torch.Tensor] = None

    @property
    def sentinel(self) -> int:
        return self.n_pad - 1

    @property
    def has_csc(self) -> bool:
        return self.in_row_ptr is not None

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    def vertex_full(self, fill, dtype) -> torch.Tensor:
        """A vertex-indexed array (with sentinel slot) filled with ``fill``."""
        return torch.full((self.n_pad,), fill, dtype=dtype, device=self.device)

    def valid_vertex_mask(self) -> torch.Tensor:
        return torch.arange(self.n_pad, device=self.device) < self.n

    def budget_edge_mass(self, mask: torch.Tensor) -> torch.Tensor:
        """Frontier edge mass a sparse-advance budget must cover: the whole
        frontier's out-degree sum (a 0-d int32 tensor)."""
        return torch.where(mask, self.out_deg, 0).sum(dtype=torch.int32)

    @property
    def csr_bytes(self) -> int:
        """Bytes of the padded CSR edge arrays (col_idx + src_idx + edge_w)."""
        return self.m_pad * (4 + 4 + 4)


def shard_ranges(g: Graph, nshards: int):
    """Block-granular contiguous shard cut of the CSR edge arrays:
    ``(vtx_bounds, edge_bounds)`` as in the reference."""
    per = -(-g.n_pad // nshards)
    per = round_up(per, g.block_size)
    vtx = np.minimum(np.arange(nshards + 1, dtype=np.int64) * per, g.n_pad)
    rp = g.row_ptr.cpu().numpy()
    edge = rp[vtx].astype(np.int64)
    return vtx, edge


def from_arrays(arrays: dict, *, n: int, m: int, n_pad: int, m_pad: int,
                block_size: int, device=None) -> Graph:
    """Build a Graph from host arrays keyed by field name (the optional CSC
    fields may be missing or None) plus the static ints.  This is how a
    container built by another implementation, e.g. the JAX package's
    ``Graph`` read out with ``np.asarray``, is carried across unchanged."""
    dev = _device(device)
    tensors = {}
    for name in _ARRAYS:
        a = arrays.get(name)
        if a is not None:
            tensors[name] = torch.from_numpy(
                np.require(a, requirements=["C", "W"])).to(dev)
    return Graph(n=n, m=m, n_pad=n_pad, m_pad=m_pad, block_size=block_size,
                 **tensors)


def from_coo(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    weights: Optional[np.ndarray] = None,
    *,
    block_size: int = 512,
    build_csc: bool = False,
    symmetrize: bool = False,
    dedup: bool = True,
    device=None,
) -> Graph:
    """Build a padded Graph from host COO arrays (numpy), then copy it to
    ``device`` (``cuda`` by default)."""
    dev = _device(device)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if weights is None:
        w = np.ones(src.shape[0], dtype=np.float32)
    else:
        w = np.asarray(weights, dtype=np.float32)

    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])

    if dedup:
        # self-loops dropped; duplicate (src, dst) edges keep the MINIMUM
        # weight, so the result does not depend on input edge order
        keep = src != dst
        src, dst, w = src[keep], dst[keep], w[keep]
        key = src * np.int64(n) + dst
        order = np.lexsort((w, key))     # per key, smallest weight first
        key, src, dst, w = key[order], src[order], dst[order], w[order]
        _, first = np.unique(key, return_index=True)
        src, dst, w = src[first], dst[first], w[first]

    m = int(src.shape[0])
    n_pad = round_up(n + 1, block_size)
    m_pad = round_up(max(m, 1), block_size)
    sentinel = n_pad - 1

    def build(direction_src, direction_dst):
        order = np.lexsort((direction_dst, direction_src))
        s, d, ww = direction_src[order], direction_dst[order], w[order]
        counts = np.bincount(s, minlength=n_pad).astype(np.int32)
        counts[sentinel] = 0
        rp = np.zeros(n_pad + 1, dtype=np.int32)
        np.cumsum(counts, out=rp[1:])
        ci = _pad_to(d.astype(np.int32), m_pad, sentinel)
        si = _pad_to(s.astype(np.int32), m_pad, sentinel)
        ew = _pad_to(ww, m_pad, 0.0)
        return rp, ci, si, ew, counts

    arrays = dict(zip(("row_ptr", "col_idx", "src_idx", "edge_w", "out_deg"),
                      build(src, dst)))
    if build_csc:
        # for CSC the "row" is the destination and the stored index the
        # source: in_col_idx = in-neighbour, in_src_idx = the destination
        arrays.update(zip(("in_row_ptr", "in_col_idx", "in_src_idx",
                           "in_edge_w", "in_deg"), build(dst, src)))
    return from_arrays(arrays, n=n, m=m, n_pad=n_pad, m_pad=m_pad,
                       block_size=block_size, device=dev)


def to_dense(g: Graph) -> np.ndarray:
    """Dense adjacency (host, test-sized graphs only)."""
    a = np.zeros((g.n, g.n), dtype=np.float32)
    src = g.src_idx.cpu().numpy()
    dst = g.col_idx.cpu().numpy()
    w = g.edge_w.cpu().numpy()
    valid = (src < g.n) & (dst < g.n)
    a[src[valid], dst[valid]] = w[valid]
    return a


def degrees_from_edges(src: torch.Tensor, n_pad: int) -> torch.Tensor:
    return torch.zeros((n_pad,), dtype=torch.int32, device=src.device).index_add_(
        0, src, torch.ones_like(src, dtype=torch.int32))
