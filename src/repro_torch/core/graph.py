"""Block-padded CSR/CSC/COO graph container, as torch tensors.

The same container as ``repro.core.graph``: every array is padded to a
multiple of ``block_size`` edges / vertices, vertex arrays carry one
sentinel slot at ``n_pad - 1``, padded edges point at the sentinel (weight
0), and the CSC mirror is optional.  ``from_coo`` copies the COO arrays to
the device once and builds there in torch, bitwise the reference's numpy
build.

Index arrays are int32 and weights float32, as in the reference.  Tensors
land on ``cuda`` unless the caller passes ``device=`` (the tests pass
``"cpu"``); algorithms follow the device of the graph they are given.
"""

from __future__ import annotations

import dataclasses
import time
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


def _float_order_key(w: torch.Tensor) -> torch.Tensor:
    """An int32 key whose integer order is numpy's sort order of the
    float32 ``w``: -0.0 and +0.0 share a key (numpy treats them as equal and
    a stable sort keeps them in input order) and every NaN takes one key
    above +inf (numpy puts NaNs last, in input order)."""
    bits = w.view(torch.int32)
    key = torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)
    return key.masked_fill_(torch.isnan(w), 0x7F800001)


def _stable_order(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, stable=True).indices


def _on_device(a, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.require(a, dtype, ["C", "W"])).to(dev)


def _csr(s: torch.Tensor, d: torch.Tensor, w: torch.Tensor, n_pad: int,
         m_pad: int):
    """The padded CSR of edges already sorted by (s, d): row_ptr, col_idx,
    src_idx, edge_w and the degrees, as the reference's ``build``."""
    sentinel = n_pad - 1
    counts = degrees_from_edges(s, n_pad)
    set_at(counts, sentinel, 0)
    rp = torch.zeros(n_pad + 1, dtype=torch.int32, device=s.device)
    torch.cumsum(counts, 0, dtype=torch.int32, out=rp[1:])

    def pad(x, dtype, fill):
        out = torch.full((m_pad,), fill, dtype=dtype, device=s.device)
        out[: x.shape[0]] = x
        return out

    return (rp, pad(d, torch.int32, sentinel), pad(s, torch.int32, sentinel),
            pad(w, torch.float32, 0.0), counts)


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
    timings: Optional[dict] = None,
) -> Graph:
    """Build a padded Graph from host COO arrays (numpy) on ``device``
    (``cuda`` by default), bitwise the reference's numpy build.

    The arrays are copied to the device once; symmetrizing, the dedup, the
    sorts, the degrees and the padding run there in torch, and the host
    fetches scalars only: the ids' range (ids outside [0, n) raise) and
    ``m``.  Integer sorts are stable, least significant key
    first, as ``np.lexsort``; the dedup's weight order sorts an integer key
    of the float's bits (``_float_order_key``), not the float.  A
    ``timings`` dict gets each stage's seconds ("copy", "dedup", "csr",
    "csc"), the device synchronized at each stage's end."""
    dev = _device(device)
    clock = [time.perf_counter()]

    def stage(name):
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            timings[name] = now - clock[0]
            clock[0] = now

    src = _on_device(src, np.int64, dev)
    dst = _on_device(dst, np.int64, dev)
    if weights is None:
        w = torch.ones(src.shape[0], dtype=torch.float32, device=dev)
    else:
        w = _on_device(weights, np.float32, dev)
    if src.shape[0]:
        lo, hi = torch.stack([torch.minimum(src.min(), dst.min()),
                              torch.maximum(src.max(), dst.max())]).tolist()
        if lo < 0 or hi >= n:
            raise ValueError(f"vertex ids span [{lo}, {hi}], outside [0, {n})")
    stage("copy")

    if symmetrize:
        src, dst = torch.cat([src, dst]), torch.cat([dst, src])
        w = torch.cat([w, w])

    n_pad = round_up(n + 1, block_size)
    if dedup:
        # self-loops dropped; duplicate (src, dst) edges keep the MINIMUM
        # weight (the first in input order among equal ones), so the result
        # does not depend on input edge order: the reference's
        # lexsort((w, key)) and first of each key
        if weights is None:
            order = _stable_order(src * n + dst)
        else:
            order = _stable_order(_float_order_key(w))
            order = order[_stable_order((src * n + dst)[order])]
        src, dst, w = src[order], dst[order], w[order]
        keep = torch.ones_like(src, dtype=torch.bool)
        keep[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
        keep &= src != dst
        m = int(keep.sum())
        first = torch.nonzero_static(keep, size=m).squeeze(1)
        src, dst, w = src[first], dst[first], w[first]
    else:
        m = int(src.shape[0])
        order = _stable_order(src * n_pad + dst)
        src, dst, w = src[order], dst[order], w[order]
    stage("dedup")

    m_pad = round_up(max(m, 1), block_size)
    tensors = dict(zip(("row_ptr", "col_idx", "src_idx", "edge_w", "out_deg"),
                       _csr(src, dst, w, n_pad, m_pad)))
    stage("csr")
    if build_csc:
        # for CSC the "row" is the destination and the stored index the
        # source: in_col_idx = in-neighbour, in_src_idx = the destination;
        # stable, so duplicates keep their input order as in the CSR
        order = _stable_order(dst * n_pad + src)
        tensors.update(zip(("in_row_ptr", "in_col_idx", "in_src_idx",
                            "in_edge_w", "in_deg"),
                           _csr(dst[order], src[order], w[order], n_pad, m_pad)))
        stage("csc")
    return Graph(n=n, m=m, n_pad=n_pad, m_pad=m_pad, block_size=block_size,
                 **tensors)


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
