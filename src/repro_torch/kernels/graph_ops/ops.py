"""Wrappers of the graph_ops CUDA kernels (``csrc/graph_ops.cu``).

On CUDA tensors a wrapper checks device, dtype, shape and contiguity,
allocates its outputs with ``torch.empty``, launches on the current
stream, raises when the launch function reports an error, and adds one to
its ``launches`` count.  On CPU tensors it calls the plain version in
``ref.py`` and launches nothing.  There is no other path: a CUDA tensor
the kernel does not take raises.
"""

from __future__ import annotations

import torch

from . import build, ref

_KIND = {"min": 0, "max": 1, "add": 2, "or": 3}
_DTYPE = {torch.float32: 0, torch.int32: 1, torch.uint8: 2}
# (dtype, kind) pairs the edge_relax kernel takes, and whether weighted
_RELAX_TYPES = {
    (torch.float32, "min"): True, (torch.float32, "max"): True,
    (torch.float32, "add"): True,
    (torch.int32, "min"): False, (torch.int32, "max"): False,
    (torch.uint8, "or"): False,
}


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _expect(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def edge_relax(src, dst, w, mask, src_val, out_init, *, kind: str = "min",
               use_weight: bool = True, vertex_mask: bool = True):
    """Push/pull/batch relax over an edge list.

    ``mask``: (n_pad,) active-vertex bitmap when ``vertex_mask`` (push and
    pull), else a per-edge validity mask aligned with ``src`` (batch
    relax).  Returns a new (n_pad,) accumulator seeded from ``out_init``.
    """
    if src.device.type == "cpu":
        if vertex_mask:
            return ref.push_ref(src, dst, w, src_val, mask, out_init, kind,
                                use_weight)
        return ref.relax_ref(src, dst, w, mask, src_val, out_init, kind,
                             use_weight)
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"edge_relax runs on cuda or cpu tensors, not {dev}")
    m = src.shape[0]
    n_pad = out_init.shape[0]
    widen = kind == "or" and out_init.dtype == torch.bool
    if widen:
        # bool has no atomics: reduce as uint8 max (ref.scatter_reduce's 'or')
        src_val = src_val.to(torch.uint8)
        out_init = out_init.to(torch.uint8)
    weighted = _RELAX_TYPES.get((out_init.dtype, kind))
    if weighted is None or (use_weight and not weighted):
        raise TypeError(f"edge_relax kernel does not take kind={kind!r} over "
                        f"{out_init.dtype} with use_weight={use_weight}")
    _expect(src, "src", torch.int32, (m,), dev)
    _expect(dst, "dst", torch.int32, (m,), dev)
    _expect(w, "w", torch.float32, (m,), dev)
    _expect(mask, "mask", torch.bool, (n_pad if vertex_mask else m,), dev)
    _expect(src_val, "src_val", out_init.dtype, (n_pad,), dev)
    _expect(out_init, "out_init", out_init.dtype, (n_pad,), dev)
    out = torch.empty_like(out_init)
    out.copy_(out_init)
    if kind == "or" and (n_pad % 4 or out.data_ptr() % 4):
        raise ValueError("the 'or' kernel updates aligned 32-bit words: "
                         "n_pad must be a multiple of 4")
    lib = build.load("graph_ops")
    rc = lib.graph_ops_edge_relax(
        src.data_ptr(), dst.data_ptr(), w.data_ptr(), mask.data_ptr(),
        src_val.data_ptr(), out.data_ptr(), m, _DTYPE[out.dtype], _KIND[kind],
        int(use_weight), int(vertex_mask), _stream())
    build.check(lib, rc, "edge_relax")
    edge_relax.launches += 1
    return out.to(torch.bool) if widen else out


edge_relax.launches = 0


def advance_frontier(f_idx, f_count, out_deg, row_ptr, col_idx, edge_w, *,
                     budget: int, sentinel: int, m_pad: int):
    """Merge-path frontier expansion into ``budget`` edge slots; returns
    ``(src, dst, w, valid, total)`` with ``total`` a 0-d int32 tensor."""
    if f_idx.device.type == "cpu":
        return ref.advance_ref(f_idx, f_count, out_deg, row_ptr, col_idx,
                               edge_w, budget, sentinel, m_pad)
    dev = f_idx.device
    if dev.type != "cuda":
        raise ValueError(f"advance_frontier runs on cuda or cpu tensors, not {dev}")
    cap = f_idx.shape[0]
    n_pad = out_deg.shape[0]
    if not (0 < cap <= n_pad and 0 < budget < 2**31 and m_pad == col_idx.shape[0]):
        raise ValueError(f"bad advance shapes: cap={cap} n_pad={n_pad} "
                         f"budget={budget} m_pad={m_pad}/{col_idx.shape[0]}")
    _expect(f_idx, "f_idx", torch.int32, (cap,), dev)
    _expect(f_count, "f_count", torch.int32, (), dev)
    _expect(out_deg, "out_deg", torch.int32, (n_pad,), dev)
    _expect(row_ptr, "row_ptr", torch.int32, (n_pad + 1,), dev)
    _expect(col_idx, "col_idx", torch.int32, (m_pad,), dev)
    _expect(edge_w, "edge_w", torch.float32, (m_pad,), dev)
    i32 = dict(dtype=torch.int32, device=dev)
    cum = torch.empty((cap,), **i32)
    tiles = torch.empty(((cap + 1023) // 1024,), **i32)
    total = torch.empty((1,), **i32)
    out_src = torch.empty((budget,), **i32)
    out_dst = torch.empty((budget,), **i32)
    out_w = torch.empty((budget,), dtype=torch.float32, device=dev)
    valid = torch.empty((budget,), dtype=torch.bool, device=dev)
    lib = build.load("graph_ops")
    rc = lib.graph_ops_advance(
        f_idx.data_ptr(), f_count.data_ptr(), out_deg.data_ptr(),
        row_ptr.data_ptr(), col_idx.data_ptr(), edge_w.data_ptr(), cap, budget,
        sentinel, m_pad, cum.data_ptr(), tiles.data_ptr(), total.data_ptr(),
        out_src.data_ptr(), out_dst.data_ptr(), out_w.data_ptr(),
        valid.data_ptr(), _stream())
    build.check(lib, rc, "advance_frontier")
    advance_frontier.launches += 1
    return out_src, out_dst, out_w, valid, total[0]


advance_frontier.launches = 0


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    edge_relax.launches = 0
    advance_frontier.launches = 0


def launch_counts() -> dict:
    return {"edge_relax": edge_relax.launches,
            "advance": advance_frontier.launches}
