"""Plain torch semantics of the graph edge-relaxation operators.

The array-level contract both substrates implement, op for op the JAX
package's ``kernels/graph_ops/ref.py``: raw arrays in, never the engine's
containers.  These functions are the ``"torch"`` substrate, the version a
kernel wrapper takes for tensors on the CPU, and the oracle the CUDA
kernels are held against on the card.

Reduction kinds: ``min`` / ``max`` (tropical relax, message = v + w),
``add`` (message = v * w) and ``or`` (boolean reachability, reduced as a
max over uint8 so duplicate destinations combine correctly).

Float ``min``/``max`` reduce under one total order: the float's bits read
as an "ordered int" (``_ordered_key``), in which -0.0 < +0.0.  That is
XLA's order for signed zeros and the order the CUDA kernel's integer
atomics realise, so results are bitwise equal to both and do not depend
on the order in which duplicates reach a destination.

Index results stay int32 as in the reference: ``cumsum`` is given
``dtype=int32`` and ``searchsorted`` ``out_int32=True``; indices are
widened to int64 only where ``scatter`` needs it.
"""

from __future__ import annotations

import torch

KINDS = ("min", "max", "add", "or")

_FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


def neutral_for(kind: str, dtype) -> torch.Tensor:
    """Identity element of the reduction, in the accumulator's dtype."""
    if kind in ("add", "or"):
        return torch.zeros((), dtype=dtype)
    if dtype == torch.bool:
        return torch.tensor(kind == "min", dtype=dtype)
    info = torch.finfo(dtype) if dtype in _FLOATS else torch.iinfo(dtype)
    if kind == "min":
        return torch.tensor(info.max, dtype=dtype)
    if kind == "max":
        return torch.tensor(info.min, dtype=dtype)
    raise ValueError(kind)


def _ordered_key(x: torch.Tensor) -> torch.Tensor:
    """float32 → int32 key whose integer order is the float order, with
    -0.0 < +0.0 (sign-magnitude bits → two's complement)."""
    bits = x.view(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def _from_ordered_key(k: torch.Tensor) -> torch.Tensor:
    return torch.where(k >= 0, k, k ^ 0x7FFFFFFF).view(torch.float32)


def scatter_reduce(dst, msg, out, kind: str):
    """Reduce ``msg`` into (a copy of) ``out`` at positions ``dst``."""
    idx = dst.long()
    if kind == "add":
        return out.index_add(0, dst, msg.to(out.dtype))
    if kind == "or":
        if out.dtype == torch.bool:
            # scatter-max over uint8: duplicate destinations OR together
            red = out.to(torch.uint8).scatter_reduce(
                0, idx, msg.to(torch.uint8), "amax")
            return red.to(torch.bool)
        return out.scatter_reduce(0, idx, msg.to(out.dtype), "amax")
    if kind not in ("min", "max"):
        raise ValueError(kind)
    reduce = "amin" if kind == "min" else "amax"
    if out.dtype == torch.float32:
        key = _ordered_key(out).scatter_reduce(
            0, idx, _ordered_key(msg.to(out.dtype)), reduce)
        return _from_ordered_key(key)
    return out.scatter_reduce(0, idx, msg.to(out.dtype), reduce)


def edge_message(v, w, kind: str, use_weight: bool):
    """Per-edge message: tropical (v + w) for min/max, scaled (v * w) for
    add/or; the carried value alone when unweighted."""
    if not use_weight:
        return v
    return v + w if kind in ("min", "max") else v * w


def _masked(msg, keep, kind, dtype):
    # the neutral goes in as a Python scalar: no host-to-device copy
    return torch.where(keep, msg.to(dtype), neutral_for(kind, dtype).item())


def det_scatter_add(dst, msg, out):
    """Fixed-order scatter-add: stable sort by destination, a fixed-shape
    segmented (Hillis–Steele) sum of each destination's messages, then
    exactly one combined value per destination added into ``out``.  Op for
    op the reference's, so float results are bitwise equal to it."""
    m = int(msg.shape[0])
    order = torch.sort(dst, stable=True).indices
    seg = dst[order]
    val = msg[order]
    zero = torch.zeros((), dtype=val.dtype, device=val.device)
    k = 1
    while k < m:
        shifted = torch.cat([zero.expand(k), val[:-k]])
        same = torch.cat([torch.zeros(k, dtype=torch.bool, device=val.device),
                          seg[k:] == seg[:-k]])
        val = val + torch.where(same, shifted, zero)
        k *= 2
    # the last slot of each run holds the segment sum; every other slot
    # adds the exact zero of the dtype
    is_tail = torch.cat([seg[1:] != seg[:-1],
                         torch.ones(1, dtype=torch.bool, device=val.device)])
    return out.index_add(0, seg, torch.where(is_tail, val, zero))


def det_push_ref(src, dst, w, src_val, active, out_init,
                 use_weight: bool = True):
    """``push_ref(kind="add")`` with the deterministic fixed-order sum."""
    msg = edge_message(src_val[src], w, "add", use_weight)
    return det_scatter_add(dst, _masked(msg, active[src], "add", out_init.dtype),
                           out_init)


def det_relax_ref(src, dst, w, valid, src_val, out_init,
                  use_weight: bool = True):
    """``relax_ref(kind="add")`` with the deterministic fixed-order sum."""
    msg = edge_message(src_val[src], w, "add", use_weight)
    return det_scatter_add(dst, _masked(msg, valid, "add", out_init.dtype),
                           out_init)


def push_ref(src, dst, w, src_val, active, out_init, kind: str = "min",
             use_weight: bool = True):
    """Masked push over an edge list: relax every edge whose source is active."""
    msg = edge_message(src_val[src], w, kind, use_weight)
    msg = _masked(msg, active[src], kind, out_init.dtype)
    return scatter_reduce(dst, msg, out_init, kind)


def pull_ref(nbr, dst, w, src_val, active, out_init, kind: str = "min",
             use_weight: bool = True):
    """Pull over in-edges grouped by destination: each destination's
    messages reduced, then merged into ``out_init``.  ``add`` sums the
    messages first and adds the segment sums to ``out_init``, as the
    reference's ``segment_sum`` does; min/max/or are order-free."""
    msg = edge_message(src_val[nbr], w, kind, use_weight)
    msg = _masked(msg, active[nbr], kind, out_init.dtype)
    if kind == "add":
        return out_init + torch.zeros_like(out_init).index_add(0, dst, msg)
    return scatter_reduce(dst, msg, out_init, kind)


def sorted_lower_bound(rows, vals):
    """Branchless per-row lower bound: for each query ``vals[..., j]`` the
    index of the first element of ``rows[..., :]`` that is >= it."""
    dmax = rows.shape[-1]
    lo = torch.zeros(vals.shape, dtype=torch.int32, device=vals.device)
    hi = torch.full(vals.shape, dmax, dtype=torch.int32, device=vals.device)
    for _ in range(max(int(dmax).bit_length(), 1)):
        mid = (lo + hi) >> 1
        probe = torch.gather(rows, -1, mid.clamp(0, dmax - 1).long())
        less = probe < vals
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    return lo


def intersect_ref(adj, src, dst, sentinel: int):
    """Oriented triangle intersection count over an edge batch: the int32
    total of |N+(src_i) ∩ N+(dst_i)|."""
    nu = adj[src]
    nv = adj[dst]
    pos = sorted_lower_bound(nv, nu)
    dmax = adj.shape[-1]
    hit = torch.gather(nv, -1, pos.clamp(0, dmax - 1).long()) == nu
    hit &= nu != sentinel
    return hit.sum(dtype=torch.int32)


def advance_ref(f_idx, f_count, out_deg, row_ptr, col_idx, edge_w,
                budget: int, sentinel: int, m_pad: int):
    """Merge-path expansion of a compacted frontier into ``budget`` edge
    slots.  Returns ``(src, dst, w, valid, total)``; ``total`` is the true
    frontier edge mass (a 0-d int32 tensor, the overflow check)."""
    dev = f_idx.device
    cap = f_idx.shape[0]
    in_list = torch.arange(cap, device=dev) < torch.clamp(
        torch.as_tensor(f_count, device=dev), max=cap)
    deg = torch.where(in_list, out_deg[f_idx], 0)
    cum = torch.cumsum(deg, 0, dtype=torch.int32)
    total = cum[-1]
    j = torch.arange(budget, dtype=torch.int32, device=dev)
    k = torch.searchsorted(cum, j, right=True, out_int32=True)
    k = k.clamp(0, cap - 1)
    prev = torch.where(k > 0, cum[(k - 1).clamp(min=0)], 0)
    u = f_idx[k]
    e = row_ptr[u] + (j - prev)
    valid = j < total
    e = torch.where(valid, e, m_pad - 1)  # padded edge → sentinel dst, w=0
    u = torch.where(valid, u, sentinel)
    return u, col_idx[e], edge_w[e], valid, total


def relax_ref(src, dst, w, valid, src_val, out_init, kind: str = "min",
              use_weight: bool = True):
    """Scatter-relax an expanded edge batch (per-edge validity mask)."""
    msg = edge_message(src_val[src], w, kind, use_weight)
    msg = _masked(msg, valid, kind, out_init.dtype)
    return scatter_reduce(dst, msg, out_init, kind)
