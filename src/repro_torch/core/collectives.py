"""The virtual mesh's collectives and its shard-local relax.

On the port's mesh (``core/mesh.py``) every position's accumulator is row
``d`` of one (D, ...) tensor, so the reference's collectives become
reductions over that leading axis:

* ``kind_reduce`` — ``pmin`` / ``pmax`` / ``psum`` of a stack (an ``or``
  as a max, a bool as uint8).  Float min/max reduce under the ordered-int
  key of ``kernels/graph_ops/ref.py`` (-0.0 < +0.0), the order every
  other f32 min/max of the port uses, so a sharded min is bitwise the
  unsharded scatter's.
* ``merge`` — fold a reduced accumulator into the caller's ``out_init``,
  the merge a single-device scatter performs.
* ``local_relax`` — one shard's relax through the substrate seam: the
  ``edge_relax`` kernel (``"cuda"``; its wrapper takes the plain version
  on CPU tensors) or the plain version (``"torch"``), optionally gated by
  a 0-d int32 device flag.
"""

from __future__ import annotations

import torch

from ..kernels import graph_ops as gk
from ..kernels.graph_ops import ref


def _amin_amax(stack: torch.Tensor, kind: str, dim: int) -> torch.Tensor:
    op = torch.amin if kind == "min" else torch.amax
    if stack.dtype == torch.float32:
        return ref._from_ordered_key(op(ref._ordered_key(stack), dim))
    return op(stack, dim)


def kind_reduce(stack: torch.Tensor, kind: str, dim: int = 0) -> torch.Tensor:
    """Reduce the per-position contributions along ``dim`` by ``kind``."""
    widened = stack.dtype == torch.bool
    work = stack.to(torch.uint8) if widened else stack
    if kind in ("min", "max"):
        out = _amin_amax(work, kind, dim)
    elif kind == "or":
        out = _amin_amax(work, "max", dim)
    elif kind == "add":
        out = work.sum(dim, dtype=work.dtype)
    else:
        raise ValueError(kind)
    return out.to(torch.bool) if widened else out


def merge(out_init: torch.Tensor, acc: torch.Tensor, kind: str) -> torch.Tensor:
    """The reduced accumulator folded into ``out_init``."""
    if kind == "add":
        return out_init + acc
    if kind == "or" and out_init.dtype == torch.bool:
        return out_init | acc.to(torch.bool)
    return kind_reduce(torch.stack([out_init, acc.to(out_init.dtype)]),
                       "max" if kind == "or" else kind)


def local_relax(src, dst, w, mask, src_val, neutral_init, kind: str,
                use_weight: bool, vertex_mask: bool, substrate: str, *,
                case: str | None = None, gate=None) -> torch.Tensor:
    """One shard's relax into ``neutral_init`` (a fresh result).  ``gate``:
    None, or a 0-d int32 device tensor; where it is 0 the result is
    ``neutral_init`` (the kernel seeds and returns; the plain version is
    ``torch.where(gate, relaxed, neutral_init)``)."""
    if substrate == "cuda":
        return gk.edge_relax(src, dst, w, mask, src_val, neutral_init, kind=kind,
                             use_weight=use_weight, vertex_mask=vertex_mask,
                             case=case, gate=gate)
    if vertex_mask:
        out = gk.push_ref(src, dst, w, src_val, mask, neutral_init, kind, use_weight)
    else:
        out = gk.relax_ref(src, dst, w, mask, src_val, neutral_init, kind, use_weight)
    return out if gate is None else ref.gated(gate, out, neutral_init)
