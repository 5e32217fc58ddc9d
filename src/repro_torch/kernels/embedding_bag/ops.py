"""Public wrapper with sum/mean modes, the counterpart of
``src/repro/kernels/embedding_bag/ops.py``.  Note the argument order:
``(ids, table, weights)`` here, ``(ids, weights, table)`` for the kernel,
as in the JAX package."""

from __future__ import annotations

import torch

from .embedding_bag import embedding_bag as _kernel


def embedding_bag(ids, table, weights=None, mode: str = "sum"):
    """ids (B, L) int32, -1 padding; table (V, D).  mode is "sum" or
    "mean"; "mean" divides by max(sum of the valid slots' weights, 1e-9)."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', not {mode!r}")
    if weights is None:
        weights = torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
    out = _kernel(ids, weights, table)
    if mode == "mean":
        cnt = torch.where(ids >= 0, weights, 0.0).sum(1, keepdim=True)
        out = out / cnt.clamp_min(1e-9)
    return out
