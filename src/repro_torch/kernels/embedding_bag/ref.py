"""Plain torch versions of the embedding bag.

* ``embedding_bag_plain`` — what the CUDA kernel computes, rounded where the
  JAX kernel (``src/repro/kernels/embedding_bag/embedding_bag.py``) rounds:
  per slot, in slot order, ``o = T(o + T(row * w))`` in the table's dtype
  ``T``.  The kernel wrapper takes it for CPU tensors, and the kernel is
  bitwise equal to it on the card.
* ``embedding_bag_ref`` — the JAX package's oracle (``ref.py``): gather,
  then one weighted sum in f32, rounded once.

Both skip slots whose id is negative and read row ``V - 1`` for an id of
``V`` or more, as the oracle's gather clamps it.
"""

from __future__ import annotations

import torch


def embedding_bag_plain(ids, weights, table):
    """ids (B, L) int32, -1 = padding; weights (B, L) f32; table (V, D).
    Returns (B, D) in the table's dtype."""
    v = table.shape[0]
    rows = ids.clamp(0, v - 1).long()
    out = torch.zeros((ids.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    for slot in range(ids.shape[1]):
        t = (table[rows[:, slot]].float() * weights[:, slot, None].float()).to(table.dtype)
        out = torch.where(ids[:, slot, None] >= 0, out + t, out)
    return out


def embedding_bag_ref(ids, weights, table):
    """The oracle: take + masked weighted sum in f32, cast to the table's
    dtype."""
    rows = table[ids.clamp(0, table.shape[0] - 1).long()]            # (B, L, D)
    w = torch.where(ids >= 0, weights, 0.0)
    return torch.einsum("bl,bld->bd", w.float(), rows.float()).to(table.dtype)
