"""Plain torch versions of the block-ELL SpMM.

* ``spmm_bsr_plain`` — what the CUDA kernel computes, rounded where the JAX
  kernel (``src/repro/kernels/spmm_bsr/spmm_bsr.py``) rounds: each block's
  product in f32, rounded to x's dtype, added into the output row block in
  x's dtype, slots in order.  The kernel wrapper takes it for CPU tensors.
* ``spmm_ref`` — the JAX package's dense-per-block oracle: every block's
  product summed in f32, rounded once at the end.
* ``spmm_coo_ref`` — the edge-list oracle ``out[dst] += w * x[src]``.

A slot whose column-block index is negative (-1 is the padding) or not
below ``x.shape[0] // bk`` contributes nothing.
"""

from __future__ import annotations

import torch


def _slot_products(indices, blocks, x):
    """For each slot j: (valid (R,), blocks[:, j] @ X[indices[:, j]] in f32)."""
    R, K, bm, bk = blocks.shape
    xb = x.reshape(-1, bk, x.shape[1])
    c_blocks = xb.shape[0]
    for j in range(K):
        c = indices[:, j]
        valid = (c >= 0) & (c < c_blocks)
        gathered = xb[c.clamp(0, max(c_blocks - 1, 0)).long()].float()
        yield valid, torch.bmm(blocks[:, j].float(), gathered)


def spmm_bsr_plain(indices, blocks, x):
    """indices (R, K) int32; blocks (R, K, bm, bk); x (C*bk, F).  Returns
    (R*bm, F) in x's dtype, rounded once per block as the kernel rounds."""
    R, K, bm, bk = blocks.shape
    out = torch.zeros((R, bm, x.shape[1]), dtype=x.dtype, device=x.device)
    for valid, prod in _slot_products(indices, blocks, x):
        out = torch.where(valid[:, None, None], out + prod.to(x.dtype), out)
    return out.reshape(R * bm, x.shape[1])


def spmm_ref(indices, blocks, x):
    """Dense-per-block oracle: same block-ELL inputs as the kernel."""
    R, K, bm, bk = blocks.shape
    out = torch.zeros((R, bm, x.shape[1]), dtype=torch.float32, device=x.device)
    for valid, prod in _slot_products(indices, blocks, x):
        out += torch.where(valid[:, None, None], prod, 0.0)
    return out.reshape(R * bm, x.shape[1]).to(x.dtype)


def spmm_coo_ref(src, dst, w, n, x):
    """Edge-list oracle: out[dst] += w * x[src] over n rows."""
    msg = x[src] * w[:, None]
    return torch.zeros((n, x.shape[1]), dtype=msg.dtype, device=x.device).index_add_(
        0, dst, msg)
