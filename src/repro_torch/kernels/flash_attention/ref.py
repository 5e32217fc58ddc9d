"""Plain torch versions of the flash-attention forward.

* ``flash_attention_plain`` — the JAX kernel's algorithm
  (``src/repro/kernels/flash_attention/flash_attention.py:_fwd_kernel``):
  S padded to ``block_q``, key tiles of ``block_k`` in order, online softmax
  with f32 running max, denominator and accumulator, ``NEG_INF = -1e30``,
  ``p`` zeroed by the mask after the exp, ``out = acc / max(l, 1e-30)``
  rounded to the input dtype once.  All query tiles go through each key
  tile at once; the JAX kernel skips key tiles that the mask hides
  entirely, whose update changes nothing, so the order of operations per
  query row is the kernel's.  The kernel wrapper takes it for CPU tensors.
* ``attention_ref`` — the JAX package's oracle: the whole score matrix,
  one softmax.  ``rows=`` computes only the given query positions, for
  sequences whose (S, S) scores do not fit.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def check_blocks(s: int, window: Optional[int], block_q: int, block_k: int) -> None:
    """Reject what the reference would get wrong without saying so: a key
    block that does not divide S padded to ``block_q`` (its last keys would
    be dropped) and a window below 1 (it would hide every key)."""
    if block_q < 1 or block_k < 1 or (-(-s // block_q) * block_q) % block_k:
        raise ValueError(f"block_k={block_k} must divide S={s} padded to "
                         f"block_q={block_q}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or at least 1, not {window}")


def _mask(qpos, kpos, s: int, causal: bool, window: Optional[int]):
    mask = kpos < s
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          block_q: int = 128, block_k: int = 128):
    """q/k/v: (BH, S, d) → (BH, S, d) in q's dtype."""
    bh, s, d = q.shape
    check_blocks(s, window, block_q, block_k)
    scale = 1.0 / math.sqrt(d)
    s_pad = -(-s // block_q) * block_q
    pad = (0, 0, 0, s_pad - s)
    qf, kf, vf = (F.pad(t.float(), pad) for t in (q, k, v))
    dev = q.device
    qpos = torch.arange(s_pad, device=dev)[:, None]
    m = torch.full((bh, s_pad, 1), NEG_INF, device=dev)
    l = torch.zeros((bh, s_pad, 1), device=dev)
    acc = torch.zeros((bh, s_pad, d), device=dev)
    for k0 in range(0, s_pad, block_k):
        kb, vb = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        mask = _mask(qpos, torch.arange(k0, k0 + block_k, device=dev)[None, :],
                     s, causal, window)
        sc = torch.where(mask, torch.matmul(qf, kb.transpose(1, 2)) * scale, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.where(mask, torch.exp(sc - m_new), 0.0)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(-1, keepdim=True)
        acc = corr * acc + torch.matmul(p, vb)
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)[:, :s]


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None, rows=None):
    """q/k/v: (BH, S, d) → (BH, S, d); with ``rows`` (a 1-d index tensor of
    query positions) → (BH, len(rows), d), those rows only."""
    bh, s, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qpos = torch.arange(s, device=q.device) if rows is None else rows.to(q.device)
    if rows is not None:
        q = q[:, qpos]
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    mask = _mask(qpos[:, None], torch.arange(s, device=q.device)[None, :], s,
                 causal, window)
    logits = torch.where(mask[None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkd->bqd", probs, v.float()).to(q.dtype)
