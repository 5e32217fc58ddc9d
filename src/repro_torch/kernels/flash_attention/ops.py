"""Public wrapper on the (B, S, H, d) layout the transformer uses, the
counterpart of ``src/repro/kernels/flash_attention/ops.py``."""

from __future__ import annotations

from typing import Optional

from .flash_attention import flash_attention_bhsd


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    block_q: int = 128, block_k: int = 128):
    """q/k/v: (B, S, H, d) with H already expanded (the caller repeats the
    GQA heads).  Returns (B, S, H, d)."""
    B, S, H, d = q.shape

    def fold(x):   # contiguous: at B = 1 the reshape alone is a strided view
        return x.permute(0, 2, 1, 3).reshape(B * H, S, d).contiguous()

    out = flash_attention_bhsd(fold(q), fold(k), fold(v), causal=causal,
                               window=window, block_q=block_q, block_k=block_k)
    return out.reshape(B, H, S, d).permute(0, 2, 1, 3)
