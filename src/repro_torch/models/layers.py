"""Transformer building blocks, the attention part of the JAX package's
``models/layers.py``: RMSNorm, RoPE, GQA attention (training / prefill)
with an optional sliding window.

Parameters are plain dicts of tensors, as in the reference;
``params_from_numpy`` carries a JAX parameter dict (as numpy arrays)
across.  ``attention(use_pallas=True)`` runs the flash-attention kernel
(``kernels/flash_attention``); otherwise the plain or the lean softmax.
A plain matrix product (the projections, the plain branches' einsums)
goes to ``torch.matmul``, as the reference leaves it to XLA.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..core.graph import _device
from ..kernels.flash_attention.ops import flash_attention

# ---------------------------------------------------------------------------
# initialisers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype, scale: Optional[float] = None,
               device=None):
    """N(0, 1) * scale (default 1/sqrt(fan_in)) drawn in f32 from ``gen``,
    then cast to ``dtype``, on ``device`` (the card by default; ``gen`` must
    live there too)."""
    device = _device(device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32, device=device)
    return (x * s).to(dtype)


def params_from_numpy(params: dict, device=None) -> dict:
    """A parameter dict of numpy arrays (e.g. ``jax.device_get`` of the
    reference's) as tensors on ``device`` (the card by default); bfloat16
    arrays keep their bits."""
    device = _device(device)
    out = {}
    for name, a in params.items():
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        out[name] = t.to(device)
    return out


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------


def rmsnorm(x, w, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def rope_tables(positions, d_head: int, theta: float = 1e4):
    """positions: (..., S) int → cos/sin (..., S, d_head/2)."""
    half = d_head // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, dh); cos/sin: (B, S, hh) or (S, hh)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    xf1, xf2 = x1.float(), x2.float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None
    qk_norm: bool = False
    lean_softmax: bool = False


def attn_init(gen: torch.Generator, cfg: AttnConfig, dtype, device=None):
    """Random projections from ``gen`` (and unit q/k norms under qk_norm) on
    ``device`` (the card by default)."""
    device = _device(device)
    hd, kvd = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    p = {name: dense_init(gen, shape, dtype, device=device) for name, shape in (
        ("wq", (cfg.d_model, hd)), ("wk", (cfg.d_model, kvd)),
        ("wv", (cfg.d_model, kvd)), ("wo", (hd, cfg.d_model)))}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((cfg.d_head,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((cfg.d_head,), dtype=dtype, device=device)
    return p


def _expand_kv(k, n_heads: int):
    """(B, S, KV, dh) → (B, S, H, dh) by repeating each kv head H/KV times."""
    return torch.repeat_interleave(k, n_heads // k.shape[2], dim=2)


def _causal_mask(sq: int, sk: int, window: Optional[int], q_offset=0, device=None):
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    ki = torch.arange(sk, device=device)[None, :]
    mask = ki <= qi
    if window is not None:
        mask &= ki > qi - window
    return mask  # (sq, sk)


def attention(p, cfg: AttnConfig, x, positions, *, use_pallas: bool = False):
    """Full (training / prefill) attention. x: (B, S, D) → (B, S, D).
    ``use_pallas`` (the reference's name) runs the flash-attention kernel."""
    B, S, D = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.d_head)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    cos, sin = rope_tables(positions, cfg.d_head, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    k = _expand_kv(k, cfg.n_heads)
    v = _expand_kv(v, cfg.n_heads)
    if use_pallas:
        out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    elif cfg.lean_softmax:
        # every (S, S)-sized tensor stays in the model dtype: additive mask,
        # max-sub-exp, an f32 row sum, unnormalised AV then divide on (S, dh)
        scale = torch.tensor(1.0 / math.sqrt(cfg.d_head), dtype=x.dtype)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale.to(x.device)
        mask = _causal_mask(S, S, cfg.sliding_window, device=x.device)
        addmask = torch.where(mask, 0.0, -1e30).to(x.dtype)
        logits = logits + addmask[None, None]
        m = logits.amax(-1, keepdim=True)
        probs = torch.exp(logits - m)
        denom = probs.sum(-1, dtype=torch.float32)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        inv = (1.0 / denom.clamp_min(1e-30)).to(x.dtype)
        out = out * inv.transpose(1, 2)[..., None]
    else:
        scale = float(np.float32(1.0) / np.sqrt(np.float32(cfg.d_head)))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
        mask = _causal_mask(S, S, cfg.sliding_window, device=x.device)
        logits = torch.where(mask[None, None], logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    out = out.reshape(B, S, cfg.n_heads * cfg.d_head)
    return out @ p["wo"]
