"""Transformer building blocks, as the JAX package's ``models/layers.py``:
RMSNorm, RoPE, GQA attention (training / prefill, and one-token decode
against a KV cache) with an optional sliding window, SwiGLU, and the
sort-based MoE block.

Parameters are plain dicts of tensors, as in the reference;
``params_from_numpy`` carries a JAX parameter dict (as numpy arrays)
across.  ``attention(use_pallas=True)`` runs the flash-attention kernel
(``kernels/flash_attention``); otherwise the plain or the lean softmax.
A plain matrix product (the projections, the plain branches' einsums, the
expert GEMMs) goes to ``torch.matmul``, as the reference leaves it to XLA.
"""

from __future__ import annotations

import dataclasses
import math
from collections import namedtuple
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
    reference's; nested dicts, such as a whole LM tree, recurse) as tensors
    on ``device`` (the card by default); bfloat16 arrays keep their bits."""
    device = _device(device)
    out = {}
    for name, a in params.items():
        if isinstance(a, dict):
            out[name] = params_from_numpy(a, device)
            continue
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
    # the reference's sharding pin of the decode cache's sequence dim; on
    # one device it places nothing and changes no value
    decode_seq_axes: Optional[tuple] = None


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


DecodeStep = namedtuple("DecodeStep", "cos sin at write rows valid")


def decode_step(cfg: AttnConfig, pos, batch: int, s_max: int, slot_mask=None,
                device=None) -> DecodeStep:
    """What one decode step's attention takes from its positions, the same
    in every layer (``transformer.make_decode`` builds it once a step):
    the RoPE tables, the write index clamped to [0, s_max - 1], the
    per-slot write mask (None for a shared position), the slot rows, and
    the attention mask (B, 1, 1, 1, s_max) of the unclamped positions."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    per_slot = pos.dim() == 1
    posv = pos[:, None] if per_slot else pos.expand(batch, 1)
    cos, sin = rope_tables(posv, cfg.d_head, cfg.rope_theta)
    write = None
    if per_slot:
        write = (pos >= 0) & (pos < s_max)
        if slot_mask is not None:
            write &= slot_mask.to(torch.bool)
        write = write[:, None, None]
    ki = torch.arange(s_max, device=pos.device)
    pb = posv.reshape(batch, 1, 1, 1, 1)
    valid = ki <= pb
    if cfg.sliding_window is not None:
        valid &= ki > pb - cfg.sliding_window
    return DecodeStep(cos, sin, pos.clamp(0, s_max - 1).long(), write,
                      torch.arange(batch, device=pos.device), valid)


def attention_decode(p, cfg: AttnConfig, x, cache_k, cache_v, pos, slot_mask=None,
                     step: Optional[DecodeStep] = None):
    """One-token decode. x: (B, 1, D); cache_[kv]: (B, S_max, KV, dh).

    ``pos``: () int — one shared write position, or (B,) int — per-slot
    positions (continuous batching with ragged sequences); ``slot_mask``
    (B,) optionally disables cache writes for parked slots.  The caches
    are written in place, at (slot, pos) only: a parked slot or a per-slot
    position outside [0, S_max) writes nothing, and a shared position is
    clamped to [0, S_max - 1] as the reference's ``dynamic_update_slice``
    clamps it (the mask still reads the unclamped position).  ``step``:
    ``decode_step`` of these positions, when the caller has it.
    Returns (out (B, 1, D), cache_k, cache_v)."""
    B, _, D = x.shape
    S_max = cache_k.shape[1]
    if step is None:
        step = decode_step(cfg, pos, B, S_max, slot_mask, x.device)
    q = (x @ p["wq"]).reshape(B, 1, cfg.n_heads, cfg.d_head)
    k = (x @ p["wk"]).reshape(B, 1, cfg.n_kv_heads, cfg.d_head)
    v = (x @ p["wv"]).reshape(B, 1, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = apply_rope(q, step.cos, step.sin)
    k = apply_rope(k, step.cos, step.sin)
    k_new, v_new = k[:, 0].to(cache_k.dtype), v[:, 0].to(cache_v.dtype)
    if step.write is not None:
        rows, at = step.rows, step.at
        cache_k[rows, at] = torch.where(step.write, k_new, cache_k[rows, at])
        cache_v[rows, at] = torch.where(step.write, v_new, cache_v[rows, at])
    else:
        cache_k.index_copy_(1, step.at.reshape(1), k_new[:, None])
        cache_v.index_copy_(1, step.at.reshape(1), v_new[:, None])
    scale = float(np.float32(1.0) / np.sqrt(np.float32(cfg.d_head)))
    G = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(B, 1, cfg.n_kv_heads, G, cfg.d_head)
    kt = torch.promote_types(qg.dtype, cache_k.dtype)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.to(kt), cache_k.to(kt))
    logits = logits.float() * scale                       # (B, KV, G, 1, S)
    logits = torch.where(step.valid, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    vt = torch.promote_types(probs.dtype, cache_v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(vt), cache_v.to(vt))
    out = out.reshape(B, 1, cfg.n_heads * cfg.d_head)
    return out @ p["wo"], cache_k, cache_v


# ---------------------------------------------------------------------------
# feed-forward: dense SwiGLU and sort-based MoE
# ---------------------------------------------------------------------------


def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int, dtype, device=None):
    device = _device(device)
    return {name: dense_init(gen, shape, dtype, device=device) for name, shape in (
        ("wi_gate", (d_model, d_ff)), ("wi_up", (d_model, d_ff)), ("wo", (d_ff, d_model)))}


def _silu(x):
    return x * torch.sigmoid(x)      # jax.nn.silu's two roundings in bf16


def swiglu(p, x):
    return (_silu(x @ p["wi_gate"]) * (x @ p["wi_up"])) @ p["wo"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    d_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


def moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig, dtype, device=None):
    """The router (f32), the stacked expert weights and, with shared
    experts, one SwiGLU of width ``d_shared * n_shared``."""
    device = _device(device)
    E, F = cfg.n_experts, cfg.d_expert
    p = {"router": dense_init(gen, (d_model, E), torch.float32, device=device)}
    for name, shape in (("we_gate", (E, d_model, F)), ("we_up", (E, d_model, F)),
                        ("we_down", (E, F, d_model))):
        p[name] = dense_init(gen, shape, dtype, device=device)
    if cfg.n_shared:
        p["shared"] = swiglu_init(gen, d_model, cfg.d_shared * cfg.n_shared, dtype,
                                  device=device)
    return p


def moe_route(p, cfg: MoEConfig, xt):
    """The router on tokens xt (T, D): (probs (T, E) f32, renormalised
    top-k weights (T, K), experts (T, K)).  The top k come from a stable
    descending sort, so ties go to the lower expert, as ``jax.lax.top_k``
    orders them (``torch.topk`` promises no order on ties)."""
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    topw, tope = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, tope = topw[:, :cfg.top_k], tope[:, :cfg.top_k]
    return probs, topw / topw.sum(-1, keepdim=True), tope


def moe_block(p, cfg: MoEConfig, x):
    """Sort-based top-k MoE. x: (B, S, D) → (B, S, D), plus aux loss.

    Dispatch as the reference: flatten (token, k) assignments, stable-sort
    them by expert, keep the first ``capacity`` of each expert (overflow
    goes to a trash row and is dropped), batched expert GEMMs, gather back
    with the router weights.  The combine adds each token's k outputs in
    ``x.dtype`` in the order of their experts, as the reference's
    sequential ``.at[st].add`` meets them; as a fixed sum it is the same
    on every device and every run (no atomics)."""
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    xt = x.reshape(T, D)
    probs, topw, tope = moe_route(p, cfg, xt)

    # load-balancing auxiliary loss (Switch-style)
    me = torch.nn.functional.one_hot(tope[:, 0], E).float().mean(0)
    ce = probs.mean(0)
    aux = cfg.router_aux_weight * E * torch.sum(me * ce)

    # sort-based dispatch; the capacity in the reference's float arithmetic
    cap = int(cfg.capacity_factor * T * K / E) + 1
    flat_e = tope.reshape(T * K)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(K)
    flat_w = topw.reshape(T * K)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    start = torch.searchsorted(se, torch.arange(E, device=x.device), side="left")
    pos_in_e = torch.arange(T * K, device=x.device) - start[se]
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e, E * cap)     # overflow → trash row

    buf = torch.zeros((E * cap + 1, D), dtype=x.dtype, device=x.device)
    buf[slot] = xt[st]
    buf = buf[: E * cap].reshape(E, cap, D)
    h = _silu(torch.einsum("ecd,edf->ecf", buf, p["we_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["we_up"])
    out_e = torch.einsum("ecf,efd->ecd", h, p["we_down"])      # (E, cap, D)
    out_flat = out_e.reshape(E * cap, D)

    gathered = out_flat[torch.clamp(slot, max=E * cap - 1)]
    gathered = torch.where(keep[:, None], gathered, 0.0)
    contrib = gathered * sw[:, None].to(x.dtype)               # sorted order
    # each token's k entries in sorted order, i.e. by ascending expert
    rank = torch.empty_like(order)
    rank[order] = torch.arange(T * K, device=x.device)
    per_token = contrib[rank.reshape(T, K).sort(dim=1).values]  # (T, K, D)
    out = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    for j in range(K):
        out = out + per_token[:, j]

    if "shared" in p:
        out = out + swiglu(p["shared"], xt)
    return out.reshape(B, S, D), aux
