"""Decoder-only transformer LM (dense and MoE) with KV-cache serving, as the
JAX package's ``models/transformer.py``.

One implementation covers the five LM architectures of ``configs/``
(qwen3-moe, deepseek-moe, h2o-danube3 with its sliding window, stablelm,
glm4); the differences are config.  The parameter tree is the
reference's: layers stacked along a leading ``n_layers`` dim, run here by
a Python loop over that dim (the reference's ``lax.scan``).  The
reference's sharding and compile knobs (``scan_layers``, ``zero3_gather``,
``gather_experts``, ``seq_parallel``, ``decode_seq_axes``) are kept as
fields so a JAX config converts field for field; on one device they
change no value.

Training: ``loss_fn`` (next-token cross-entropy plus the MoE aux loss),
``value_and_grad`` (autograd in place of ``jax.value_and_grad``) and
``make_train_step`` (a gradient and an AdamW step on the reference's
cosine schedule).  ``remat`` checkpoints each layer when gradients are
being recorded (``torch.utils.checkpoint``, non-reentrant) with a
selective policy that keeps the weight GEMMs' outputs (``aten.mm``, the
matrix products with no batch dims) and recomputes the rest in the
backward pass: the twin of the reference's
``dots_with_no_batch_dims_saveable``.  It changes no value: the
recomputed ops run again on the same inputs.  Every op on the path has a
backward, the MoE dispatch's write into its trash row, the router's
stable sort and the masked softmax included.

Sharding rules (``param_specs``, ``param_specs_serve``, ``cache_pspec``)
are the reference's ``PartitionSpec`` trees as ``distributed.mesh_utils.
P``: data axes ('pod', 'data') carry the batch and the FSDP parameter
shards, the 'model' axis TP (heads, d_ff, vocab) and EP (experts).  On
one device they place nothing; ``launch/dryrun.py`` accounts shards and
traffic by them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from . import layers as L
from .layers import params_from_numpy  # noqa: F401  (a whole tree: nested dicts recurse)
from ..core.graph import _device
from ..distributed.mesh_utils import P
from ..optim import adamw_update, cosine_schedule


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None
    moe: Optional[L.MoEConfig] = None
    sliding_window: Optional[int] = None
    rope_theta: float = 1e6
    dtype: str = "bfloat16"
    remat: bool = True
    tie_embeddings: bool = False
    qk_norm: bool = False
    scan_layers: bool = True
    lean_softmax: bool = False
    zero3_gather: bool = True
    gather_experts: bool = False
    seq_parallel: bool = False
    decode_seq_axes: Optional[tuple] = None

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def attn(self) -> L.AttnConfig:
        return L.AttnConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            d_head=self.head_dim,
            rope_theta=self.rope_theta,
            sliding_window=self.sliding_window,
            qk_norm=self.qk_norm,
            lean_softmax=self.lean_softmax,
            decode_seq_axes=self.decode_seq_axes,
        )

    @property
    def param_count(self) -> int:
        """Total parameters (for 6·N·D roofline accounting)."""
        D, H = self.d_model, self.head_dim
        attn = D * (self.n_heads * H) + 2 * D * (self.n_kv_heads * H) \
            + (self.n_heads * H) * D
        if self.moe:
            ff = self.moe.n_experts * 3 * D * self.moe.d_expert \
                + D * self.moe.n_experts \
                + (3 * D * self.moe.d_shared * self.moe.n_shared if self.moe.n_shared else 0)
        else:
            ff = 3 * D * self.d_ff
        norms = 2 * D
        emb = self.vocab_size * D * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ff + norms) + emb + D

    @property
    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared experts only)."""
        if not self.moe:
            return self.param_count
        D = self.d_model
        full_ff = self.moe.n_experts * 3 * D * self.moe.d_expert
        act_ff = self.moe.top_k * 3 * D * self.moe.d_expert
        return self.param_count - self.n_layers * (full_ff - act_ff)


def _dt(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (and the same leaves of ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def layer(params_layers, i: int):
    """Layer ``i``'s parameters: views into the stacked tree, or the
    ``i``-th of a list of per-layer trees (``value_and_grad``'s)."""
    if isinstance(params_layers, list):
        return params_layers[i]
    return tree_map(lambda t: t[i], params_layers)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init(gen: torch.Generator, cfg: LMConfig, device=None):
    """Random parameters from ``gen`` on ``device`` (the card by default;
    ``gen`` must live there too), in the reference's tree and shapes."""
    device = _device(device)
    dt = _dt(cfg.dtype)

    def layer_init():
        p = {
            "attn_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
            "attn": L.attn_init(gen, cfg.attn, dt, device=device),
            "mlp_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
        }
        if cfg.moe:
            p["moe"] = L.moe_init(gen, cfg.d_model, cfg.moe, dt, device=device)
        else:
            p["mlp"] = L.swiglu_init(gen, cfg.d_model, cfg.d_ff, dt, device=device)
        return p

    # drawn a layer at a time into the stacked tensors (one layer's copy
    # at a time beside them, not a second stack)
    layers = None
    for i in range(cfg.n_layers):
        lp = layer_init()
        if layers is None:
            layers = tree_map(lambda t: t.new_empty((cfg.n_layers,) + tuple(t.shape)), lp)
        tree_map(lambda dst, src: dst[i].copy_(src), layers, lp)
        del lp

    params = {
        "embed": L.dense_init(gen, (cfg.vocab_size, cfg.d_model), dt, scale=1.0,
                              device=device),
        "layers": layers,
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, (cfg.d_model, cfg.vocab_size), dt,
                                         device=device)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer_fwd(cfg: LMConfig, lp, x, positions):
    hn = L.rmsnorm(x, lp["attn_norm"])
    h = x + L.attention(lp["attn"], cfg.attn, hn, positions)
    hin = L.rmsnorm(h, lp["mlp_norm"])
    if cfg.moe:
        ff, aux = L.moe_block(lp["moe"], cfg.moe, hin)
    else:
        ff = L.swiglu(lp["mlp"], hin)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return h + ff, aux


def _unembed(params, cfg: LMConfig, x):
    x = L.rmsnorm(x, params["final_norm"])
    unemb = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return x @ unemb.to(x.dtype)


# the remat policy: save what aten.mm returns, recompute every other op
_SAVE_MM = functools.partial(create_selective_checkpoint_contexts, [torch.ops.aten.mm.default])


def _remat_layer_fwd(cfg: LMConfig, lp, x, positions):
    return checkpoint(_layer_fwd, cfg, lp, x, positions, use_reentrant=False,
                      context_fn=_SAVE_MM)


def forward(params, cfg: LMConfig, tokens):
    """tokens (B, S) → logits (B, S, V), aux loss."""
    x = params["embed"][tokens].to(_dt(cfg.dtype))
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    body = _remat_layer_fwd if cfg.remat and torch.is_grad_enabled() else _layer_fwd
    for i in range(cfg.n_layers):
        x, a = body(cfg, layer(params["layers"], i), x, positions)
        aux = aux + a
    return _unembed(params, cfg, x), aux


def loss_fn(params, cfg: LMConfig, batch):
    """(mean next-token cross-entropy + aux, {"nll", "aux"}) of ``batch``'s
    tokens against its labels, the logits in f32."""
    logits, aux = forward(params, cfg, batch["tokens"])
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["labels"][..., None].long())[..., 0]
    nll = torch.mean(logz - gold)
    return nll + aux, {"nll": nll, "aux": aux}


def value_and_grad(params, cfg: LMConfig, batch):
    """((loss, metrics), grads): ``loss_fn`` and its gradient with respect
    to every parameter, a tree like ``params`` in their dtypes (the
    reference's ``jax.value_and_grad(loss_fn, has_aux=True)``).

    Autograd runs on leaves that alias the parameters, one per layer for
    the stacked ones, each with its slice of the gradient tree preset as
    its ``.grad``: the backward pass adds each layer's gradient into its
    slice in place, where differentiating through ``t[i]`` would build a
    whole stacked-size gradient for every layer."""
    grads = tree_map(torch.zeros_like, params)

    def track(p, g):
        w = p.detach().requires_grad_()
        w.grad = g
        return w

    work = {k: tree_map(track, v, grads[k]) for k, v in params.items() if k != "layers"}
    work["layers"] = [tree_map(lambda p, g: track(p[i], g[i]), params["layers"],
                               grads["layers"]) for i in range(cfg.n_layers)]
    with torch.enable_grad():
        loss, metrics = loss_fn(work, cfg, batch)
        loss.backward()
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), grads


def make_train_step(cfg: LMConfig, lr_peak: float = 3e-4, total_steps: int = 10_000):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: one gradient and one AdamW update at the cosine schedule's
    rate (100 warm-up steps), the parameters and moments updated in place
    (the reference's donated buffers); metrics: nll, aux, loss, lr."""

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = value_and_grad(params, cfg, batch)
        lr = cosine_schedule(opt_state.step, 100, total_steps, lr_peak)
        params, opt_state = adamw_update(grads, opt_state, params, lr)
        return params, opt_state, dict(metrics, loss=loss, lr=lr)

    return train_step


def make_prefill(cfg: LMConfig):
    """Prefill: run the full sequence, return the logits."""

    def prefill(params, tokens):
        return forward(params, cfg, tokens)[0]

    return prefill


# ---------------------------------------------------------------------------
# serving: the KV cache and one-token decode
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_seq: int, dtype=None, device=None):
    """Zeroed caches (n_layers, batch, max_seq, n_kv_heads, head_dim) on
    ``device`` (the card by default)."""
    device = _device(device)
    dt = _dt(dtype or cfg.dtype)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def cache_specs(cfg: LMConfig, batch: int, max_seq: int):
    """``init_cache``'s shapes and dtypes as meta tensors."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {k: torch.empty(shape, dtype=_dt(cfg.dtype), device="meta") for k in ("k", "v")}


def decode_layers(params, cfg: LMConfig, cache, tokens, pos, slot_mask=None):
    """Every layer of one decode step, writing the cache in place; returns
    the residual stream (B, 1, D) before the final norm."""
    x = params["embed"][tokens].to(_dt(cfg.dtype))
    attn = cfg.attn
    step = L.decode_step(attn, pos, x.shape[0], cache["k"].shape[2], slot_mask, x.device)
    for i in range(cfg.n_layers):
        lp = layer(params["layers"], i)
        h = L.rmsnorm(x, lp["attn_norm"])
        a, _, _ = L.attention_decode(lp["attn"], attn, h, cache["k"][i], cache["v"][i],
                                     None, step=step)
        x = x + a
        hin = L.rmsnorm(x, lp["mlp_norm"])
        if cfg.moe:
            ff, _ = L.moe_block(lp["moe"], cfg.moe, hin)
        else:
            ff = L.swiglu(lp["mlp"], hin)
        x = x + ff
    return x


def make_decode(cfg: LMConfig):
    """One-token decode against a KV cache.  ``decode(params, cache, tokens
    (B, 1), pos () or (B,), slot_mask=None) -> (logits (B, 1, V), cache)``;
    the cache's tensors are written in place (the reference's donated
    buffers) and returned."""

    def decode(params, cache, tokens, pos, slot_mask=None):
        x = decode_layers(params, cfg, cache, tokens, pos, slot_mask)
        return _unembed(params, cfg, x), cache

    return decode


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

def param_specs(cfg: LMConfig, fsdp: bool = True):
    """P tree matching ``init``'s output.

    TP ('model'): attention heads, d_ff, experts, vocab.
    FSDP ('data'): the d_model dim of the big matrices (ZeRO-3 style).
    """
    dp = "data" if fsdp else None
    attn = {
        "wq": P(None, dp, "model"),
        "wk": P(None, dp, None),       # kv heads too few to split — replicate
        "wv": P(None, dp, None),
        "wo": P(None, "model", dp),
    }
    if cfg.qk_norm:
        attn["q_norm"] = P(None, None)
        attn["k_norm"] = P(None, None)
    layer = {
        "attn_norm": P(None, None),
        "attn": attn,
        "mlp_norm": P(None, None),
    }
    if cfg.moe:
        moe = {
            "router": P(None, dp, None),
            "we_gate": P(None, "model", dp, None),
            "we_up": P(None, "model", dp, None),
            "we_down": P(None, "model", None, dp),
        }
        if cfg.moe.n_shared:
            moe["shared"] = {
                "wi_gate": P(None, dp, "model"),
                "wi_up": P(None, dp, "model"),
                "wo": P(None, "model", dp),
            }
        layer["moe"] = moe
    else:
        layer["mlp"] = {
            "wi_gate": P(None, dp, "model"),
            "wi_up": P(None, dp, "model"),
            "wo": P(None, "model", dp),
        }
    specs = {
        "embed": P("model", dp),
        "layers": layer,
        "final_norm": P(None),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = P(dp, "model")
    return specs


def param_specs_serve(cfg: LMConfig):
    """Decode/serve sharding: TP over 'model', dense weights replicated
    over 'data', MoE experts 2D-sharded (E over 'data', FFN dim over
    'model').  No FSDP storage shards, so no per-step weight gathers."""
    attn = {
        "wq": P(None, None, "model"),
        "wk": P(None, None, None),
        "wv": P(None, None, None),
        "wo": P(None, "model", None),
    }
    if cfg.qk_norm:
        attn["q_norm"] = P(None, None)
        attn["k_norm"] = P(None, None)
    layer = {
        "attn_norm": P(None, None),
        "attn": attn,
        "mlp_norm": P(None, None),
    }
    if cfg.moe:
        moe = {
            "router": P(None, None, None),
            "we_gate": P(None, "data", None, "model"),
            "we_up": P(None, "data", None, "model"),
            "we_down": P(None, "data", "model", None),
        }
        if cfg.moe.n_shared:
            moe["shared"] = {
                "wi_gate": P(None, None, "model"),
                "wi_up": P(None, None, "model"),
                "wo": P(None, "model", None),
            }
        layer["moe"] = moe
    else:
        layer["mlp"] = {
            "wi_gate": P(None, None, "model"),
            "wi_up": P(None, None, "model"),
            "wo": P(None, "model", None),
        }
    specs = {
        "embed": P("model", None),
        "layers": layer,
        "final_norm": P(None),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = P(None, "model")
    return specs


def cache_pspec(batch_axes, seq_axis=None):
    """(L, B, S, KV, dh): batch over the data axes; long-context decode
    shards the sequence dim instead (flash-decoding split-KV style)."""
    return {
        "k": P(None, batch_axes, seq_axis, None, None),
        "v": P(None, batch_axes, seq_axis, None, None),
    }
