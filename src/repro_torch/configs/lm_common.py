"""Cell builders shared by the five LM architectures, as
``repro.configs.lm_common``.

Shapes (the reference's table):
  train_4k    — seq 4,096 × global_batch 256   → train_step
  prefill_32k — seq 32,768 × global_batch 32   → serve prefill
  decode_32k  — KV len 32,768 × global_batch 128 → serve decode (1 token)
  long_500k   — KV len 524,288 × global_batch 1  → serve decode, KV cache
                sharded along *sequence* (split-KV / flash-decoding layout,
                since batch=1 cannot shard).

A cell's arguments are meta tensors (never allocated) and its specs the
reference's, with the reference's per-kind config replacements.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.graph import _device
from ..data.pipeline import prng_key, randint
from ..distributed.mesh_utils import P
from ..models import transformer as T
from ..optim import AdamWState, adamw_init
from .registry import DryrunCell

BATCH_AXES = ("pod", "data")

SHAPE_TABLE = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode_longctx"),
}


def _meta(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def param_abstract(cfg: T.LMConfig):
    """``init``'s tree as meta tensors (shapes and dtypes only)."""
    return T.init(torch.Generator().manual_seed(0), cfg, device="meta")


def build_lm_cell(cfg: T.LMConfig, shape: str, unroll: bool = True,
                  n_layers_override: int = None) -> DryrunCell:
    info = SHAPE_TABLE[shape]
    S, B = info["seq"], info["batch"]
    kind = info["kind"]
    # the reference's lowering knobs, kept field for field (the port runs
    # its layers in a Python loop either way)
    if unroll:
        cfg = dataclasses.replace(cfg, scan_layers=False)
    if n_layers_override is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers_override)

    params = param_abstract(cfg)
    pspecs = T.param_specs(cfg, fsdp=True)

    if kind == "train":
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, zero3_gather=False)
        # optimizer moments shard exactly like their parameters (ZeRO)
        opt_specs = AdamWState(step=P(), mu=pspecs, nu=pspecs)
        batch = {"tokens": _meta((B, S)), "labels": _meta((B, S))}
        batch_specs = {"tokens": P(BATCH_AXES, None), "labels": P(BATCH_AXES, None)}
        metric_specs = {"nll": P(), "aux": P(), "loss": P(), "lr": P()}
        return DryrunCell(
            arch=cfg.name, shape=shape, kind="train",
            fn=T.make_train_step(cfg),
            arg_specs=(params, adamw_init(params), batch),
            in_specs=(pspecs, opt_specs, batch_specs),
            out_specs=(pspecs, opt_specs, metric_specs),
            donate=(0, 1),
        )

    if kind == "prefill":
        cfg = dataclasses.replace(cfg, gather_experts=True)
        return DryrunCell(
            arch=cfg.name, shape=shape, kind="serve",
            fn=T.make_prefill(cfg),
            arg_specs=(params, _meta((B, S))),
            in_specs=(pspecs, P(BATCH_AXES, None)),
            out_specs=P(BATCH_AXES, None, "model"),
            donate=(),
        )

    # decode kinds — serve layout: TP + 2D-sharded experts, no FSDP;
    # split-KV attention keeps the cache sequence-sharded
    cfg = dataclasses.replace(
        cfg,
        decode_seq_axes=("data", "model") if kind == "decode_longctx" else ("model",),
    )
    pspecs = T.param_specs_serve(cfg)
    if kind == "decode_longctx":
        # batch=1: shard the KV sequence dim over the whole mesh
        cache_specs = T.cache_pspec(None, ("data", "model"))
        tok_spec = P(None, None)
        logit_spec = P(None, None, "model")
    else:
        # batch over the data axes and sequence over 'model'
        cache_specs = T.cache_pspec(BATCH_AXES, "model")
        tok_spec = P(BATCH_AXES, None)
        logit_spec = P(BATCH_AXES, None, "model")
    note = ""
    if kind == "decode_longctx":
        note = ("decode is O(seq); 500k prefill would need sub-quadratic "
                "attention (only danube3 SWA qualifies) — see DESIGN.md")
    return DryrunCell(
        arch=cfg.name, shape=shape, kind="serve",
        fn=T.make_decode(cfg),
        arg_specs=(params, T.cache_specs(cfg, B, S), _meta((B, 1)), _meta(())),
        in_specs=(pspecs, cache_specs, tok_spec, P()),
        out_specs=(logit_spec, cache_specs),
        donate=(1,),
        note=note,
    )


# ---------------------------------------------------------------------------
# smoke helper: reduced config, one train step + one decode step
# ---------------------------------------------------------------------------

def smoke_tokens(cfg: T.LMConfig) -> np.ndarray:
    """``lm_smoke``'s (2, 16) int32 tokens, the reference's
    ``jax.random.randint(PRNGKey(0), (2, 16), 0, vocab)`` bitwise (its
    labels are the same draw)."""
    return randint(prng_key(0), (2, 16), 0, cfg.vocab_size)


def lm_smoke(cfg: T.LMConfig, device=None) -> dict:
    """One train step and one decode step of a reduced config on
    ``device`` (the card by default)."""
    device = _device(device)
    params = T.init(torch.Generator(device=device).manual_seed(0), cfg, device=device)
    opt = adamw_init(params)
    toks = torch.from_numpy(smoke_tokens(cfg)).to(device)
    batch = {"tokens": toks, "labels": toks.clone()}
    params, opt, metrics = T.make_train_step(cfg)(params, opt, batch)
    cache = T.init_cache(cfg, toks.shape[0], 8, device=device)
    logits, cache = T.make_decode(cfg)(params, cache, toks[:, :1], 0)
    loss = float(metrics["loss"])
    return {
        "loss": loss,
        "logits_shape": tuple(logits.shape),
        "finite": bool(np.isfinite(loss)) and bool(torch.isfinite(logits).all()),
    }
