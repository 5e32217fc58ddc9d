"""MIND — Multi-Interest Network with Dynamic (B2I capsule) routing
[arXiv:1904.08030], as ``repro.models.recsys.mind``.

Hot path: the item-embedding gather over a 10⁶–10⁹-row table, a plain
row gather (``embed[ids]``) as in the reference, whose code runs no
Pallas kernel either.  Every product is ``torch.matmul``/``einsum``,
where the reference leaves it to XLA.

* Training: label-aware attention over interests + in-batch sampled softmax.
* Serving:  interests (B, K, d) then max-over-interest dot scoring.
* Retrieval: one user vs 10⁶ candidates — a single (K, d) × (d, C) matmul,
  never a loop; the top k by a stable descending sort, so ties go to the
  lower candidate index as ``jax.lax.top_k`` orders them (``torch.topk``
  promises no order on ties).

Parameters are a dict of tensors in the reference's names and shapes;
``params_from_numpy`` carries a JAX parameter dict across.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ...core.graph import _device
from ..layers import params_from_numpy  # noqa: F401  (a flat dict of numpy arrays)


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    n_items: int = 1 << 23
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    hist_len: int = 50
    pow_p: float = 2.0          # label-aware attention sharpness
    temperature: float = 0.05   # in-batch softmax temperature
    pad_id: int = 0


def init(gen: torch.Generator, cfg: MINDConfig, device=None):
    """Random parameters from ``gen`` on ``device`` (the card by default;
    ``gen`` must live there too, or the device is ``meta``), in the
    reference's names and shapes: N(0, 1) f32 draws, the table times
    0.02, the two projections over sqrt(d)."""
    device = _device(device)
    d = cfg.embed_dim

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)

    return {
        "embed": normal((cfg.n_items, d)).mul_(0.02),
        "bilinear": normal((d, d)).div_(math.sqrt(d)),
        # fixed (non-trained in-iteration) routing-logit init projection
        "route_init": normal((d, cfg.n_interests)).div_(math.sqrt(d)),
    }


def _squash(z, axis=-1):
    n2 = torch.sum(torch.square(z), dim=axis, keepdim=True)
    return z * (n2 / (1.0 + n2)) / torch.sqrt(torch.clamp(n2, min=1e-12))


def lookup(params, ids):
    """Embedding gather (the EmbeddingBag primitive: take + optional reduce)."""
    return params["embed"][ids]


def interests(params, cfg: MINDConfig, hist):
    """hist (B, L) int → interest capsules (B, K, d)."""
    e = lookup(params, hist)                              # (B, L, d)
    mask = (hist != cfg.pad_id).to(torch.float32)         # (B, L)
    eh = e @ params["bilinear"]                           # (B, L, d)
    # routing logits: a fixed projection of the behaviours, not trained
    # through the iterations (the reference's stop_gradient of eh, here
    # and in the update)
    b = eh.detach() @ params["route_init"]                # (B, L, K)
    u = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(b, dim=-1) * mask[:, :, None]
        z = torch.einsum("blk,bld->bkd", w, eh)
        u = _squash(z)
        b = b + torch.einsum("bkd,bld->blk", u, eh.detach())
    return u                                              # (B, K, d)


def label_aware_user(params, cfg: MINDConfig, u, target_emb):
    """Label-aware attention: pick interests relevant to the target item."""
    att = torch.einsum("bkd,bd->bk", u, target_emb)
    att = torch.softmax(att * cfg.pow_p, dim=-1)
    return torch.einsum("bk,bkd->bd", att, u)


def loss_fn(params, cfg: MINDConfig, batch):
    """batch: hist (B, L), target (B,). In-batch sampled softmax:
    (loss, {"loss": loss})."""
    hist, target = batch["hist"], batch["target"]
    u = interests(params, cfg, hist)
    t_emb = lookup(params, target)                        # (B, d)
    v = label_aware_user(params, cfg, u, t_emb)           # (B, d)
    logits = (v @ t_emb.T) / cfg.temperature              # (B, B) in-batch
    labels = torch.arange(hist.shape[0], device=hist.device)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    loss = torch.mean(logz - gold)
    return loss, {"loss": loss}


def serve_scores(params, cfg: MINDConfig, hist, cand_ids):
    """hist (B, L); cand_ids (C,) shared slate → scores (B, C):
    max over interests of interest·candidate (MIND serving rule)."""
    u = interests(params, cfg, hist)                      # (B, K, d)
    c = lookup(params, cand_ids)                          # (C, d)
    s = torch.einsum("bkd,cd->bkc", u, c)
    return torch.amax(s, dim=1)


def top_k_stable(scores, k: int):
    """(values, indices) of the ``k`` largest scores of each row, ties to
    the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def retrieval(params, cfg: MINDConfig, hist, cand_ids, top_k: int = 100):
    """One (or few) users against a large candidate corpus; returns
    (top-k scores (B, k), their candidate ids)."""
    scores = serve_scores(params, cfg, hist, cand_ids)
    vals, idx = top_k_stable(scores, top_k)
    return vals, cand_ids[idx]
