"""mind [recsys] — embed_dim=64, n_interests=4, capsule_iters=3,
multi-interest dynamic routing.  [arXiv:1904.08030; unverified]

Shapes:
  train_batch    — batch 65,536 (in-batch sampled-softmax training)
  serve_p99      — batch 512 online inference (interests + slate scoring)
  serve_bulk     — batch 262,144 offline scoring
  retrieval_cand — batch 1 vs 1,000,000 candidates (single batched matmul)

The item-embedding table (2^23 rows × 64) is row-sharded over 'model'
in the reference's specs (``PARAM_SPECS``), which place nothing on one
device.
"""

from __future__ import annotations

import torch

from ..core.graph import _device
from ..data.pipeline import prng_key, randint
from ..distributed.mesh_utils import P
from ..models.recsys import mind as M
from ..optim import AdamWState, adamw_init, adamw_update
from . import gnn_common
from .registry import ArchSpec, DryrunCell, register, RECSYS_SHAPES

FULL = M.MINDConfig(name="mind", n_items=1 << 23, embed_dim=64, n_interests=4,
                    capsule_iters=3, hist_len=50)
SMOKE = M.MINDConfig(name="mind-smoke", n_items=512, embed_dim=16,
                     n_interests=4, capsule_iters=3, hist_len=8)

BATCH = ("pod", "data")
TABLE = P("model", None)          # row-sharded embedding table
CAND = ("data", "model")

PARAM_SPECS = {"embed": TABLE, "bilinear": P(), "route_init": P()}

SHAPES = {
    "train_batch": dict(batch=65_536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve", slate=8192),
    "serve_bulk": dict(batch=262_144, kind="serve", slate=8192),
    "retrieval_cand": dict(batch=1, kind="retrieval", n_cands=1_000_000),
}

RETRIEVAL_K = 100
SHARD_PAD = 512                   # the retrieval slate's padding multiple


def make_train_step(cfg: M.MINDConfig, lr: float = 1e-3):
    """step(params, opt, batch) → (params, opt, metrics): the loss's
    gradient, then AdamW (no weight decay) on the parameters and state in
    place."""
    def step(params, opt, batch):
        (_, metrics), grads = gnn_common.value_and_grad(M.loss_fn, params, cfg, batch)
        params, opt = adamw_update(grads, opt, params, lr, weight_decay=0.0)
        return params, opt, metrics

    return step


def retrieval_fn(cfg: M.MINDConfig, n_cands: int):
    """The retrieval cell's step: scores over a slate padded past
    ``n_cands`` (the padding's scores masked to -inf, so the top k are
    the unpadded corpus's), then the top ``RETRIEVAL_K`` and their ids."""
    def fn(params, hist, cand_ids):
        scores = M.serve_scores(params, cfg, hist, cand_ids)
        valid = torch.arange(cand_ids.shape[0], device=scores.device) < n_cands
        scores = torch.where(valid[None, :], scores, float("-inf"))
        vals, idx = M.top_k_stable(scores, RETRIEVAL_K)
        return vals, cand_ids[idx]

    return fn


def _meta(shape):
    return torch.empty(shape, dtype=torch.int32, device="meta")


def build_cell(shape: str, **opts) -> DryrunCell:
    cfg = FULL
    info = SHAPES[shape]
    B = info["batch"]
    params = M.init(torch.Generator().manual_seed(0), cfg, device="meta")

    if info["kind"] == "train":
        opt_specs = AdamWState(step=P(), mu=PARAM_SPECS, nu=PARAM_SPECS)
        batch = {"hist": _meta((B, cfg.hist_len)), "target": _meta((B,))}
        batch_specs = {"hist": P(BATCH, None), "target": P(BATCH)}
        return DryrunCell(
            arch="mind", shape=shape, kind="train",
            fn=make_train_step(cfg),
            arg_specs=(params, adamw_init(params), batch),
            in_specs=(PARAM_SPECS, opt_specs, batch_specs),
            out_specs=(PARAM_SPECS, opt_specs, {"loss": P()}),
            donate=(0, 1),
        )

    if info["kind"] == "serve":
        def fn(params, hist, cand_ids):
            return M.serve_scores(params, cfg, hist, cand_ids)

        return DryrunCell(
            arch="mind", shape=shape, kind="serve",
            fn=fn,
            arg_specs=(params, _meta((B, cfg.hist_len)), _meta((info["slate"],))),
            in_specs=(PARAM_SPECS, P(BATCH, None), P()),
            out_specs=P(BATCH, None),
        )

    # retrieval: 1 user vs 1M candidates, candidates sharded; the slate is
    # padded to a shard multiple
    NC = info["n_cands"]
    NC_pad = (NC + SHARD_PAD - 1) // SHARD_PAD * SHARD_PAD
    return DryrunCell(
        arch="mind", shape=shape, kind="serve",
        fn=retrieval_fn(cfg, NC),
        arg_specs=(params, _meta((B, cfg.hist_len)), _meta((NC_pad,))),
        in_specs=(PARAM_SPECS, P(), P(CAND)),
        out_specs=(P(), P()),
    )


def smoke_batch(device=None) -> dict:
    """``mind_smoke``'s batch: 8 histories and targets drawn as the
    reference draws them (``randint`` from ``PRNGKey(0)``, bitwise), on
    ``device`` (the card by default)."""
    device = _device(device)
    key = prng_key(0)
    hist = randint(key, (8, SMOKE.hist_len), 0, SMOKE.n_items)
    target = randint(key, (8,), 1, SMOKE.n_items)
    return {"hist": torch.from_numpy(hist).to(device),
            "target": torch.from_numpy(target).to(device)}


def mind_smoke(device=None) -> dict:
    """One train step of ``SMOKE`` and a 64-item slate's scores on
    ``device`` (the card by default)."""
    device = _device(device)
    cfg = SMOKE
    params = M.init(torch.Generator(device=device).manual_seed(0), cfg, device=device)
    opt = adamw_init(params)
    batch = smoke_batch(device)
    params, opt, metrics = make_train_step(cfg)(params, opt, batch)
    scores = M.serve_scores(params, cfg, batch["hist"],
                            torch.arange(64, dtype=torch.int32, device=device))
    loss = float(metrics["loss"])
    return {"loss": loss,
            "finite": bool(torch.isfinite(metrics["loss"])) and bool(torch.isfinite(scores).all())}


register(ArchSpec(
    arch_id="mind",
    family="recsys",
    shapes=RECSYS_SHAPES,
    build_cell=build_cell,
    smoke_step=mind_smoke,
    description=__doc__,
))
