"""The step builders shared by the four GNN architectures, as
``repro.configs.gnn_common``.

Shapes (the reference's table):
  full_graph_sm: n=2,708 m=10,556 d_feat=1,433 (cora; full-batch node class.)
  minibatch_lg:  n=232,965 m=114,615,892 batch_nodes=1,024 fanout 15-10
                 (reddit-scale sampled training; d_feat=602, 41 classes)
  ogb_products:  n=2,449,029 m=61,859,140 d_feat=100 (full-batch large, 47 cls)
  molecule:      n=30 m=64 batch=128 (batched small graphs, energy regression)

Node and edge arrays are padded to ``SHARD_MULT`` (the reference's mesh
multiple) with masked-out padding.  ``build_gnn_step`` gives the
reference cell's positional step for each kind with its arguments'
shapes and dtypes as meta tensors.  The reference's PartitionSpecs and
``DryrunCell`` wait for the registry and dry-run port (ROADMAP queue 1,
items 13.4 and 13.5): on one device they would place nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.graph import _device
from ..graphs.sampler import sample_blocks_raw
from ..models.gnn import common as C
from ..optim.adamw import adamw_init, adamw_update

SHARD_MULT = 512


def _ru(x: int, mult: int = SHARD_MULT) -> int:
    return (x + mult - 1) // mult * mult


GNN_SHAPE_TABLE = {
    "full_graph_sm": dict(n=2708, m=10556, d_feat=1433, n_classes=7,
                          kind="full", task="node_class"),
    "minibatch_lg": dict(n=232_965, m=114_615_892, d_feat=602, n_classes=41,
                         batch=1024, fanouts=(15, 10), kind="sampled",
                         task="node_class"),
    "ogb_products": dict(n=2_449_029, m=61_859_140, d_feat=100, n_classes=47,
                         kind="full", task="node_class"),
    "molecule": dict(n=30, m=64, batch=128, d_feat=16, n_classes=1,
                     kind="molecule", task="graph_reg"),
}


def value_and_grad(loss_fn, params, cfg, batch):
    """((loss, metrics), grads): ``loss_fn`` and its gradient with respect
    to every parameter (zeros for one the loss does not reach), a tree
    like ``params`` (the reference's ``jax.value_and_grad(loss_fn,
    has_aux=True)``)."""
    ps = C.leaves(params)
    for p in ps:
        p.requires_grad_(True)
    try:
        loss, metrics = loss_fn(params, cfg, batch)
        gs = torch.autograd.grad(loss, ps, allow_unused=True)
    finally:
        for p in ps:
            p.requires_grad_(False)
    by_id = {id(p): torch.zeros_like(p) if g is None else g for p, g in zip(ps, gs)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), C.tree_map(lambda p: by_id[id(p)], params)


def make_train_step(model_mod, cfg, lr: float = 1e-3):
    """step(params, opt, batch) → (params, opt, metrics): the loss's
    gradient, then AdamW (no weight decay, the reference's other
    defaults) on the parameters and state in place."""
    def step(params, opt, batch: C.GNNBatch):
        (_, metrics), grads = value_and_grad(model_mod.loss_fn, params, cfg, batch)
        params, opt = adamw_update(grads, opt, params, lr, weight_decay=0.0)
        return params, opt, metrics

    return step


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def build_gnn_step(model_mod, cfg, kind: str, info: dict):
    """(fn, arg_specs): the reference cell's step for ``kind`` ("full",
    "sampled" or "molecule"), its positional arguments in the reference's
    order, and their shapes and dtypes as meta tensors (N and M padded
    with ``_ru``; the parameters and AdamW state as ``model_mod.init``
    makes them)."""
    params = C.tree_map(lambda t: t.to("meta"),
                        model_mod.init(torch.Generator().manual_seed(0), cfg, device="cpu"))
    head = (params, adamw_init(params))
    step = make_train_step(model_mod, cfg)
    f32, i32 = torch.float32, torch.int32

    if kind == "full":
        N, M = _ru(info["n"]), _ru(info["m"])

        def fn(params, opt, feats, pos, src, dst, labels, node_mask, edge_mask):
            batch = C.GNNBatch(
                n_graphs=1, features=feats, positions=pos, src=src, dst=dst,
                edge_mask=edge_mask,
                graph_id=torch.zeros((feats.shape[0],), dtype=i32, device=feats.device),
                node_mask=node_mask, labels=labels)
            return step(params, opt, batch)

        specs = (_meta((N, info["d_feat"]), f32), _meta((N, 3), f32), _meta((M,), i32),
                 _meta((M,), i32), _meta((N,), i32), _meta((N,), torch.bool),
                 _meta((M,), torch.bool))

    elif kind == "sampled":
        N, M = _ru(info["n"]), _ru(info["m"])
        B, fanouts = info["batch"], info["fanouts"]

        def fn(params, opt, row_ptr, col_idx, out_deg, feats, labels, seeds, key):
            blocks = sample_blocks_raw(row_ptr, col_idx, out_deg, seeds, key, fanouts)
            return step(params, opt, C.blocks_to_batch(feats, labels, blocks, fanouts))

        specs = (_meta((_ru(N + 1),), i32), _meta((M,), i32), _meta((N,), i32),
                 _meta((N, info["d_feat"]), f32), _meta((N,), i32), _meta((B,), i32),
                 _meta((2,), torch.uint32))

    elif kind == "molecule":
        B, n, m = info["batch"], info["n"], info["m"]

        def fn(params, opt, feats, pos, src, dst, labels):
            return step(params, opt, C.flatten_molecules(feats, pos, src, dst, labels))

        specs = (_meta((B, n, info["d_feat"]), f32), _meta((B, n, 3), f32), _meta((B, m), i32),
                 _meta((B, m), i32), _meta((B,), f32))
    else:
        raise ValueError(f"unknown GNN cell kind {kind!r}")
    return fn, head + specs


def smoke_batch(d_feat: int, device=None) -> C.GNNBatch:
    """``gnn_smoke``'s molecule batch: 4 graphs of 10 nodes and 20 random
    edges, features, positions and energies from numpy seed 0, on
    ``device`` (the card by default)."""
    rng = np.random.default_rng(0)
    B, n, m = 4, 10, 20
    feats = rng.normal(size=(B, n, d_feat)).astype(np.float32)
    pos = rng.normal(size=(B, n, 3)).astype(np.float32)
    src = rng.integers(0, n, (B, m))
    dst = rng.integers(0, n, (B, m))
    labels = rng.normal(size=(B,)).astype(np.float32)
    return C.flatten_molecules(feats, pos, src, dst, labels, device=device)


def gnn_smoke(model_mod, cfg, device=None) -> dict:
    """One molecule-style train step of a reduced config on ``device``
    (the card by default)."""
    device = _device(device)
    batch = smoke_batch(cfg.d_feat, device)
    params = model_mod.init(torch.Generator(device=device).manual_seed(0), cfg, device=device)
    opt = adamw_init(params)
    params, opt, metrics = make_train_step(model_mod, cfg)(params, opt, batch)
    loss = float(metrics["loss"])
    return {"loss": loss, "finite": bool(np.isfinite(loss))}
