"""GCN (Kipf & Welling): symmetric-normalised message passing, as
``repro.models.gnn.gcn``.

Ã = D̂^{-1/2} (A + I) D̂^{-1/2};  H' = σ(Ã H W).

The aggregation is gather, scale, ``segment_sum`` (``index_add``), as in
the reference, which routes it through no kernel.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ...core.graph import _device
from . import common as C


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn-cora"
    n_layers: int = 2
    d_hidden: int = 16
    d_feat: int = 1433
    n_classes: int = 7
    dropout: float = 0.0   # eval-mode default, as the reference
    task: str = "node_class"  # or "graph_reg"
    # the reference's activation-sharding pin ("rows", "cols" or None) and
    # its mesh axes: on one device a sharding constraint places nothing,
    # so the port keeps the fields and pins nothing
    pin_mode: str = None
    pin_axes: tuple = ("data", "model")
    # cast the edge-message path to this dtype (e.g. "bfloat16"); the
    # aggregate is cast back
    message_dtype: str = None


def init(gen: torch.Generator, cfg: GCNConfig, device=None):
    """Weights N(0, 1)/sqrt(fan_in) from ``gen``, zero biases, on ``device``
    (the card by default; ``gen`` must live there)."""
    device = _device(device)
    dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return {"layers": [
        {"w": torch.randn((a, b), generator=gen, device=device) / math.sqrt(a),
         "b": torch.zeros((b,), device=device)}
        for a, b in zip(dims[:-1], dims[1:])
    ]}


def _norm_coefs(batch: C.GNNBatch):
    deg = C.degrees(batch) + 1.0  # +1 for the implicit self loop
    inv_sqrt = torch.rsqrt(deg)
    return inv_sqrt, inv_sqrt.index_select(0, batch.src) * inv_sqrt.index_select(0, batch.dst)


def apply(params, cfg: GCNConfig, batch: C.GNNBatch):
    h = batch.features
    inv_sqrt, edge_norm = _norm_coefs(batch)
    edge_norm = torch.where(batch.edge_mask, edge_norm, 0.0)
    self_w = (inv_sqrt ** 2)[:, None]

    def aggregate(x):
        """Â·x: symmetric-normalised aggregation + self loop."""
        xm = x.to(getattr(torch, cfg.message_dtype)) if cfg.message_dtype else x
        msg = xm.index_select(0, batch.src) * edge_norm.to(xm.dtype)[:, None]
        agg = C.segment_sum(msg, batch.dst, batch.n_nodes)
        return agg.to(x.dtype) + x * self_w

    for i, layer in enumerate(params["layers"]):
        d_in, d_out = layer["w"].shape
        # Â(XW) ≡ (ÂX)W: aggregate in whichever width is narrower, so the
        # edge-wide tensors stay at min(d_in, d_out) columns
        if d_out <= d_in:
            h = aggregate(h @ layer["w"]) + layer["b"]
        else:
            h = aggregate(h) @ layer["w"] + layer["b"]
        if i + 1 < len(params["layers"]):
            h = torch.relu(h)
    if cfg.task == "graph_reg":
        pooled = C.segment_sum(h, batch.graph_id, batch.n_graphs)
        return torch.mean(pooled, dim=-1)  # (G,) scalar prediction
    return h  # (N, n_classes)


def loss_fn(params, cfg: GCNConfig, batch: C.GNNBatch):
    return C.task_loss(apply(params, cfg, batch), cfg, batch)
