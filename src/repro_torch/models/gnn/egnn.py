"""EGNN (Satorras et al., arXiv:2102.09844), as ``repro.models.gnn.egnn``:
E(n)-equivariant message passing on scalar invariants (squared distances)
with coordinate updates.
"""

from __future__ import annotations

import dataclasses

import torch

from ...core.graph import _device
from . import common as C


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_feat: int = 16
    task: str = "graph_reg"     # energy regression; "node_class" also supported
    n_classes: int = 7
    update_coords: bool = True


def init(gen: torch.Generator, cfg: EGNNConfig, device=None):
    device = _device(device)
    d = cfg.d_hidden

    def mlp(dims):
        return C.mlp_init(gen, dims, device=device)

    return {
        "embed": mlp([cfg.d_feat, d]),
        "layers": [{"phi_e": mlp([2 * d + 1, d, d]), "phi_x": mlp([d, d, 1]),
                    "phi_h": mlp([2 * d, d, d])} for _ in range(cfg.n_layers)],
        "readout": mlp([d, d, 1 if cfg.task == "graph_reg" else cfg.n_classes]),
    }


def apply(params, cfg: EGNNConfig, batch: C.GNNBatch):
    h = C.mlp_apply(params["embed"], batch.features, final_act=True)
    x = batch.positions
    em = batch.edge_mask.to(torch.float32)[:, None]
    s, d, N = batch.src, batch.dst, batch.n_nodes
    deg = C.degrees(batch)[:, None] + 1.0
    for lp in params["layers"]:
        rel = x.index_select(0, d) - x.index_select(0, s)
        r2 = torch.sum(torch.square(rel), dim=-1, keepdim=True)
        m = C.mlp_apply(lp["phi_e"], torch.cat([h.index_select(0, d), h.index_select(0, s), r2],
                                               -1), final_act=True) * em
        if cfg.update_coords:
            # tanh-bounded coordinate gate keeps updates stable
            cw = torch.tanh(C.mlp_apply(lp["phi_x"], m)) * em
            x = x + C.segment_sum(rel * cw, d, N) / deg
        agg = C.segment_sum(m, d, N)
        h = h + C.mlp_apply(lp["phi_h"], torch.cat([h, agg], -1))
    out = C.mlp_apply(params["readout"], h)
    if cfg.task == "graph_reg":
        return C.segment_sum(out[:, 0], batch.graph_id, batch.n_graphs)
    return out


def loss_fn(params, cfg: EGNNConfig, batch: C.GNNBatch):
    return C.task_loss(apply(params, cfg, batch), cfg, batch)
