"""MACE (Batatia et al., arXiv:2206.07697), as ``repro.models.gnn.mace``:
higher-order equivariant message passing, per-edge A-features (one tensor
product with the spherical harmonics) then node-wise symmetric tensor
products up to correlation order 3 (the ACE product basis), and per-layer
energy readouts.  The SO(3) variant, channel-wise contractions (see
``irreps``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ...core.graph import _device
from . import common as C
from . import irreps as ir
from .nequip import edge_geometry, edge_messages, mix_init


@dataclasses.dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    hidden_mul: int = 128
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    cutoff: float = 5.0
    d_feat: int = 16
    radial_hidden: int = 64
    avg_degree: float = 8.0
    task: str = "graph_reg"   # or "node_class"
    n_classes: int = 7


def _pair_paths(l_max: int):
    """(l1, l2, l3) for node-wise feature ⊗ feature products."""
    return ir.tp_paths(l_max)


def node_tensor_product(f1: dict, f2: dict, w: torch.Tensor, l_max: int) -> dict:
    """Channel-wise node tensor product: w (n_paths, mul)."""
    first = next(iter(f1.values()))
    out = {}
    for pi, (l1, l2, l3) in enumerate(_pair_paths(l_max)):
        cg = ir.cg_tensor(l1, l2, l3, first)
        m = torch.einsum("nui,nuj,ijk->nuk", f1[l1], f2[l2], cg)
        m = m * w[pi][None, :, None]
        out[l3] = m if l3 not in out else out[l3] + m
    return out


def init(gen: torch.Generator, cfg: MACEConfig, device=None):
    device = _device(device)
    mul, lm = cfg.hidden_mul, cfg.l_max
    n_pair = len(_pair_paths(lm))

    def normal(shape, fan_in):
        return torch.randn(shape, generator=gen, device=device) / math.sqrt(fan_in)

    out_dim = 1 if cfg.task == "graph_reg" else cfg.n_classes
    return {
        "embed": C.mlp_init(gen, [cfg.d_feat, mul], device=device),
        "layers": [{
            "radial": C.mlp_init(gen, [cfg.n_rbf, cfg.radial_hidden,
                                       len(ir.tp_paths(lm)) * mul], device=device),
            "a_mix": mix_init(gen, mul, mul, lm, device),
            "w2": normal((n_pair, mul), mul),
            "w3": normal((n_pair, mul), mul),
            "self": mix_init(gen, mul, mul, lm, device),
            "msg_mix": mix_init(gen, 3 * mul, mul, lm, device),
        } for _ in range(cfg.n_layers)],
        "readouts": [C.mlp_init(gen, [mul, mul // 2 or 1, out_dim], device=device)
                     for _ in range(cfg.n_layers)],
    }


def apply(params, cfg: MACEConfig, batch: C.GNNBatch):
    N, lm, mul = batch.n_nodes, cfg.l_max, cfg.hidden_mul
    dev, dtype = batch.features.device, batch.features.dtype
    h = ir.zeros_feat(lm, N, mul, dtype=dtype, device=dev)
    h[0] = C.mlp_apply(params["embed"], batch.features, final_act=True)[:, :, None]
    Y, rbf, em = edge_geometry(batch, cfg)

    out_dim = 1 if cfg.task == "graph_reg" else cfg.n_classes
    acc = (torch.zeros((batch.n_graphs,), dtype=dtype, device=dev) if cfg.task == "graph_reg"
           else torch.zeros((N, out_dim), dtype=dtype, device=dev))
    for li, lp in enumerate(params["layers"]):
        # A-features: one edge tensor product aggregated (ACE atomic basis)
        A = ir.linear_mix(edge_messages(lp, h, Y, rbf, em, batch, cfg), lp["a_mix"])
        # product basis: B2 = A⊗A, B3 = B2⊗A (correlation 3)
        B2 = node_tensor_product(A, A, lp["w2"], lm)
        parts = [A, B2]
        if cfg.correlation >= 3:
            parts.append(node_tensor_product(B2, A, lp["w3"], lm))
        msg_cat = {l: torch.cat([p[l] for p in parts], dim=1) for l in A}
        mixed = ir.linear_mix(msg_cat, lp["msg_mix"])
        selfc = ir.linear_mix(h, lp["self"])
        h = ir.gate({l: mixed[l] + selfc[l] for l in mixed})
        # per-layer readout (MACE-style site energies)
        out = C.mlp_apply(params["readouts"][li], h[0][:, :, 0])
        if cfg.task == "graph_reg":
            acc = acc + C.segment_sum(out[:, 0], batch.graph_id, batch.n_graphs)
        else:
            acc = acc + out
    return acc


def loss_fn(params, cfg: MACEConfig, batch: C.GNNBatch):
    return C.task_loss(apply(params, cfg, batch), cfg, batch)
