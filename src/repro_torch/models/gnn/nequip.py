"""NequIP (Batzner et al., arXiv:2101.03164), as ``repro.models.gnn.nequip``:
an E(3)-equivariant interatomic potential, per-edge spherical-harmonic
tensor products with learned radial weights, aggregated by segment sums
(the SO(3) variant; see ``irreps``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ...core.graph import _device
from . import common as C
from . import irreps as ir


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    hidden_mul: int = 32
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    d_feat: int = 16
    radial_hidden: int = 32
    avg_degree: float = 8.0
    task: str = "graph_reg"   # or "node_class"
    n_classes: int = 7


def _n_paths(l_max: int) -> int:
    return len(ir.tp_paths(l_max))


def mix_init(gen, mul_in: int, mul_out: int, l_max: int, device):
    """{l: (mul_in, mul_out)} channel mixes, N(0, 1)/sqrt(mul_in)."""
    return {l: torch.randn((mul_in, mul_out), generator=gen, device=device) / math.sqrt(mul_in)
            for l in range(l_max + 1)}


def init(gen: torch.Generator, cfg: NequIPConfig, device=None):
    device = _device(device)
    mul, lm = cfg.hidden_mul, cfg.l_max
    out_dim = 1 if cfg.task == "graph_reg" else cfg.n_classes
    return {
        "embed": C.mlp_init(gen, [cfg.d_feat, mul], device=device),
        "layers": [{
            "radial": C.mlp_init(gen, [cfg.n_rbf, cfg.radial_hidden, _n_paths(lm) * mul],
                                 device=device),
            "mix": mix_init(gen, mul, mul, lm, device),
            "self": mix_init(gen, mul, mul, lm, device),
        } for _ in range(cfg.n_layers)],
        "readout": C.mlp_init(gen, [mul, mul, out_dim], device=device),
    }


def edge_geometry(batch: C.GNNBatch, cfg):
    """(Y, rbf, em): the edges' spherical harmonics, radial basis and
    message mask.  Degenerate edges (self loops, padding, zero positions:
    dist → 0) carry no direction, Y_l(0) is not covariant, so they carry
    no message."""
    s, d = batch.src, batch.dst
    rel = batch.positions.index_select(0, s) - batch.positions.index_select(0, d)
    dist = torch.sqrt(torch.sum(rel * rel, dim=-1))
    u = rel / torch.clamp(dist, min=1e-6)[:, None]
    Y = ir.sph_all(cfg.l_max, u)
    rbf = C.bessel_rbf(dist, cfg.n_rbf, cfg.cutoff)
    em = (batch.edge_mask & (dist > 1e-6)).to(rbf.dtype)
    return Y, rbf, em


def edge_messages(lp, h, Y, rbf, em, batch: C.GNNBatch, cfg):
    """One edge tensor product aggregated at dst, scaled by
    1/sqrt(avg_degree): {l: (N, mul, 2l+1)}."""
    mul, lm = cfg.hidden_mul, cfg.l_max
    rw = C.mlp_apply(lp["radial"], rbf).reshape(-1, _n_paths(lm), mul)
    rw = rw * em[:, None, None]
    h_src = {l: x.index_select(0, batch.src) for l, x in h.items()}
    msg = ir.edge_tensor_product(h_src, Y, rw, lm)
    inv_deg = 1.0 / math.sqrt(cfg.avg_degree)
    return {l: C.segment_sum(m, batch.dst, batch.n_nodes) * inv_deg for l, m in msg.items()}


def apply(params, cfg: NequIPConfig, batch: C.GNNBatch):
    N, lm, mul = batch.n_nodes, cfg.l_max, cfg.hidden_mul
    h = ir.zeros_feat(lm, N, mul, dtype=batch.features.dtype, device=batch.features.device)
    h[0] = C.mlp_apply(params["embed"], batch.features, final_act=True)[:, :, None]
    Y, rbf, em = edge_geometry(batch, cfg)
    for lp in params["layers"]:
        agg = edge_messages(lp, h, Y, rbf, em, batch, cfg)
        mixed = ir.linear_mix(agg, lp["mix"])
        selfc = ir.linear_mix(h, lp["self"])
        h = ir.gate({l: mixed[l] + selfc[l] for l in mixed})
    out = C.mlp_apply(params["readout"], h[0][:, :, 0])
    if cfg.task == "graph_reg":
        return C.segment_sum(out[:, 0], batch.graph_id, batch.n_graphs)
    return out  # (N, n_classes)


def loss_fn(params, cfg: NequIPConfig, batch: C.GNNBatch):
    return C.task_loss(apply(params, cfg, batch), cfg, batch)
