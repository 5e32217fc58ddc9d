"""mace [gnn] — 2 layers, hidden mul=128, l_max=2, correlation order 3,
n_rbf=8, E(3)-ACE higher-order message passing.  [arXiv:2206.07697; paper]"""

import dataclasses

from ..models.gnn import mace
from .registry import ArchSpec, register, GNN_SHAPES
from .gnn_common import build_gnn_cell, gnn_smoke

BASE = mace.MACEConfig(name="mace", n_layers=2, hidden_mul=128, l_max=2,
                       correlation=3, n_rbf=8, cutoff=5.0)


def cfg_for_shape(shape, info):
    return dataclasses.replace(
        BASE, d_feat=info["d_feat"], n_classes=info["n_classes"],
        task=info["task"],
    )


SMOKE = dataclasses.replace(BASE, d_feat=8, hidden_mul=8, n_layers=1)

register(ArchSpec(
    arch_id="mace",
    family="gnn",
    shapes=GNN_SHAPES,
    build_cell=lambda shape, **opts: build_gnn_cell("mace", shape, mace, cfg_for_shape, **opts),
    smoke_step=lambda device=None: gnn_smoke(mace, SMOKE, device),
    description=__doc__,
))
