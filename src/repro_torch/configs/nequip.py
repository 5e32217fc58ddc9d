"""nequip [gnn] — 5 layers, hidden mul=32, l_max=2, n_rbf=8, cutoff=5,
E(3) tensor-product message passing.  [arXiv:2101.03164; paper]"""

import dataclasses

from ..models.gnn import nequip
from .registry import ArchSpec, register, GNN_SHAPES
from .gnn_common import build_gnn_cell, gnn_smoke

BASE = nequip.NequIPConfig(name="nequip", n_layers=5, hidden_mul=32, l_max=2,
                           n_rbf=8, cutoff=5.0)


def cfg_for_shape(shape, info):
    return dataclasses.replace(
        BASE, d_feat=info["d_feat"], n_classes=info["n_classes"],
        task=info["task"],
    )


SMOKE = dataclasses.replace(BASE, d_feat=8, hidden_mul=8, n_layers=2)

register(ArchSpec(
    arch_id="nequip",
    family="gnn",
    shapes=GNN_SHAPES,
    build_cell=lambda shape, **opts: build_gnn_cell("nequip", shape, nequip, cfg_for_shape, **opts),
    smoke_step=lambda device=None: gnn_smoke(nequip, SMOKE, device),
    description=__doc__,
))
