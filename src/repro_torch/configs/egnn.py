"""egnn [gnn] — 4 layers, d_hidden=64, E(n)-equivariant (scalar invariants +
coordinate updates).  [arXiv:2102.09844; paper]"""

import dataclasses

from ..models.gnn import egnn
from .registry import ArchSpec, register, GNN_SHAPES
from .gnn_common import build_gnn_cell, gnn_smoke

BASE = egnn.EGNNConfig(name="egnn", n_layers=4, d_hidden=64)


def cfg_for_shape(shape, info):
    return dataclasses.replace(
        BASE, d_feat=info["d_feat"], n_classes=info["n_classes"],
        task=info["task"],
        # citation graphs have no geometry: no coordinate updates there
        update_coords=(shape == "molecule"),
    )


SMOKE = dataclasses.replace(BASE, d_feat=8, d_hidden=16, n_layers=2)

register(ArchSpec(
    arch_id="egnn",
    family="gnn",
    shapes=GNN_SHAPES,
    build_cell=lambda shape, **opts: build_gnn_cell("egnn", shape, egnn, cfg_for_shape, **opts),
    smoke_step=lambda device=None: gnn_smoke(egnn, SMOKE, device),
    description=__doc__,
))
