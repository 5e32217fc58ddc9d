"""gcn-cora [gnn] — 2 layers, d_hidden=16, mean/sym-norm aggregation.
[arXiv:1609.02907; paper]"""

import dataclasses

from ..models.gnn import gcn
from .registry import ArchSpec, register, GNN_SHAPES
from .gnn_common import build_gnn_cell, gnn_smoke

BASE = gcn.GCNConfig(name="gcn-cora", n_layers=2, d_hidden=16)


def cfg_for_shape(shape, info):
    return dataclasses.replace(
        BASE, d_feat=info["d_feat"], n_classes=info["n_classes"],
        task=info["task"],
        # the reference's row pin on the full-graph shapes (it places
        # nothing on one device)
        pin_mode="rows" if info["kind"] == "full" else None,
    )


SMOKE = dataclasses.replace(BASE, d_feat=8, n_classes=4, task="graph_reg",
                            d_hidden=8)

register(ArchSpec(
    arch_id="gcn-cora",
    family="gnn",
    shapes=GNN_SHAPES,
    build_cell=lambda shape, **opts: build_gnn_cell("gcn-cora", shape, gcn, cfg_for_shape, **opts),
    smoke_step=lambda device=None: gnn_smoke(gcn, SMOKE, device),
    description=__doc__,
))
