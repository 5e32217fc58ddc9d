"""egnn [gnn] — 4 layers, d_hidden=64, E(n)-equivariant (scalar invariants +
coordinate updates).  [arXiv:2102.09844; paper]"""

import dataclasses

from ..models.gnn import egnn

BASE = egnn.EGNNConfig(name="egnn", n_layers=4, d_hidden=64)


def cfg_for_shape(shape, info):
    return dataclasses.replace(
        BASE, d_feat=info["d_feat"], n_classes=info["n_classes"],
        task=info["task"],
        # citation graphs have no geometry: no coordinate updates there
        update_coords=(shape == "molecule"),
    )


SMOKE = dataclasses.replace(BASE, d_feat=8, d_hidden=16, n_layers=2)
