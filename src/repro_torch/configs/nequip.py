"""nequip [gnn] — 5 layers, hidden mul=32, l_max=2, n_rbf=8, cutoff=5,
E(3) tensor-product message passing.  [arXiv:2101.03164; paper]"""

import dataclasses

from ..models.gnn import nequip

BASE = nequip.NequIPConfig(name="nequip", n_layers=5, hidden_mul=32, l_max=2,
                           n_rbf=8, cutoff=5.0)


def cfg_for_shape(shape, info):
    return dataclasses.replace(
        BASE, d_feat=info["d_feat"], n_classes=info["n_classes"],
        task=info["task"],
    )


SMOKE = dataclasses.replace(BASE, d_feat=8, hidden_mul=8, n_layers=2)
