"""The GNN stack, as ``repro.models.gnn``: the batch format and helpers
(``common``), the irrep algebra (``irreps``), and GCN, EGNN, NequIP and
MACE (imported by the configs)."""

from . import irreps  # noqa: F401
