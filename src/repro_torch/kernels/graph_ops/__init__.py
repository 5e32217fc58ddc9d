"""Graph edge-relaxation substrate: CUDA kernels (``ops``) and their plain
torch versions (``ref``).  ``repro_torch.core.operators`` routes here."""

from .ops import advance_frontier, edge_relax, launch_counts, reset_launches  # noqa: F401
from .ref import (  # noqa: F401
    KINDS,
    advance_ref,
    det_push_ref,
    det_relax_ref,
    det_scatter_add,
    edge_message,
    intersect_ref,
    neutral_for,
    pull_ref,
    push_ref,
    relax_ref,
    scatter_reduce,
    sorted_lower_bound,
)
