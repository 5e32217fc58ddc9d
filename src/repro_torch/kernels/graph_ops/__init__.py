"""Graph edge-relaxation substrate: CUDA kernels (``ops``) and their plain
torch versions (``ref``).  ``repro_torch.core.operators`` routes here."""

from .ops import (  # noqa: F401
    advance_frontier,
    edge_relax,
    edge_relax_lanes,
    edge_relax_lanes_,
    intersect_count,
    launch_counts,
    reset_launches,
)
from .ref import (  # noqa: F401
    KINDS,
    advance_ref,
    batched_push_ref,
    batched_relax_into_ref,
    batched_relax_ref,
    batched_scatter_reduce,
    det_push_ref,
    det_relax_ref,
    det_scatter_add,
    edge_message,
    gated,
    intersect_chunks_ref,
    intersect_ref,
    lanes_beyond,
    neutral_for,
    pull_ref,
    push_ref,
    relax_ref,
    scatter_reduce,
    sorted_lower_bound,
)
