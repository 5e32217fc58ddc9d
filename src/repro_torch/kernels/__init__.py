"""The port's hand-written CUDA kernels, one package each, built by
``build.py``.  ``KERNELS`` maps each kernel's name to the wrapper that
launches it; every wrapper counts its launches in ``.launches`` (and flash
attention its launches on the tensor cores, now every one, in
``.tc_launches``)."""

from .embedding_bag.embedding_bag import embedding_bag
from .flash_attention.flash_attention import flash_attention_bhsd
from .graph_ops.ops import advance_frontier, edge_relax, edge_relax_lanes, intersect_count
from .spmm_bsr.spmm_bsr import spmm_bsr

KERNELS = {"edge_relax": edge_relax, "advance": advance_frontier,
           "intersect": intersect_count, "edge_relax_lanes": edge_relax_lanes,
           "flash_attention": flash_attention_bhsd, "spmm_bsr": spmm_bsr,
           "embedding_bag": embedding_bag}


def reset_launches() -> None:
    """Set every kernel's launch counts to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
    flash_attention_bhsd.tc_launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
