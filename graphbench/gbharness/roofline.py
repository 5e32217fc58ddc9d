"""Peaks of the chip and the least bytes a traversal must move.

The bound counts what any implementation needs, never what this one
touches, from the reached sets of the plain reference's run on the same
sources: every reached vertex's label written once (4 bytes); a BFS reads
at least one edge index per reached vertex other than the source (4
bytes, the edge that discovers it; direction-optimizing pulls may skip
every other edge); an SSSP reads every out-edge of every reached vertex
once, its index and its weight (8 bytes), since any of them may shorten
a path.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet, 700 W): HBM3 bytes a second
HBM_BYTES_PER_S = 3.35e12

LABEL_BYTES = 4
INDEX_BYTES = 4
WEIGHT_BYTES = 4


def bfs_bytes(reached: int) -> int:
    """Least bytes of a BFS whose reference reached ``reached`` vertices,
    the source included."""
    return reached * LABEL_BYTES + (reached - 1) * INDEX_BYTES


def sssp_bytes(reached: int, reached_out_edges: int) -> int:
    """Least bytes of an SSSP whose reference reached ``reached`` vertices
    holding ``reached_out_edges`` out-edges."""
    return reached * LABEL_BYTES + reached_out_edges * (INDEX_BYTES + WEIGHT_BYTES)
