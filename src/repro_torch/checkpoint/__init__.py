"""The persistent graph store (``store``): ``save_graph`` / ``open_graph``,
byte-compatible with ``repro.checkpoint``'s."""

from .store import GRAPH_MANIFEST, open_graph, save_graph  # noqa: F401
