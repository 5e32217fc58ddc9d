"""The persistent graph store (``store``: ``save_graph`` / ``open_graph``,
and the dynamic v3 ``save_dynamic`` / ``open_dynamic``) and run
checkpoints (``manager``: ``RunCheckpointer``, ``save_pytree`` /
``load_pytree``), byte-compatible with ``repro.checkpoint``'s."""

from .manager import (RunCheckpointer, latest_step, load_pytree,  # noqa: F401
                      save_pytree)
from .store import (GRAPH_MANIFEST, open_dynamic, open_graph,  # noqa: F401
                    save_dynamic, save_graph)
