"""The persistent graph store (``store``: ``save_graph`` / ``open_graph``,
and the dynamic v3 ``save_dynamic`` / ``open_dynamic``), run checkpoints
and the trainer's checkpoints (``manager``: ``RunCheckpointer``,
``CheckpointManager``, ``save_pytree`` / ``load_pytree``,
``restore_resharded``), byte-compatible with ``repro.checkpoint``'s."""

from .manager import (CheckpointManager, RunCheckpointer, latest_step,  # noqa: F401
                      load_pytree, restore_resharded, save_pytree)
from .store import (GRAPH_MANIFEST, open_dynamic, open_graph,  # noqa: F401
                    save_dynamic, save_graph)
