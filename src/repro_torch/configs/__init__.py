"""The port's copies of the JAX package's model configs and its
architecture registry: the five LM architectures (``FULL`` and ``SMOKE``
of each, as ``models.transformer.LMConfig``s, with ``lm_common``'s cell
builder), the four GNN architectures (``gcn_cora``, ``egnn``,
``nequip``, ``mace``: ``BASE``, ``cfg_for_shape`` and ``SMOKE``, with
``gnn_common``'s step and cell builders) and ``mind``.  Each registers
an ``ArchSpec`` whose cells (``make_dryrun_cell``) ``launch/dryrun.py``
accounts on meta tensors."""

from .registry import ARCHS, get_arch, make_dryrun_cell, list_cells  # noqa: F401
