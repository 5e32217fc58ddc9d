"""The port's copies of the JAX package's model configs: the five LM
architectures (``FULL`` and ``SMOKE`` of each, as ``models.transformer.
LMConfig``s) and the four GNN architectures (``gcn_cora``, ``egnn``,
``nequip``, ``mace``: ``BASE``, ``cfg_for_shape`` and ``SMOKE``), with the
GNN step builders in ``gnn_common``.  The reference's registry and dry-run
cells are not ported (ROADMAP queue 1, item 13.4)."""
