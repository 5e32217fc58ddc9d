"""The port's copies of the JAX package's LM configs (``FULL`` and
``SMOKE`` of each of the five architectures), as ``models.transformer.
LMConfig``s.  The reference's registry and dry-run cells are not ported."""
