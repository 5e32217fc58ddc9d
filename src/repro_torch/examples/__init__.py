"""The repo's example scripts (``examples/*.py``) on the port, one module
each, run as ``python -m repro_torch.examples.<name>``: ``quickstart``,
``paper_suite``, ``serve_lm`` and ``train_lm``.  Each takes the JAX
script's flags and prints its lines; ``--device cpu`` runs the plain
versions on the CPU (the card is the default)."""
