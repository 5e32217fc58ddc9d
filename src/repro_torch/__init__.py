"""PyTorch port of the graph-analytics engine in ``repro`` (the JAX package,
which stays the reference).  Runs on one CUDA device through hand-written
kernels (``kernels/graph_ops``); pass ``device="cpu"`` to run the plain
torch version on the CPU."""

from .core.graph import Graph, default_device, from_coo  # noqa: F401
