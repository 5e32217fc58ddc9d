# The paper's graph-analytics engine (Gill et al., "Single Machine Graph
# Analytics on Massive Datasets Using Intel Optane DC Persistent Memory",
# 2019), ported from the JAX package to PyTorch on a CUDA device.
from . import algorithms, engine, frontier, graph, operators  # noqa: F401
from .graph import Graph, default_device, from_arrays, from_coo  # noqa: F401
