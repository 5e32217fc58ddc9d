# The paper's graph-analytics engine (Gill et al., "Single Machine Graph
# Analytics on Massive Datasets Using Intel Optane DC Persistent Memory",
# 2019), ported from the JAX package to PyTorch on a CUDA device.
from . import algorithms, dynamic, engine, frontier, graph, operators, tiered  # noqa: F401
from .dynamic import DeltaBatch, DynamicGraph, dynamize  # noqa: F401
from .graph import Graph, default_device, from_arrays, from_coo  # noqa: F401
from .tiered import TieredGraph, tier_graph  # noqa: F401
