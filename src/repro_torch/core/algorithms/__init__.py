from . import bfs, cc, pagerank, sssp  # noqa: F401
