from . import bfs, sssp, cc, pagerank, kcore, bc, tc  # noqa: F401
