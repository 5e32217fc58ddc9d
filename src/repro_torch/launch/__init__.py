"""Entry points that serve the port's engine (``graph_serve``)."""
