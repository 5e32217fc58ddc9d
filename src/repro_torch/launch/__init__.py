"""Entry points that serve the port's engine (``graph_serve``) and its LMs
(``serve``), and train the LMs (``train``)."""
