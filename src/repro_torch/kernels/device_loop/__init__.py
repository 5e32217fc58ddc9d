"""The device do-while loop of the engine's stretches: a captured round
replayed by a CUDA graph's WHILE node (``device_loop``), and its plain
Python loop (``do_while_plain``)."""

from .device_loop import StretchGraphs, do_while, do_while_plain  # noqa: F401
