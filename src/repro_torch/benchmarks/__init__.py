"""Benchmark entry points of the port (``kernels_bench``) and their shared
timing and row helpers (``common``)."""
