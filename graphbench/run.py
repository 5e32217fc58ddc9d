"""Run one cell of the graph benchmark once and print its result line.

    python3 graphbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``.  The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and ``checks``: each number compared with its limit).  Without a CUDA
device, or if JAX or the JAX package is loaded once the window has
closed, it prints no result and exits non-zero.
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from gbharness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
