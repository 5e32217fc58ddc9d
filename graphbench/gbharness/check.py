"""The comparisons that decide ``correct``: the program's answers against
the plain reference's, number by number, each against its limit.  Each
answer kind (``graphbench/answers/<kind>.py``) names its comparison:

* ``mismatched``, for float32 min-plus fixed points (levels, distances),
  which every order of float32 relaxations reaches bitwise: the count of
  vertices whose reached state or value differs.  The program marks an
  unreached vertex with a huge finite sentinel (``finfo(float32).max`` or
  a quarter of it), the reference with ``inf``.
* ``max_rel_err``: the largest relative gap of a value from the
  reference's.
"""

from __future__ import annotations

import torch

# above every distance a cell can reach, below the program's sentinels
UNREACHED = 1e30


def mismatched(labels: torch.Tensor, ref: torch.Tensor) -> int:
    p = labels[: ref.numel()].to(torch.float32)
    r = ref.to(torch.float32)
    reached = torch.isfinite(r)
    bad = ((p < UNREACHED) != reached) | (reached & (p != r))
    return int(bad.sum())


def max_rel_err(ranks: torch.Tensor, ref: torch.Tensor) -> float:
    p = ranks[: ref.numel()].to(torch.float64)
    r = ref.to(torch.float64)
    return float(((p - r).abs() / r).max())


def verdict(readings: dict, limits: dict) -> bool:
    return all(name in readings and readings[name] <= limit
               for name, limit in limits.items())
