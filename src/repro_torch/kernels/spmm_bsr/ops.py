"""Public wrapper: COO graph in, aggregated features out — the counterpart
of ``src/repro/kernels/spmm_bsr/ops.py``."""

from __future__ import annotations

import torch

from ...core.graph import _device
from .spmm_bsr import spmm_bsr, to_bsr


class BsrMatrix:
    """Preprocessed block-sparse adjacency, built once per graph on the
    host and copied to ``device`` (``cuda`` by default)."""

    def __init__(self, src, dst, w, n, bm: int = 128, bk: int = 128, device=None):
        self.n = n
        self.bm, self.bk = bm, bk
        dev = _device(device)
        indices, blocks = to_bsr(src, dst, w, n, bm=bm, bk=bk)
        self.indices = torch.from_numpy(indices).to(dev)
        self.blocks = torch.from_numpy(blocks).to(dev)

    def matmul(self, x):
        """A @ x for x of (C*bk, F); returns the first n rows."""
        return spmm_bsr(self.indices, self.blocks, x)[: self.n]
