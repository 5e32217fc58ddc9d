"""Wrapper of the embedding-bag CUDA kernel (``csrc/embedding_bag.cu``),
the counterpart of ``src/repro/kernels/embedding_bag/embedding_bag.py``.

On CUDA tensors it checks device, dtype, shape and contiguity, allocates
the output, launches on the current stream, raises when the launch
function reports an error, and adds one to ``embedding_bag.launches``.  On
CPU tensors it calls ``ref.embedding_bag_plain`` and launches nothing.
"""

from __future__ import annotations

import torch

from .. import build
from .ref import embedding_bag_plain

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_CHUNKS = 4   # column chunks of one vector per lane a warp holds


def vec_bytes(d: int, element_size: int) -> int:
    """Bytes a lane loads at once: 16, or 8 where D is narrower than 32
    lanes of 16 B (so that every lane has work)."""
    return 16 if d * element_size >= 32 * 16 else 8


def embedding_bag(ids, weights, table):
    """ids (B, L) int32 (-1 = padding); weights (B, L) f32; table (V, D) f32
    or bf16.  Returns (B, D) = sum_l weights[b, l] * table[ids[b, l]] in the
    table's dtype."""
    if ids.device.type == "cpu":
        return embedding_bag_plain(ids, weights, table)
    dev = ids.device
    if dev.type != "cuda":
        raise ValueError(f"embedding_bag runs on cuda or cpu tensors, not {dev}")
    if ids.dim() != 2 or table.dim() != 2:
        raise ValueError(f"bad shapes: ids {tuple(ids.shape)}, table {tuple(table.shape)}")
    b, l = ids.shape
    v, d = table.shape
    if table.dtype not in _DTYPE:
        raise TypeError(f"embedding_bag kernel takes f32 or bf16 tables, not {table.dtype}")
    for name, t, dtype, shape in (("ids", ids, torch.int32, (b, l)),
                                  ("weights", weights, torch.float32, (b, l)),
                                  ("table", table, table.dtype, (v, d))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected {dtype} {shape} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if v < 1 or d < 1 or b >= 2**31 or l >= 2**31:
        raise ValueError(f"bad sizes: B={b} L={l} V={v} D={d}")
    nbytes = vec_bytes(d, table.element_size())
    vec = nbytes // table.element_size()
    if d % vec or d > 32 * vec * _MAX_CHUNKS:
        raise ValueError(f"embedding_bag kernel takes {table.dtype} rows of a multiple of "
                         f"{vec} up to {32 * vec * _MAX_CHUNKS} elements, not D={d}")
    if table.data_ptr() % nbytes:
        raise ValueError(f"embedding_bag kernel takes a {nbytes}-byte aligned table here")
    out = torch.empty((b, d), dtype=table.dtype, device=dev)
    if b == 0 or l == 0:
        return out.zero_()
    lib = build.load("embedding_bag")
    rc = lib.embedding_bag_forward(ids.data_ptr(), weights.data_ptr(), table.data_ptr(),
                                   out.data_ptr(), b, l, v, d, _DTYPE[table.dtype], nbytes,
                                   torch.cuda.current_stream().cuda_stream)
    build.check(lib, rc, "embedding_bag")
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
