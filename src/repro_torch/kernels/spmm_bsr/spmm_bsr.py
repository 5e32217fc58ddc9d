"""Wrapper of the block-ELL SpMM CUDA kernel (``csrc/spmm_bsr.cu``) and the
host-side format conversion ``to_bsr``, the counterparts of
``src/repro/kernels/spmm_bsr/spmm_bsr.py``.

On CUDA tensors ``spmm_bsr`` checks device, dtype, shape and contiguity,
allocates the output, launches on the current stream, raises when the
launch function reports an error, and adds one to ``spmm_bsr.launches``.
The kernel runs on the tensor cores: f32 operands as a split TF32 product
(three passes, two when one operand is bf16), bf16 x bf16 in one bf16
pass, all with f32 sums; the result meets the reference's f32 tolerance.
On CPU tensors it calls ``ref.spmm_bsr_plain`` and launches nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import build
from .ref import spmm_bsr_plain

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
MAX_BM = 128   # rows of an adjacency block the kernel takes


def spmm_bsr(indices, blocks, x):
    """indices: (R, K) int32 column-block ids (-1 = padding); blocks:
    (R, K, bm, bk) f32 or bf16; x: (C*bk, F) f32 or bf16.  Returns
    (R*bm, F) = A @ X in x's dtype."""
    if x.device.type == "cpu":
        return spmm_bsr_plain(indices, blocks, x)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"spmm_bsr runs on cuda or cpu tensors, not {dev}")
    if blocks.dim() != 4 or indices.dim() != 2 or x.dim() != 2:
        raise ValueError(f"bad shapes: indices {tuple(indices.shape)}, blocks "
                         f"{tuple(blocks.shape)}, x {tuple(x.shape)}")
    R, K, bm, bk = blocks.shape
    rows, F = x.shape
    if not (0 < bm <= MAX_BM and bk > 0 and rows % bk == 0 and F > 0 and K > 0):
        raise ValueError(f"spmm_bsr kernel takes 0 < bm <= {MAX_BM} and x rows a "
                         f"multiple of bk: bm={bm} bk={bk} x {tuple(x.shape)}")
    if R * -(-F // 128) >= 2**31 or rows // bk >= 2**31:
        raise ValueError(f"too many blocks: R={R} F={F} C={rows // bk}")
    for name, t, dtypes, shape in (("indices", indices, (torch.int32,), (R, K)),
                                   ("blocks", blocks, tuple(_DTYPE), (R, K, bm, bk)),
                                   ("x", x, tuple(_DTYPE), (rows, F))):
        if t.device != dev or t.dtype not in dtypes or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected one of {dtypes} {shape} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((R * bm, F), dtype=x.dtype, device=dev)
    if R == 0:
        return out
    lib = build.load("spmm_bsr")
    rc = lib.spmm_bsr_forward(indices.data_ptr(), blocks.data_ptr(), x.data_ptr(),
                              out.data_ptr(), R, K, bm, bk, rows // bk, F,
                              _DTYPE[blocks.dtype], _DTYPE[x.dtype],
                              torch.cuda.current_stream().cuda_stream)
    build.check(lib, rc, "spmm_bsr")
    spmm_bsr.launches += 1
    return out


spmm_bsr.launches = 0


# ---------------------------------------------------------------------------
# host-side format conversion (numpy, as in the JAX package, whose arrays it
# reproduces bit for bit)
# ---------------------------------------------------------------------------

def to_bsr(src, dst, w, n, *, bm: int = 128, bk: int = 128):
    """COO edge list → (indices (R,K) int32, blocks (R,K,bm,bk) f32) numpy
    block-ELL arrays.  A[dst, src] layout so that A @ X aggregates src
    features into dst rows (pull-style); duplicate edges sum."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    w = np.asarray(w, np.float32)
    R = (n + bm - 1) // bm
    C = (n + bk - 1) // bk
    rb = dst // bm
    cb = src // bk
    keys = rb * C + cb
    order = np.argsort(keys, kind="stable")
    src, dst, w, rb, cb, keys = (a[order] for a in (src, dst, w, rb, cb, keys))
    uniq, starts = np.unique(keys, return_index=True)
    counts_per_row = np.bincount(uniq // C, minlength=R)
    K = max(int(counts_per_row.max()), 1)
    indices = np.full((R, K), -1, np.int32)
    blocks = np.zeros((R, K, bm, bk), np.float32)
    slot = np.zeros(R, np.int32)
    ends = np.append(starts[1:], len(keys))
    for u, s0, e0 in zip(uniq, starts, ends):
        r, c = int(u // C), int(u % C)
        kslot = slot[r]
        slot[r] += 1
        indices[r, kslot] = c
        np.add.at(
            blocks[r, kslot], (dst[s0:e0] - r * bm, src[s0:e0] - c * bk), w[s0:e0]
        )
    return indices, blocks
