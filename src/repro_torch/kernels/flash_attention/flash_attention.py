"""Wrapper of the flash-attention CUDA kernel (``csrc/flash_attention.cu``),
the counterpart of ``src/repro/kernels/flash_attention/flash_attention.py``.

On CUDA tensors it checks device, dtype, shape and contiguity, allocates
the output, launches on the current stream, raises when the launch
function reports an error, and adds one to ``flash_attention_bhsd.launches``.
bf16 goes to the tensor-core kernel (``flash_attention_forward_tc``), which
also adds one to ``flash_attention_bhsd.tc_launches``; f32 to the kernel on
the CUDA cores (``flash_attention_forward``), exact to f32.  On CPU tensors
it calls ``ref.flash_attention_plain`` and launches nothing.  ``block_q`` /
``block_k`` set the plain version's tiles (and only there are they
checked); the kernels tile as their source says, whatever they are.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import build
from .ref import flash_attention_plain

MAX_D = 128   # widest head the kernel takes


def flash_attention_bhsd(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None,
                         block_q: int = 128, block_k: int = 128):
    """q/k/v: (BH, S, d), f32 or bf16, d <= 128 — flattened batch x heads.
    Returns (BH, S, d) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     block_q=block_q, block_k=block_k)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {dev}")
    if q.dim() != 3:
        raise ValueError(f"q must be (BH, S, d), not {tuple(q.shape)}")
    bh, s, d = q.shape
    if window is not None and window < 1:
        raise ValueError(f"window must be None or at least 1, not {window}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes f32 or bf16, not {q.dtype}")
    if not (0 < d <= MAX_D):
        raise ValueError(f"flash_attention kernel takes head widths 1..{MAX_D}, not {d}")
    if bh * -(-s // 64) >= 2**31:
        raise ValueError(f"too many query tiles: BH={bh} S={s}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected {q.dtype} {tuple(q.shape)} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(q)
    if bh == 0 or s == 0:
        return out
    lib = build.load("flash_attention")
    tc = q.dtype == torch.bfloat16
    forward = lib.flash_attention_forward_tc if tc else lib.flash_attention_forward
    rc = forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, d,
                 int(causal), -1 if window is None else window, 1.0 / math.sqrt(d),
                 torch.cuda.current_stream().cuda_stream)
    build.check(lib, rc, "flash_attention")
    flash_attention_bhsd.launches += 1
    flash_attention_bhsd.tc_launches += int(tc)
    return out


flash_attention_bhsd.launches = 0
flash_attention_bhsd.tc_launches = 0   # the bf16 launches, on the tensor cores
