"""Wrapper of the flash-attention CUDA kernels (``csrc/flash_attention.cu``),
the counterpart of ``src/repro/kernels/flash_attention/flash_attention.py``.

On CUDA tensors it checks device, dtype, shape and contiguity, allocates
the output, launches on the current stream, raises when the launch
function reports an error, and adds one to ``flash_attention_bhsd.launches``
and to ``.tc_launches``: both routes run on the tensor cores, bf16 through
``flash_attention_forward_tc`` and f32 in split TF32 through
``flash_attention_forward``.  When an f32 call's query tiles do not fill
the card, ``kv_splits`` cuts each tile's key range into splits, whose
blocks the kernel merges inside one thread-block cluster.  On CPU tensors
it calls ``ref.flash_attention_plain`` and launches nothing.  ``block_q``
/ ``block_k`` set the plain version's tiles (and only there are they
checked); the kernels tile as their source says, whatever they are.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from .. import build
from .ref import flash_attention_plain

MAX_D = 128     # widest head the kernel takes
BLOCK_Q = 64    # queries per block of both kernels
BLOCK_K = 64    # keys per tile of the f32 kernel, the unit of its splits
MAX_SPLITS = 8  # the f32 kernel's splits of a query tile: one cluster's portable most
H100_SMS = 132  # streaming multiprocessors of an H100 SXM


def visible_tiles(s: int, q0: int, causal: bool, window: Optional[int]):
    """The key tiles ``[lo, hi)`` that some query of the query tile starting
    at ``q0`` can see, as the f32 kernel bounds its loop."""
    k_end = min(s, q0 + BLOCK_Q) if causal else s
    k_begin = max(0, q0 - window + 1) if window is not None else 0
    return k_begin // BLOCK_K, -(-k_end // BLOCK_K)


def split_ranges(s: int, causal: bool, window: Optional[int], splits: int):
    """For each query tile, each split's key tiles ``[lo, hi)``: contiguous
    shares of ``visible_tiles``, as the kernel cuts them (a share may be
    empty where the tile sees fewer key tiles than there are splits)."""
    out = []
    for q0 in range(0, s, BLOCK_Q):
        lo, hi = visible_tiles(s, q0, causal, window)
        n = hi - lo
        out.append([(lo + i * n // splits, lo + (i + 1) * n // splits) for i in range(splits)])
    return out


@functools.lru_cache(maxsize=1024)
def kv_splits(bh: int, s: int, causal: bool, window: Optional[int],
              sms: int = H100_SMS) -> int:
    """Splits of each query tile's key range for the f32 kernel: 1 when the
    ``bh * ceil(s / 64)`` blocks fill the card's ``sms``, else enough to
    fill it, but never more than the most key tiles a query tile sees or
    than MAX_SPLITS.  The head width does not enter: it changes each tile's
    work, not how many blocks there are."""
    blocks = bh * -(-s // BLOCK_Q)
    if blocks >= sms:
        return 1
    most = max(hi - lo for lo, hi in (visible_tiles(s, q0, causal, window)
                                      for q0 in range(0, s, BLOCK_Q)))
    return max(1, min(most, MAX_SPLITS, -(-sms // blocks)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# the current stream's handle as torch's generated launchers read it;
# torch.cuda.current_stream() builds a Stream object first, which takes
# longer than the short cases' kernels
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


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
    if bh * -(-s // BLOCK_Q) >= 2**31:
        raise ValueError(f"too many query tiles: BH={bh} S={s}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t is not q and (t.device != dev or t.dtype != q.dtype or t.shape != q.shape):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected {q.dtype} {tuple(q.shape)} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty_like(q)
    if bh == 0 or s == 0:
        return out
    lib = build.load("flash_attention")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    tail = (bh, s, d, int(causal), -1 if window is None else window, 1.0 / math.sqrt(d))
    stream = (torch.cuda.current_stream().cuda_stream if _raw_stream is None
              else _raw_stream(dev.index))
    if q.dtype == torch.bfloat16:
        rc = lib.flash_attention_forward_tc(*ptrs, *tail, stream)
    else:
        rc = lib.flash_attention_forward(
            *ptrs, *tail, kv_splits(bh, s, causal, window, _sm_count(dev.index)), stream)
    build.check(lib, rc, "flash_attention")
    flash_attention_bhsd.launches += 1
    flash_attention_bhsd.tc_launches += 1
    return out


flash_attention_bhsd.launches = 0
flash_attention_bhsd.tc_launches = 0   # every launch: both routes run on the tensor cores
