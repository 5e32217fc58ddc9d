"""Wrappers of the CRC-32 CUDA kernel (``csrc/crc32.cu``).

``crc32_async(t, out, stream)`` enqueues the CRC of a contiguous CUDA
tensor's bytes on ``stream`` (the current stream by default) and leaves
the 32-bit result in ``out``: a one-word int32 tensor in pinned host
memory (copied back on the same stream) or on the card.  ``crc32(t)``
waits for it and returns the int.  Each launch adds one to
``crc32_async.launches``.  On CPU tensors both take ``ref.crc32_ref`` and
launch nothing; a CUDA tensor the kernel cannot take, or a failed build or
launch, raises: there is no host fallback.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import MASK, NPOWERS, SEGMENT, crc32_ref, init_term, layout, powers


# the powers as the C array the launch function copies to the kernels
_POWERS = (ctypes.c_uint32 * NPOWERS)(*powers(SEGMENT))


def _as_word(crc: int) -> int:
    """A 32-bit CRC as the int32 an out word holds."""
    return crc - (1 << 32) if crc >= 1 << 31 else crc


def crc32_async(t: torch.Tensor, out: torch.Tensor, stream=None) -> None:
    """zlib's CRC-32 of ``t``'s bytes into ``out[0]`` (int32 bits)."""
    if not (out.dtype == torch.int32 and out.numel() == 1 and out.is_contiguous()):
        raise ValueError(f"out must be one contiguous int32 word, not {out.dtype} "
                         f"{tuple(out.shape)}")
    if t.device.type == "cpu":
        out.fill_(_as_word(crc32_ref(t)))
        return
    dev = t.device
    if dev.type != "cuda":
        raise ValueError(f"crc32 runs on cuda or cpu tensors, not {dev}")
    if not t.is_contiguous():
        raise ValueError("crc32 takes a contiguous tensor")
    if out.device.type == "cpu":
        if not out.is_pinned():
            raise ValueError("a host out word must be pinned")
    elif out.device != dev:
        raise ValueError(f"out on {out.device}, the data on {dev}")
    nbytes = t.numel() * t.element_size()
    stream = torch.cuda.current_stream(dev) if stream is None else stream
    if nbytes == 0:   # zlib's CRC of nothing
        out.zero_()
        return
    lay = layout(nbytes)
    with torch.cuda.stream(stream):
        # the block CRCs, and the result's word on the card for a host out
        scratch = torch.empty((lay.blocks + 1,), dtype=torch.int32, device=dev)
    on_host = out.device.type == "cpu"
    lib = build.load("crc32")
    rc = lib.crc32_device(
        t.data_ptr(), nbytes, SEGMENT, lay.pad, lay.blocks, lay.threads, lay.chunk,
        ctypes.addressof(_POWERS), init_term(nbytes), scratch.data_ptr(),
        scratch[lay.blocks:].data_ptr() if on_host else out.data_ptr(),
        out.data_ptr() if on_host else None, stream.cuda_stream)
    build.check(lib, rc, "crc32")
    crc32_async.launches += 1


crc32_async.launches = 0


def crc32(t: torch.Tensor) -> int:
    """zlib's CRC-32 of ``t``'s bytes: the kernel on the current stream,
    waited for, or ``crc32_ref`` for a CPU tensor."""
    if t.device.type == "cpu":
        return crc32_ref(t)
    out = torch.empty((1,), dtype=torch.int32, pin_memory=True)
    crc32_async(t, out)
    torch.cuda.current_stream(t.device).synchronize()
    return int(out[0]) & MASK
