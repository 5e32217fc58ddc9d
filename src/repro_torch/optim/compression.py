"""Gradient compression for the data-parallel axis, as
``repro.optim.compression``: int8 block quantisation (one f32 scale per
block of 256 values) with error feedback, the residual carried to the next
step.

The arithmetic is the reference's, so codes, scales and residuals match
it bitwise: ``torch.round`` rounds half to even as ``jnp.round`` does, and
the scale's division by 127 goes through a tensor divisor (a Python scalar
divisor becomes a multiply by its reciprocal on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .adamw import _tree_map

BLOCK = 256


@dataclasses.dataclass
class CompressionState:
    error: Any  # a tree of f32 residuals, the shapes of the grads


def compression_init(grads_like) -> CompressionState:
    return CompressionState(error=_tree_map(
        lambda g: torch.zeros_like(g, dtype=torch.float32), grads_like))


def _pad_len(n: int) -> int:
    return (n + BLOCK - 1) // BLOCK * BLOCK


def compress_int8(x: torch.Tensor):
    """x (any shape) → (int8 codes (nblocks, BLOCK), f32 scales (nblocks, 1))."""
    flat = x.to(torch.float32).reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, _pad_len(flat.shape[0]) - flat.shape[0]))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / blocks.new_tensor(127.0)
    safe = torch.clamp(scale, min=1e-12)
    codes = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    return codes, scale


def decompress_int8(codes, scale, shape):
    flat = (codes.to(torch.float32) * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def compressed_gradient(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback quantise: (the dequantised gradient in ``g``'s dtype,
    the new f32 residual)."""
    target = g.to(torch.float32) + err
    codes, scale = compress_int8(target)
    deq = decompress_int8(codes, scale, g.shape)
    return deq.to(g.dtype), target - deq
