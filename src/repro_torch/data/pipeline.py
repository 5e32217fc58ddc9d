"""Deterministic, restart-safe token batches, as ``repro.data.pipeline``.

``TokenPipeline.batch(step)`` is a stateless function of (seed, step):
after a restore at step S the trainer asks for batch S and gets the batch
the uninterrupted run saw, so there is no iterator state to checkpoint.
The stream has a Zipf-like unigram marginal (uniform in log-rank space)
so that losses move like natural text.

The batches are the reference's.  Its ``jax.random`` calls are rebuilt in
numpy uint32 arithmetic: ``PRNGKey(seed)``, ``fold_in(key, step)`` and
``uniform``'s bits-to-float, over the threefry-2x32 hash, in jax's
partitionable counter layout (``jax_threefry_partitionable``, jax's
default since its 0.5 release: each element hashes its 64-bit flat index
as (hi, lo) and takes the two output words' xor).  The uniforms equal the reference's
bitwise.  ``exp(u·log V)`` runs in f32 through ``exp_f32``, the
algorithm of XLA's f32 exp on the CPU (Cephes' range reduction and
degree-5 polynomial, with fused multiply-adds), which equals it bitwise
where a correctly rounded exp differs by an ulp on a tenth of the inputs
and moves about 3e-5 of the tokens across an integer at V = 32,000.

``GraphBatchPipeline`` (the GNN trainer's seed nodes) draws through
``randint``, jax 0.9's ``_randint`` in the same uint32 arithmetic: a
``split`` of the key, two sets of 32-bit words, and their combination
modulo the span with wraparound.  Its seeds, and the neighbour sampler's
draws (``graphs/sampler.py``), equal the reference's bitwise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under the key (k1, k2); uint32 arrays in, a uint32 pair out."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` as jax makes it with 64-bit mode off
    (its default): the seed taken modulo 2**32, the high word 0."""
    return 0, seed & 0xFFFFFFFF


def fold_in(key: tuple, data: int) -> tuple:
    """``jax.random.fold_in``: the key's hash of the counter pair (0, data)."""
    y0, y1 = threefry2x32(*key, np.zeros(1, np.uint32), np.full(1, data, np.uint32))
    return int(y0[0]), int(y1[0])


def split(key: tuple, num: int = 2) -> list:
    """``jax.random.split(key, num)``: key ``i`` is the key's hash of the
    counter pair (0, i)."""
    y0, y1 = threefry2x32(*key, np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32))
    return [(int(a), int(b)) for a, b in zip(y0, y1)]


def random_bits(key: tuple, shape) -> np.ndarray:
    """32 random bits an element (``jax.random.bits``): the hash of each
    element's 64-bit flat index as (hi, lo), the two words xor'ed."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b1, b2 = threefry2x32(*key, hi, lo)
    return (b1 ^ b2).reshape(shape)


def uniform(key: tuple, shape) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` in f32 on [0, 1), bitwise."""
    bits = random_bits(key, shape) >> np.uint32(9) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def randint(key: tuple, shape, lo: int, hi: int) -> np.ndarray:
    """``jax.random.randint(key, shape, lo, hi)`` (int32), bitwise: the
    key split in two, 32 bits an element from each half, combined as
    ``(hi_bits % span · (2**32 % span) + lo_bits % span) % span`` in
    uint32 arithmetic that wraps, then offset by ``lo``.  ``lo`` and
    ``hi`` lie in int32; ``hi <= lo`` gives ``lo``."""
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint32((hi - lo) & 0xFFFFFFFF) if hi > lo else np.uint32(1)
    with np.errstate(over="ignore"):
        mult = np.uint32(2 ** 16) % span
        mult = (mult * mult) % span
        off = ((higher % span) * mult + lower % span) % span
    return (np.int64(lo) + off.astype(np.int64)).astype(np.int32)


# The same hash and draws in torch, on a key tensor's device: uint32 words
# held in int64 and masked after every add and shift (torch's uint32 has
# too few ops).  Shapes depend on nothing but the arguments, so a meta key
# gives meta draws (the dry run's sampled cells).

_M32 = 0xFFFFFFFF


def _threefry_t(k1, k2, x1, x2):
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = (((x[1] << r) | (x[1] >> (32 - r))) & _M32) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x[0], x[1]


def split_t(key: torch.Tensor, num: int = 2) -> list:
    """``split`` of a (2,) int64 key tensor of uint32 words: ``num`` such
    keys on its device."""
    ctr = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = _threefry_t(key[0], key[1], torch.zeros_like(ctr), ctr)
    return list(torch.stack([y0, y1], dim=1))


def random_bits_t(key: torch.Tensor, shape) -> torch.Tensor:
    """``random_bits`` of a key tensor, as int64 words on its device."""
    idx = torch.arange(int(np.prod(shape)), dtype=torch.int64, device=key.device)
    b1, b2 = _threefry_t(key[0], key[1], idx >> 32, idx & _M32)
    return (b1 ^ b2).reshape(shape)


def randint_t(key: torch.Tensor, shape, lo: int, hi: int) -> torch.Tensor:
    """``randint`` of a key tensor on its device (int32), bitwise."""
    k1, k2 = split_t(key)
    higher, lower = random_bits_t(k1, shape), random_bits_t(k2, shape)
    span = (hi - lo) & _M32 if hi > lo else 1
    mult = (2 ** 16) % span
    mult = (mult * mult & _M32) % span
    off = (((higher % span) * mult & _M32) + lower % span & _M32) % span
    return (lo + off).to(torch.int32)


def _fma(a, b, c):
    """f32 a·b + c rounded once: the product of two f32 values is exact in
    float64."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


_LOG2E = np.float32(1.44269504088896341)
_LN2_HI, _LN2_LO = np.float32(-0.693359375), np.float32(2.12194440e-4)
_EXP_POLY = tuple(np.float32(c) for c in (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
                                          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1))


def exp_f32(x: np.ndarray) -> np.ndarray:
    """f32 ``exp`` as XLA computes it on the CPU: ``m = floor(x·log2 e +
    1/2)``, ``r = x - m·ln 2`` in two parts, ``exp(r)`` by Cephes'
    polynomial, scaled by ``2**m``.  For the pipeline's x in [0, log V]."""
    x = np.minimum(np.asarray(x, np.float32), np.float32(88.723))
    m = np.floor(_fma(x, _LOG2E, np.float32(0.5)))
    r = _fma(m, _LN2_LO, _fma(m, _LN2_HI, x))
    y = _EXP_POLY[0]
    for c in _EXP_POLY[1:]:
        y = _fma(y, r, c)
    y = _fma(y, r * r, r) + np.float32(1.0)
    return y * np.exp2(m)


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def uniforms(self, step: int) -> np.ndarray:
        """The (global_batch, seq_len + 1) f32 uniforms of ``step``."""
        key = fold_in(prng_key(self.seed), step)
        return uniform(key, (self.global_batch, self.seq_len + 1))

    def batch(self, step: int) -> dict:
        """The global batch of ``step``: int32 ``tokens`` and ``labels``
        (global_batch, seq_len) on the host (placing it is the trainer's
        job)."""
        u = self.uniforms(step)
        x = u * np.log(np.float32(self.vocab_size))
        ranks = exp_f32(x).astype(np.int32)
        toks = torch.from_numpy(np.clip(ranks - 1, 0, self.vocab_size - 1))
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def specs(self) -> dict:
        """The batch's shapes and dtypes, as tensors on the meta device."""
        shape = (self.global_batch, self.seq_len)
        return {k: torch.empty(shape, dtype=torch.int32, device="meta")
                for k in ("tokens", "labels")}


@dataclasses.dataclass
class GraphBatchPipeline:
    """Seeded mini-batches of node ids for sampled GNN training."""

    n_nodes: int
    batch_nodes: int
    seed: int = 0

    def batch(self, step: int) -> torch.Tensor:
        """The (batch_nodes,) int32 seed nodes of ``step``, on the host."""
        key = fold_in(prng_key(self.seed), step)
        return torch.from_numpy(randint(key, (self.batch_nodes,), 0, self.n_nodes))

    def specs(self) -> torch.Tensor:
        return torch.empty((self.batch_nodes,), dtype=torch.int32, device="meta")
