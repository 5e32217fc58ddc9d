"""Plain torch version of the CRC-32 kernel, and the host arithmetic both
share.

The CRC is zlib's (``zlib.crc32``): the bit-reflected polynomial
0xEDB88320, the register preset to 0xFFFFFFFF and the result xored with
0xFFFFFFFF.  Over GF(2) the register update is linear, so with ``raw(D)``
the CRC of ``D`` from a zero register and no final xor,

    raw(A ‖ B)  = raw(A) · x^(8|B|) mod P  ⊕  raw(B)        (zlib's crc32_combine)
    crc32(D)    = raw(D) ⊕ 0xFFFFFFFF · x^(8|D|) mod P ⊕ 0xFFFFFFFF

and leading zero bytes leave ``raw`` unchanged.  The kernel
(``csrc/crc32.cu``) and ``crc32_ref`` both use that layout (``layout``):

* the buffer is preceded by ``pad`` virtual zero bytes so that it splits
  into ``blocks * THREADS`` segments of ``segment`` bytes, the last one
  ending at the buffer's end; a segment that lies in the padding is 0;
* each segment is folded from a zero register with slice-by-8 tables
  (``slice8_tables``), 8 bytes a step;
* each block's ``THREADS`` segments combine in a binary tree, level ``l``
  shifting the left half by ``POWERS[l] = x^(8 · segment · 2^l)``; the
  block CRCs then combine in order in one block of ``threads`` threads,
  each first folding ``chunk`` consecutive blocks (``POWERS[8]`` a step),
  then in a tree over the threads (``POWERS[8 + log2 chunk + l]``), with
  front padding of zero blocks again;
* the preset is folded in once, for the whole length (``init_term``).

So every shift is one of the powers the host computes once per segment
size (``powers``), and the result does not depend on the order in which
the card runs the blocks.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

POLY = 0xEDB88320
MASK = 0xFFFFFFFF
SEGMENT = 128        # bytes a thread folds (the kernel's default)
THREADS = 256        # segments a block combines (crc32.cu kThreads)
LOG_THREADS = 8
COMBINE_MAX = 1024   # threads of the combining block (crc32.cu kCombineMax)
NPOWERS = 40         # crc32.cu kPowers


def multmodp(a: int, b: int) -> int:
    """``a(x) · b(x) mod P(x)`` in the bit-reflected order (x^0 is bit
    31): zlib's multmodp, in a loop of fixed length (zlib's never ends
    for ``a = 0``)."""
    p = 0
    for i in range(32):
        if a >> (31 - i) & 1:
            p ^= b
        b = (b >> 1) ^ POLY if b & 1 else b >> 1
    return p


@functools.lru_cache(maxsize=None)
def _x2n(k: int) -> int:
    """x^(2^k) mod P."""
    return 1 << 30 if k == 0 else multmodp(_x2n(k - 1), _x2n(k - 1))


def x8n(n: int) -> int:
    """x^(8n) mod P: the shift of a register over ``n`` bytes."""
    p, k = 1 << 31, 3
    while n:
        if n & 1:
            p = multmodp(_x2n(k), p)
        n >>= 1
        k += 1
    return p


@functools.lru_cache(maxsize=None)
def powers(segment: int) -> tuple:
    """``x^(8 · segment · 2^i) mod P`` for i < NPOWERS."""
    out = [x8n(segment)]
    for _ in range(NPOWERS - 1):
        out.append(multmodp(out[-1], out[-1]))
    return tuple(out)


@functools.lru_cache(maxsize=64)
def init_term(nbytes: int) -> int:
    """The preset's share of the CRC of ``nbytes`` bytes, xored with the
    final 0xFFFFFFFF: ``crc32 = raw ⊕ init_term(n)``."""
    return multmodp(x8n(nbytes), MASK) ^ MASK


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a buffer of ``nbytes`` is cut: ``blocks`` blocks of THREADS
    segments after ``pad`` virtual zero bytes; the combining block's
    ``threads`` (a power of two, 32..COMBINE_MAX) each fold ``chunk``
    (a power of two) consecutive block CRCs."""

    nbytes: int
    segment: int
    pad: int
    blocks: int
    threads: int
    chunk: int

    @property
    def log_threads(self) -> int:
        return self.threads.bit_length() - 1

    @property
    def log_chunk(self) -> int:
        return self.chunk.bit_length() - 1


def check_segment(segment: int) -> None:
    if segment % 128 or not 128 <= segment <= 1 << 16:
        raise ValueError(f"segment must be a multiple of 128 in [128, 65536], not {segment}")


def layout(nbytes: int, segment: int = SEGMENT) -> Layout:
    check_segment(segment)
    if nbytes <= 0:
        raise ValueError(f"an empty buffer has no layout (nbytes={nbytes})")
    segs = -(-nbytes // segment)
    blocks = -(-segs // THREADS)
    threads = max(32, min(COMBINE_MAX, _next_pow2(blocks)))
    chunk = _next_pow2(-(-blocks // threads))
    if LOG_THREADS + chunk.bit_length() - 1 + threads.bit_length() - 1 > NPOWERS:
        raise ValueError(f"{nbytes} bytes is beyond the kernel's {NPOWERS} powers")
    return Layout(nbytes, segment, blocks * THREADS * segment - nbytes, blocks,
                  threads, chunk)


# ---- the tables ---------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _slice8_list() -> tuple:
    t0 = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ POLY if c & 1 else c >> 1
        t0.append(c)
    tabs = [t0]
    for _ in range(7):
        prev = tabs[-1]
        tabs.append([(v >> 8) ^ t0[v & 0xFF] for v in prev])
    return tuple(tuple(t) for t in tabs)


@functools.lru_cache(maxsize=None)
def slice8_tables() -> torch.Tensor:
    """(8, 256) int64: table k advances a byte with k bytes after it in
    its 8-byte step (table 0 is zlib's byte table)."""
    return torch.tensor(_slice8_list(), dtype=torch.int64)


def _pair(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The 65,536-entry table of a 16-bit index: ``lo`` looks up its low
    byte, ``hi`` its high byte, and the two are xored."""
    return (hi[:, None] ^ lo[None, :]).reshape(-1)


@functools.lru_cache(maxsize=None)
def _step_tables(device: torch.device) -> tuple:
    """The slice-by-8 tables paired by the bytes of a step's two words:
    bytes 0-1 (tables 7, 6), 2-3 (5, 4), 4-5 (3, 2) and 6-7 (1, 0)."""
    t = slice8_tables().to(device)
    return tuple(_pair(t[7 - 2 * i], t[6 - 2 * i]) for i in range(4))


@functools.lru_cache(maxsize=32)
def _mult_tables(b: int, device: torch.device) -> tuple:
    """Multiplication by the constant ``b``: two 65,536-entry tables, for
    the low and the high 16 bits of the other factor."""
    basis = []   # b · x^i
    for _ in range(32):
        basis.append(b)
        b = (b >> 1) ^ POLY if b & 1 else b >> 1
    v = torch.arange(256, dtype=torch.int64)
    byte = []
    for j in range(4):         # byte j of a holds x^(31 - 8j - k) at its bit k
        t = torch.zeros(256, dtype=torch.int64)
        for k in range(8):
            t ^= ((v >> k) & 1) * basis[31 - 8 * j - k]
        byte.append(t.to(device))
    return _pair(byte[0], byte[1]), _pair(byte[2], byte[3])


def _mult(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a · b mod P`` for an int64 tensor of 32-bit values and a constant."""
    lo, hi = _mult_tables(b, a.device)
    return torch.take(lo, a & 0xFFFF) ^ torch.take(hi, a >> 16)


# ---- the plain version -----------------------------------------------------------

def fold_segments(rows: torch.Tensor) -> torch.Tensor:
    """The raw CRC of each row of a (K, S) uint8 tensor, S a multiple of 8,
    folded from a zero register 8 bytes a step with the slice-by-8 tables,
    all rows at once: the kernel's per-thread loop.  A step's second word
    does not meet the register, so its lookups are made for every step
    first; the tables are looked up 16 bits at a time (``_step_tables``)."""
    t01, t23, t45, t67 = _step_tables(rows.device)
    k, s = rows.shape
    words = rows.contiguous().view(torch.int32).to(torch.int64) & MASK   # little-endian
    first = words[:, 0::2].t().contiguous()
    second = words[:, 1::2]
    rest = (t45[second & 0xFFFF] ^ t67[second >> 16]).t().contiguous()
    crc = torch.zeros(k, dtype=torch.int64, device=rows.device)
    for j in range(s // 8):
        x = first[j] ^ crc
        crc = t01.index_select(0, x & 0xFFFF) ^ t23.index_select(0, x >> 16) ^ rest[j]
    return crc


def combine_tree(vals: torch.Tensor, pw: tuple, first: int) -> torch.Tensor:
    """Combine the last axis of ``vals`` (a power of two long) in a binary
    tree, in order: level ``l`` computes ``left · pw[first + l] ⊕ right``."""
    level = first
    while vals.shape[-1] > 1:
        vals = _mult(vals[..., 0::2], pw[level]) ^ vals[..., 1::2]
        level += 1
    return vals[..., 0]


def crc32_ref(t: torch.Tensor, segment: int = SEGMENT) -> int:
    """zlib's CRC-32 of the bytes of a contiguous tensor, computed as the
    kernel computes it (module docstring), on the tensor's device; bitwise
    ``zlib.crc32``."""
    data = t.detach().contiguous().reshape(-1).view(torch.uint8)
    n = int(data.numel())
    if n == 0:
        return 0
    dev = data.device
    lay = layout(n, segment)
    pw = powers(segment)
    rows = torch.cat((torch.zeros(lay.pad, dtype=torch.uint8, device=dev), data))
    raw = fold_segments(rows.view(lay.blocks * THREADS, segment))
    block_crc = combine_tree(raw.view(lay.blocks, THREADS), pw, 0)
    # the combining block: front padding to threads * chunk block CRCs
    front = torch.zeros(lay.threads * lay.chunk - lay.blocks, dtype=torch.int64, device=dev)
    vb = torch.cat((front, block_crc)).view(lay.threads, lay.chunk)
    acc = torch.zeros(lay.threads, dtype=torch.int64, device=dev)
    for j in range(lay.chunk):
        acc = _mult(acc, pw[LOG_THREADS]) ^ vb[:, j]
    raw_all = int(combine_tree(acc, pw, LOG_THREADS + lay.log_chunk))
    return raw_all ^ init_term(n)
