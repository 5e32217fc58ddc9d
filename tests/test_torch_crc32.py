"""The CRC-32 kernel's plain version (``repro_torch.kernels.crc32``) and the
tier's miss path that uses it, against zlib and the JAX package.

* ``crc32_ref`` — the kernel's own layout, slice-by-8 folds and ordered
  combine — is bitwise ``zlib.crc32`` at odd lengths, two seeds and two
  segment sizes, and on a packed shard equals ``shard_crc`` of both
  packages and the CRC the cut recorded;
* a lane-by-lane model of ``csrc/crc32.cu`` (unaligned heads, the
  warp-shuffle trees with their idle lanes, two blocks) gives zlib's CRC;
* every single-bit flip changes the CRC;
* the miss path runs no host CRC, checks each copy once, and under a
  global-``at`` bitflip and torn plan fires the reference's faults in
  the reference's order, with its counters and labels.
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import faultio as jfault  # noqa: E402
from repro.core import tier_graph as jtier  # noqa: E402
from repro.core import tiered as jtiered  # noqa: E402
from repro.core.algorithms import bfs as jbfs  # noqa: E402
from repro_torch.core import faultio as tfault  # noqa: E402
from repro_torch.core import tiered as ttiered  # noqa: E402
from repro_torch.core.algorithms import bfs as tbfs  # noqa: E402
from repro_torch.kernels.crc32 import ops as crc_ops  # noqa: E402
from repro_torch.kernels.crc32 import ref  # noqa: E402
from test_torch_tiered import graphs, same, stats_equal  # noqa: E402

LENGTHS = (0, 1, 3, 4, 5, 95, 96, 97, 4095, 4096, 4097, (1 << 20) + 13)


def random_bytes(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


@pytest.mark.parametrize("segment", [128, 1024])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n", LENGTHS)
def test_ref_is_zlib(n, seed, segment):
    a = random_bytes(n, seed)
    assert ref.crc32_ref(torch.from_numpy(a), segment) == zlib.crc32(a)


def test_layout_and_powers():
    """The layout the kernel launches with: the buffer ends a whole number
    of blocks of segments, the combining block is a power of two of 32 to
    1,024 threads whose chunks cover every block, and each power is the
    shift of its 2^i segments."""
    for n, segment in ((1, 128), (4097, 128), ((1 << 20) + 13, 1024),
                       (79_067_904, ref.SEGMENT), (1 << 34, 128)):
        lay = ref.layout(n, segment)
        assert (n + lay.pad) == lay.blocks * ref.THREADS * segment
        assert 0 <= lay.pad < ref.THREADS * segment
        assert lay.threads in [1 << k for k in range(5, 11)]
        assert lay.threads * lay.chunk >= lay.blocks
        assert lay.chunk == 1 or (lay.threads == ref.COMBINE_MAX
                                  and lay.threads * lay.chunk // 2 < lay.blocks)
    pw = ref.powers(256)
    assert [pw[i] for i in range(4)] == [ref.x8n(256 << i) for i in range(4)]
    with pytest.raises(ValueError):
        ref.layout(10, 100)
    # a shift over n bytes is zlib's: crc(A ‖ B) from crc(A), crc(B), |B|
    a, b = random_bytes(300, 2), random_bytes(77, 3)
    ca, cb = zlib.crc32(a), zlib.crc32(b)
    assert ref.multmodp(ca, ref.x8n(b.size)) ^ cb == zlib.crc32(np.concatenate([a, b]))


def test_packed_shard_matches_recorded_crcs():
    """One CRC over a packed shard buffer (src, dst, w's bits) is the chained
    ``shard_crc`` of both packages and the CRC the cut recorded, in both
    directions."""
    jg, g = graphs(seed=21, csc=True)
    tg = ttiered.tier_graph(g, nshards=4, resident_shards=2, build_csc=True)
    for bufs, host, recorded in ((tg._bufs, tg._host, tg.shard_crcs),
                                 (tg._csc_bufs, tg._csc_host, tg.in_shard_crcs)):
        for sid, buf in enumerate(bufs):
            got = ref.crc32_ref(buf)
            assert got == ttiered.shard_crc(*host[sid]) == jtiered.shard_crc(*host[sid])
            assert got == recorded[sid] == crc_ops.crc32(buf)
    jt = jtier(jg, nshards=4, resident_shards=2)
    assert list(jt.shard_crcs) == tg.shard_crcs


@pytest.mark.parametrize("seed", range(4))
def test_every_single_bit_flip_is_seen(seed):
    rng = np.random.default_rng(seed)
    a = random_bytes(3 * 4 * 1000, seed)
    clean = ref.crc32_ref(torch.from_numpy(a))
    for _ in range(4):
        b = a.copy()
        b[rng.integers(0, b.size)] ^= np.uint8(1 << int(rng.integers(0, 8)))
        got = ref.crc32_ref(torch.from_numpy(b))
        assert got != clean and got == zlib.crc32(b)


def test_wrapper_on_the_cpu_and_its_refusals():
    a = torch.from_numpy(random_bytes(999, 4))
    out = torch.zeros(1, dtype=torch.int32)
    before = crc_ops.crc32_async.launches
    crc_ops.crc32_async(a, out)
    assert int(out[0]) & ref.MASK == zlib.crc32(a.numpy()) == crc_ops.crc32(a)
    assert crc_ops.crc32_async.launches == before   # the plain version launches nothing
    with pytest.raises(ValueError, match="one contiguous int32 word"):
        crc_ops.crc32_async(a, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="cuda or cpu"):
        crc_ops.crc32_async(torch.empty(8, device="meta"), out)


# ---- a lane-by-lane model of csrc/crc32.cu --------------------------------------

def _model(buf, base, segment):
    """crc32.cu's two kernels on ``buf`` placed at address ``base`` (mod
    16): each thread's fold_range (bytes to a 16-byte boundary, vectors,
    bytes), warp_tree with __shfl_down_sync's idle lanes, the warps' tree,
    then the combining block's chunks and trees."""
    tab = [v for t in ref._slice8_list() for v in t]

    def step1(c, b):
        return tab[(c ^ b) & 255] ^ (c >> 8)

    def step8(c, w0, w1):
        x = w0 ^ c
        return (tab[7 * 256 + (x & 255)] ^ tab[6 * 256 + ((x >> 8) & 255)]
                ^ tab[5 * 256 + ((x >> 16) & 255)] ^ tab[4 * 256 + (x >> 24)]
                ^ tab[3 * 256 + (w1 & 255)] ^ tab[2 * 256 + ((w1 >> 8) & 255)]
                ^ tab[256 + ((w1 >> 16) & 255)] ^ tab[w1 >> 24])

    def fold_range(p, ln):
        c = 0
        while ln > 0 and (base + p) & 15:
            c, p, ln = step1(c, buf[p]), p + 1, ln - 1
        for _ in range(ln >> 4):
            w = [int.from_bytes(bytes(buf[p + 4 * k:p + 4 * k + 4]), "little") for k in range(4)]
            c, p, ln = step8(step8(c, w[0], w[1]), w[2], w[3]), p + 16, ln - 16
        while ln > 0:
            c, p, ln = step1(c, buf[p]), p + 1, ln - 1
        return c

    def warp_tree(lanes, first, levels):
        lanes = list(lanes) + [0] * (32 - len(lanes))
        for lv in range(levels):
            d = 1 << lv
            right = [lanes[i + d] if i + d < 32 else lanes[i] for i in range(32)]
            lanes = [ref.multmodp(lanes[i], pw[first + lv]) ^ right[i] for i in range(32)]
        return lanes[0]

    n = len(buf)
    lay, pw = ref.layout(n, segment), ref.powers(segment)
    block_crc = []
    for b in range(lay.blocks):
        seg = []
        for t in range(ref.THREADS):
            j = b * ref.THREADS + t
            hi, lo = (j + 1) * segment - lay.pad, max(j * segment - lay.pad, 0)
            seg.append(fold_range(lo, hi - lo) if hi > lo else 0)
        warps = [warp_tree(seg[32 * w:32 * w + 32], 0, 5) for w in range(ref.THREADS // 32)]
        block_crc.append(warp_tree(warps, 5, ref.LOG_THREADS - 5))
    front = lay.threads * lay.chunk - lay.blocks
    acc = []
    for t in range(lay.threads):
        c = 0
        for i in range(lay.chunk):
            bi = t * lay.chunk + i - front
            c = ref.multmodp(c, pw[ref.LOG_THREADS]) ^ (block_crc[bi] if bi >= 0 else 0)
        acc.append(c)
    first = ref.LOG_THREADS + lay.log_chunk
    warps = [warp_tree(acc[32 * w:32 * w + 32], first, 5) for w in range(lay.threads // 32)]
    top = warp_tree(warps, first + 5, (len(warps) - 1).bit_length()) if len(warps) > 1 \
        else warps[0]
    return top ^ ref.init_term(n)


@pytest.mark.parametrize("n, base, segment", [(97, 3, 128), (4097, 5, 256), (4800, 0, 128),
                                              (33_001, 7, 128)])
def test_kernel_model_is_zlib(n, base, segment):
    buf = [int(x) for x in random_bytes(n, n)]
    assert _model(buf, base, segment) == zlib.crc32(bytes(buf))


# ---- the miss path ------------------------------------------------------------------

def test_miss_path_checks_each_copy_once_and_no_host_crc(monkeypatch):
    """Each miss checks its uploaded copy once (the card's kernel launch;
    here the plain version) and never calls the host's ``shard_crc``."""
    _, g = graphs(seed=22)
    tg = ttiered.tier_graph(g, nshards=4, resident_shards=2)
    seen = []
    real = crc_ops.crc32

    def counted(t, *a, **k):
        seen.append(t.numel() * t.element_size())
        return real(t, *a, **k)

    def host_crc(*_):
        raise AssertionError("the miss path ran a host CRC")

    monkeypatch.setattr(crc_ops, "crc32", counted)
    monkeypatch.setattr(ttiered, "shard_crc", host_crc)
    _, st = tbfs.bfs_dd_sparse(tg, 0)
    assert st.shards_streamed > tg.resident_shards
    assert seen == [tg.shard_bytes] * st.shards_streamed


def test_fault_order_matches_reference_under_global_plan():
    """A bfs on a 4-shard cut at a pool of 2 under a plan of global ``at``
    bitflips, a torn read and an EIO: the port fires the reference's faults
    in the reference's order, with its checksum failures, retries, labels
    and every other counter."""
    jg, g = graphs(seed=23)

    def plan(m):
        return [m.bitflip("shard_read", at=1, times=1), m.torn("shard_read", at=4, times=1),
                m.eio("shard_read", at=6, times=1), m.bitflip("shard_read", at=9, times=2)]

    jt = jtier(jg, nshards=4, resident_shards=2)
    jt.set_fault_injector(jfault.FaultInjector(plan(jfault), seed=3))
    tg = ttiered.tier_graph(g, nshards=4, resident_shards=2)
    tg.set_fault_injector(tfault.FaultInjector(plan(tfault), seed=3))
    jdist, jst = jbfs.bfs_dd_sparse(jt, 0)
    dist, st = tbfs.bfs_dd_sparse(tg, 0)
    assert tg.fault.fired == jt.fault.fired
    assert tg.fault.fired_kinds() == {"bitflip": 3, "torn": 1, "eio": 1}
    assert (st.checksum_failures, st.io_retries) == (jst.checksum_failures,
                                                     jst.io_retries) == (4, 5)
    same(jdist, dist)
    stats_equal(jst, st)
