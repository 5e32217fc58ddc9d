"""Out-of-core tiered execution: host-resident edge shards streamed on demand.

The reference's ``repro.core.tiered`` on one CUDA card: the graph's CSR
does not have to fit in device memory.  HBM is the fast tier; the host's
memory (pinned, or mmap-backed views of the persistent store —
``checkpoint.save_graph`` / ``open_graph``) is the far one.

:class:`TieredGraph` keeps the O(m) edge arrays on the host, cut into
``nshards`` block-granular contiguous shards by ``graph.shard_ranges``,
each padded to one uniform ``epd`` slot count with the sentinel
``n_pad - 1`` (weight 0).  Only the O(n) vertex arrays (degrees, labels,
frontier masks) live on the device.  Edge shards stream into an LRU pool
of at most ``resident_shards`` device buffers:

* **Frontier-driven schedule** — a relax streams only the shards whose
  vertex range holds an active vertex with out-edges (``round_live``);
  the engine fetches that vector with the round's termination scalars in
  one transfer and hands it down as the schedule.
* **Double-buffered streaming** — each shard's relax is enqueued before
  the next scheduled shard is fetched, so the relax runs while that copy
  and its check are in flight: copies run on a dedicated copy stream,
  each followed by an event that the compute stream waits on just before
  that shard's relax.  In-memory shards (``tier_graph``) sit in
  pinned host memory and copy straight from it; store-backed shards
  (mmap views) are first read into a ring of two pinned staging buffers,
  each reused only after its last copy's event has completed.  A device
  buffer lives on the copy stream's allocations and is marked used by the
  compute stream (``record_stream``), so when the pool evicts it the
  allocator does not hand its memory to the next prefetch before the last
  relax that reads it has run.  Shards still resident from an earlier
  round are **buffer hits** and cost no bytes.
* **Integrity** — each shard's CRC32 (from the cut or the store's
  manifest) is re-derived on every miss, from the copy itself: on a CUDA
  device the ``crc32`` kernel (``kernels/crc32``) checks the device buffer
  on the copy stream right after its copy and the host waits for that one
  word, so no host CRC runs on the miss path; on the CPU ``crc32_ref``
  checks the uploaded clone.  A mismatch raises ``ShardCorruptError``
  inside the attempt, so the ``RetryPolicy`` re-reads and re-copies; an
  attempt that keeps failing after its budget raises out of the relax, a
  corrupt buffer is dropped, and only a copy that verified is relaxed.

Accounting: every miss streams exactly ``shard_bytes`` (the padded
src/dst/w triple, one copy), so ``h2d_bytes == shards_streamed *
shard_bytes``; ``buffer_hits`` counts scheduled shards already resident;
``edges_relaxed`` charges each scheduled shard's valid edge count
(``shard_sizes``), never its padded slots; ``io_wait_us`` is the host's
time in the miss path, which includes waiting for the copy and its CRC.

* **Staged stretches** (``stage`` + ``StagedShards`` +
  ``engine.run_streamed``) — a live shard set that fits the pool is
  staged once and consecutive rounds over it run as one device loop,
  exiting when the frontier dies or its live set changes.
* **Streamed CSC mirror** (``tier_graph(..., build_csc=True)``) — in-edge
  shards cut at the same vertex bounds and padded to the same ``epd``
  stream through the same pool under ``("csc", sid)`` keys, so
  ``pull_dense`` (and ``bfs_dirop``, ``pr_pull``) run out of core.

Every per-shard relax is the port's ``edge_relax`` kernel with a vertex
mask: the push case over a CSR shard, the pull case over a CSC shard
(``dst`` sorted) and over a reversed CSR shard (``reverse=True``: the
scatter lands on the shard's sorted sources).

Reduction order: scheduled shards fold into the accumulator in ascending
shard order, so labels are a pure function of the edge multiset and the
cut, never of the pool size or hit pattern.  ``min``/``max``/``or`` are
bitwise equal to the resident run; float ``add`` under deterministic add
is bitwise equal across every pool size and regime, and associates per
shard (allclose to the resident run).
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed.fault import RetryPolicy
from ..kernels import graph_ops as gk
from ..kernels.crc32 import ops as crc_ops
from .engine import fetch
from .faultio import FaultInjector, ShardCorruptError
from .graph import Graph, _device, round_up, shard_ranges


def shard_crc(src: np.ndarray, dst: np.ndarray, w: np.ndarray) -> int:
    """CRC32 of one padded shard's (src, dst, w) triple, chained over the
    three arrays in order — the checksum the store's manifest records (the
    reference's, byte for byte).  It equals the CRC of the packed shard
    buffer (src, dst, w's bits), which the miss path checks on the copy."""
    c = zlib.crc32(np.ascontiguousarray(src))
    c = zlib.crc32(np.ascontiguousarray(dst), c)
    return zlib.crc32(np.ascontiguousarray(w), c)


@dataclasses.dataclass
class StreamIO:
    """Cumulative streaming counters of one :class:`TieredGraph` (the
    engine folds per-run deltas into ``RunStats``)."""

    h2d_bytes: int = 0
    shards_streamed: int = 0
    buffer_hits: int = 0
    edges_relaxed: int = 0  # valid edges relaxed (padding never charged)
    # fault-tolerance ledger: reads retried, checksum mismatches seen, and
    # the wall time of the miss path (read, staging, the copy and its CRC
    # on the card, which the host waits for, and backoff)
    io_retries: int = 0
    checksum_failures: int = 0
    io_wait_us: int = 0

    def snapshot(self) -> Tuple[int, ...]:
        return (self.h2d_bytes, self.shards_streamed, self.buffer_hits,
                self.edges_relaxed, self.io_retries, self.checksum_failures,
                self.io_wait_us)

    def fold_delta(self, stats, before: Tuple[int, ...],
                   include_edges: bool = True) -> None:
        """Add the counters accumulated since ``before`` into a RunStats;
        ``include_edges=False`` leaves ``edges_touched`` to the algorithm's
        own work convention (bfs_dirop)."""
        stats.h2d_bytes += self.h2d_bytes - before[0]
        stats.shards_streamed += self.shards_streamed - before[1]
        stats.buffer_hits += self.buffer_hits - before[2]
        if include_edges:
            stats.edges_touched += self.edges_relaxed - before[3]
        stats.io_retries += self.io_retries - before[4]
        stats.checksum_failures += self.checksum_failures - before[5]
        stats.io_wait_us += self.io_wait_us - before[6]


def _shard_relax(src, dst, w, src_val, active, acc, *, kind, use_weight, sub,
                 det, reverse):
    """Relax one device-resident CSR shard into the running accumulator:
    the push case, or with ``reverse`` the pull case over the swapped pair
    (gather at dst, scatter into the shard's sorted sources)."""
    s, d = (dst, src) if reverse else (src, dst)
    if kind == "add" and det:
        return gk.det_push_ref(s, d, w, src_val, active, acc, use_weight)
    if sub == "cuda":
        return gk.edge_relax(s, d, w, active, src_val, acc, kind=kind,
                             use_weight=use_weight, vertex_mask=True,
                             case="pull" if reverse else "push")
    return gk.push_ref(s, d, w, src_val, active, acc, kind, use_weight)


def _shard_pull(nbr, dst, w, src_val, active, acc, *, kind, use_weight, sub,
                det):
    """Relax one device-resident CSC shard (in-edges, dst sorted, padded
    with the sentinel) into the running accumulator: the pull case."""
    if kind == "add" and det:
        return gk.det_push_ref(nbr, dst, w, src_val, active, acc, use_weight)
    if sub == "cuda":
        return gk.edge_relax(nbr, dst, w, active, src_val, acc, kind=kind,
                             use_weight=use_weight, vertex_mask=True,
                             case="pull")
    return gk.pull_ref(nbr, dst, w, src_val, active, acc, kind, use_weight)


def _round_live(owner, out_deg, mask, nshards: int):
    """Device-side ``(frontier_count, live_shard_mask)`` for one round:
    shard s is live iff an active vertex with out-edges lives in its
    range."""
    act = (mask & (out_deg > 0)).to(torch.int32)
    per = torch.zeros((nshards,), dtype=torch.int32, device=mask.device)
    per.index_add_(0, owner, act)
    return mask.sum(dtype=torch.int32), per > 0


def _views(buf: torch.Tensor, epd: int):
    """(src, dst, w) views of one packed shard buffer of 3·epd int32 words."""
    return buf[:epd], buf[epd:2 * epd], buf[2 * epd:].view(torch.float32)


def _host_views(buf: torch.Tensor, epd: int):
    """(src, dst, w) numpy views of one packed host shard buffer."""
    return tuple(v.numpy() for v in _views(buf, epd))


def _pack(src, dst, w, epd: int) -> torch.Tensor:
    """One host shard buffer: src, dst and w's bits, 3·epd int32 words."""
    t = torch.empty((3 * epd,), dtype=torch.int32)
    a = t.numpy()
    a[:epd] = src
    a[epd:2 * epd] = dst
    a[2 * epd:] = np.ascontiguousarray(w, dtype=np.float32).view(np.int32)
    return t


class _VertexTier:
    """The Graph-compatible vertex surface shared by TieredGraph and
    StagedShards."""

    is_tiered = True
    ndev = 1
    placement = "tiered"

    @property
    def sentinel(self) -> int:
        return self.n_pad - 1

    @property
    def m_pad(self) -> int:
        return self.nshards * self.epd

    @property
    def device(self) -> torch.device:
        return self.out_deg.device

    def vertex_full(self, fill, dtype) -> torch.Tensor:
        return torch.full((self.n_pad,), fill, dtype=dtype, device=self.device)

    def valid_vertex_mask(self) -> torch.Tensor:
        return torch.arange(self.n_pad, device=self.device) < self.n

    def budget_edge_mass(self, mask: torch.Tensor) -> torch.Tensor:
        return torch.where(mask, self.out_deg, 0).sum(dtype=torch.int32)

    def round_live(self, mask: torch.Tensor):
        """``(count, live)`` device tensors for one round (``_round_live``)."""
        return _round_live(self.owner, self.out_deg, mask, self.nshards)


class StagedShards(_VertexTier):
    """A staged live shard set: its device buffers (ascending shard order,
    copies complete on the compute stream), the live fingerprint the
    stretch's exit predicate compares against (``frontier.live_stable``),
    and the vertex arrays.  It quacks like the graph for the vertex surface
    and for ``push_dense`` / ``sparse_round``, but every relax is pure
    device work — no pool walk, no fetch — so a device loop can run
    consecutive rounds over it.  Relaxes fold the staged shards in
    ascending order, the eager streamed round's order over the same set."""

    has_csc = False

    def __init__(self, *, shards, live, out_deg, owner, n, m, n_pad,
                 block_size, nshards, epd, sids):
        self.shards = shards
        self.live = live
        self.out_deg, self.owner = out_deg, owner
        self.n, self.m, self.n_pad = n, m, n_pad
        self.block_size, self.nshards, self.epd = block_size, nshards, epd
        self.sids = sids

    def tiered_push_dense(self, src_val, active, out_init, kind, use_weight,
                          substrate, reverse=False, det=False):
        """Masked push over the staged shards.  The stretch's exit predicate
        keeps the mask's live set equal to the staged set for every round
        that runs, so these are exactly the scheduled shards."""
        if reverse:
            raise NotImplementedError(
                "staged stretches are forward-only; reversed pushes "
                "schedule every shard and stay on the eager streamed path")
        acc = out_init
        for s, d, w in self.shards:
            acc = _shard_relax(s, d, w, src_val, active, acc, kind=kind,
                               use_weight=use_weight, sub=substrate, det=det,
                               reverse=False)
        return acc


class TieredGraph(_VertexTier):
    """Host-resident sharded CSR behind a bounded pool of device buffers.

    ``host_shards`` (and ``csc_host``) hold one entry per shard: a packed
    host tensor of 3·epd int32 words (``tier_graph``'s pinned cut) or an
    ``(src, dst, w)`` numpy triple (the store's mmap views).  ``_host``
    exposes every shard as a numpy triple either way.  Quacks like
    :class:`~repro_torch.core.graph.Graph` for the vertex surface and
    dispatches edge relaxation through ``tiered_push_dense`` /
    ``tiered_pull_dense`` (``core.operators`` routes ``push_dense``,
    ``pull_dense`` and ``sparse_round`` here)."""

    def __init__(
        self,
        *,
        n: int,
        m: int,
        n_pad: int,
        block_size: int,
        nshards: int,
        epd: int,
        vtx_bounds: np.ndarray,
        shard_sizes: np.ndarray,
        host_shards: Sequence,
        out_deg: np.ndarray,
        resident_shards: int,
        shard_crcs: Optional[Sequence[int]] = None,
        verify_checksums: bool = True,
        csc_host: Optional[Sequence] = None,
        in_shard_sizes: Optional[np.ndarray] = None,
        in_shard_crcs: Optional[Sequence[int]] = None,
        in_deg: Optional[np.ndarray] = None,
        verified: bool = True,
        device=None,
    ):
        if resident_shards < 2:
            raise ValueError(
                "resident_shards must be >= 2: double-buffered streaming "
                "needs a relax buffer and a prefetch buffer")
        if len(host_shards) != nshards:
            raise ValueError(f"{len(host_shards)} host shards for nshards={nshards}")
        dev = _device(device)
        self.n, self.m = int(n), int(m)
        self.n_pad, self.block_size = int(n_pad), int(block_size)
        self.nshards, self.epd = int(nshards), int(epd)
        self.resident_shards = min(int(resident_shards), self.nshards)
        self.vtx_bounds = np.asarray(vtx_bounds, np.int64)
        self.shard_sizes = np.asarray(shard_sizes, np.int64)
        self._host, self._bufs = self._entries(host_shards)
        self.shard_crcs = (None if shard_crcs is None
                           else [int(c) for c in shard_crcs])
        self.verify_checksums = bool(verify_checksums)
        # False for checksum-less (v1) stores and verify="off" opens
        self.verified = bool(verified) and self.shard_crcs is not None
        self._csc_host = self._csc_bufs = None
        if csc_host is not None:
            if len(csc_host) != nshards or in_shard_sizes is None or in_deg is None:
                raise ValueError("a CSC mirror needs nshards shards, "
                                 "in_shard_sizes and in_deg")
            self._csc_host, self._csc_bufs = self._entries(csc_host)
        self.in_shard_sizes = (None if in_shard_sizes is None
                               else np.asarray(in_shard_sizes, np.int64))
        self.in_shard_crcs = (None if in_shard_crcs is None
                              else [int(c) for c in in_shard_crcs])
        self.in_deg = (None if in_deg is None else torch.from_numpy(
            np.array(in_deg, dtype=np.int32)).to(dev))
        self.retry = RetryPolicy(max_retries=2, base_delay_s=0.01,
                                 retryable=(OSError, ShardCorruptError))
        self.fault: Optional[FaultInjector] = None
        # vertex tier: O(n) arrays stay on the device for the whole run
        self.out_deg = torch.from_numpy(np.array(out_deg, dtype=np.int32)).to(dev)
        owner = np.searchsorted(self.vtx_bounds, np.arange(n_pad), side="right") - 1
        self.owner = torch.from_numpy(
            np.clip(owner, 0, nshards - 1).astype(np.int64)).to(dev)
        # one LRU pool for both directions, keys ("csr"|"csc", sid)
        self._pool: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._live_hint: Optional[np.ndarray] = None
        self.io = StreamIO()
        self._copy_stream = None
        self._staging = [None, None]      # pinned ring for store-backed shards
        self._staging_events = [None, None]
        self._staging_next = 0
        self._verdict = None               # pinned word the CRC kernel writes

    def _entries(self, shards):
        triples, bufs = [], []
        for item in shards:
            if isinstance(item, torch.Tensor):
                triples.append(_host_views(item, self.epd))
                bufs.append(item)
            else:
                triples.append(tuple(item))
                bufs.append(None)
        return triples, bufs

    # ---- Graph-compatible surface -------------------------------------
    @property
    def has_csc(self) -> bool:
        return self._csc_host is not None

    @property
    def shard_bytes(self) -> int:
        """Bytes of one shard's device buffer (padded src/dst/w) — the exact
        per-miss H2D cost."""
        return self.epd * (4 + 4 + 4)

    @property
    def csr_bytes(self) -> int:
        """Total streamable CSR bytes (all shards)."""
        return self.nshards * self.shard_bytes

    @property
    def resident_budget(self) -> int:
        """Device bytes the buffer pool may occupy."""
        return self.resident_shards * self.shard_bytes

    # ---- streaming core ------------------------------------------------
    def set_live_hint(self, live: np.ndarray) -> None:
        """Provide the next relax's shard schedule (a host bool vector of
        length ``nshards``); consumed by exactly one ``tiered_push_dense``."""
        self._live_hint = np.asarray(live)

    def set_fault_injector(self, fault: Optional[FaultInjector]) -> None:
        """Attach a :class:`core.faultio.FaultInjector` whose plan fires on
        this graph's ``shard_read`` site (and, through ``run_streamed``,
        its ``round`` site).  ``None`` detaches."""
        self.fault = fault

    def _read_shard(self, sid: int, direction: str = "csr"):
        """One read of shard ``sid``'s host arrays, through the fault
        injector (which may raise, or return corrupted copies).  CSC shards
        tick the ``shard_read`` site under the key ``nshards + sid``."""
        csc = direction == "csc"
        s, d, w = (self._csc_host if csc else self._host)[sid]
        if self.fault is not None:
            s, d, w = self.fault.shard_read(self.nshards + sid if csc
                                            else sid, s, d, w)
        return s, d, w

    def _verify(self, sid: int, direction: str, buf) -> None:
        """Check an uploaded shard buffer against its recorded CRC: on the
        card the ``crc32`` kernel runs on the copy stream after the copy
        and the host waits for its word; on the CPU ``crc32_ref``.  A
        mismatch counts a checksum failure and raises ShardCorruptError."""
        crcs = self.in_shard_crcs if direction == "csc" else self.shard_crcs
        if not self.verify_checksums or crcs is None:
            return
        data, _ = buf
        if data.device.type == "cuda":
            if self._verdict is None:
                self._verdict = torch.empty((1,), dtype=torch.int32, pin_memory=True)
            done = torch.cuda.Event()
            crc_ops.crc32_async(data, self._verdict, self._copy_stream)
            done.record(self._copy_stream)
            done.synchronize()
            got = int(self._verdict[0]) & 0xFFFFFFFF
        else:
            got = crc_ops.crc32(data)
        want = crcs[sid]
        if got != want:
            self.io.checksum_failures += 1
            raise ShardCorruptError(
                f"{direction} shard {sid}: crc32 {got:#010x} != recorded "
                f"{want:#010x} — bit-rot, a torn write, or a store "
                "mixed from two cuts; rebuild with save_graph")

    def _attempt(self, sid: int, direction: str):
        """One attempt of a miss, in the reference's order: read (the fault
        injector ticks), copy to the device, check the copy's CRC."""
        buf = self._upload(sid, direction, *self._read_shard(sid, direction))
        self._verify(sid, direction, buf)
        return buf

    def _staging_buffer(self) -> int:
        """The next slot of the pinned staging ring, once its last copy has
        completed."""
        i = self._staging_next
        self._staging_next ^= 1
        if self._staging[i] is None:
            self._staging[i] = torch.empty((3 * self.epd,), dtype=torch.int32,
                                           pin_memory=True)
        elif self._staging_events[i] is not None:
            self._staging_events[i].synchronize()
        return i

    def _upload(self, sid: int, direction: str, s, d, w):
        """Start the copy of one shard read to the device; returns
        ``(buffer, event)`` (no event on the CPU)."""
        csc = direction == "csc"
        host = (self._csc_bufs if csc else self._bufs)[sid]
        if host is not None and s is not (self._csc_host if csc else self._host)[sid][0]:
            host = None   # an injected fault returned copies: stage those
        if self.device.type != "cuda":
            return (host.clone() if host is not None
                    else _pack(s, d, w, self.epd)), None
        slot = None
        if host is None:
            slot = self._staging_buffer()
            host = self._staging[slot]
            a = host.numpy()
            a[:self.epd] = s
            a[self.epd:2 * self.epd] = d
            a[2 * self.epd:] = np.ascontiguousarray(w, dtype=np.float32).view(np.int32)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.device)
        with torch.cuda.stream(self._copy_stream):
            buf = torch.empty((3 * self.epd,), dtype=torch.int32, device=self.device)
            buf.copy_(host, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        if slot is not None:
            self._staging_events[slot] = event
        return buf, event

    def _fetch(self, sid: int, direction: str = "csr"):
        """Device buffer of shard ``sid`` as ``(buffer, copy event)``; a pool
        hit costs no bytes, a miss streams the shard, evicting LRU shards
        beyond the pool budget.  Every scheduled shard passes through here
        exactly once per relax, so ``buffer_hits + shards_streamed`` equals
        the shards scheduled.  The miss path is the recovery boundary: each
        attempt (read, copy, the copy's CRC check) runs under ``self.retry``
        (``io_retries`` counts the re-reads), and one successful miss
        charges exactly one ``shard_bytes`` however many attempts it
        took."""
        pool = self._pool
        key = (direction, sid)
        if key in pool:
            pool.move_to_end(key)
            self.io.buffer_hits += 1
            return pool[key]
        t0 = time.perf_counter()
        while len(pool) >= self.resident_shards:
            pool.popitem(last=False)

        def count_retry(attempt, delay_s, exc):
            self.io.io_retries += 1

        try:
            buf = self.retry.run(self._attempt, sid, direction, on_retry=count_retry)
        finally:
            self.io.io_wait_us += int((time.perf_counter() - t0) * 1e6)
        pool[key] = buf
        self.io.shards_streamed += 1
        self.io.h2d_bytes += self.shard_bytes
        return buf

    def _ready(self, buf):
        """The (src, dst, w) views of a fetched buffer, after the compute
        stream has been made to wait for its copy and marked as its user."""
        data, event = buf
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            data.record_stream(stream)
        return _views(data, self.epd)

    def _schedule(self, active) -> list[int]:
        """Shard schedule for a forward masked push: the live hint when the
        engine fetched it with the round's scalars, else fetched here."""
        hint, self._live_hint = self._live_hint, None
        if hint is None:
            hint = fetch(self.round_live(active)[1])
        return [int(x) for x in np.flatnonzero(np.asarray(hint, dtype=bool))]

    def tiered_push_dense(self, src_val, active, out_init, kind, use_weight,
                          substrate, reverse=False, det=False):
        """Masked push over the streamed shards (``operators.push_dense``'s
        target; ``sparse_round`` lowers here too — the schedule already is
        the frontier's shard set).  Scheduled shards fold in ascending
        order; each relax is enqueued before the next shard's fetch, so it
        runs while that copy and its check are in flight.  ``reverse=True``
        (bc's backward sweep) activates on destinations, which any shard
        may hold, so it schedules every shard."""
        if reverse:
            self._live_hint = None
            sched = list(range(self.nshards))
        else:
            sched = self._schedule(active)
        self.io.edges_relaxed += int(self.shard_sizes[sched].sum())
        acc = out_init
        if not sched:
            return acc
        cur = self._fetch(sched[0])
        for i in range(len(sched)):
            s, d, w = self._ready(cur)
            acc = _shard_relax(s, d, w, src_val, active, acc, kind=kind,
                               use_weight=use_weight, sub=substrate, det=det,
                               reverse=reverse)
            if i + 1 < len(sched):
                cur = self._fetch(sched[i + 1])  # overlaps the relax
        return acc

    def tiered_pull_dense(self, src_val, active, out_init, kind, use_weight,
                          substrate, det=False):
        """Pull-style relax streamed through the CSC mirror
        (``operators.pull_dense``'s target): every destination reduces over
        its in-neighbours, so all CSC shards stream in ascending order
        through the same pool and accounting (keys ("csc", sid))."""
        if not self.has_csc:
            raise NotImplementedError(
                "this tiered graph has no CSC mirror; rebuild with "
                "tier_graph(..., build_csc=True) (or save_graph from a "
                "graph built with from_coo(..., build_csc=True))")
        self.io.edges_relaxed += int(self.in_shard_sizes.sum())
        acc = out_init
        cur = self._fetch(0, "csc")
        for sid in range(self.nshards):
            s, d, w = self._ready(cur)
            acc = _shard_pull(s, d, w, src_val, active, acc, kind=kind,
                              use_weight=use_weight, sub=substrate, det=det)
            if sid + 1 < self.nshards:
                cur = self._fetch(sid + 1, "csc")  # overlaps the relax
        return acc

    # ---- staged stretch support (engine.run_streamed) ------------------
    def live_edges(self, live: np.ndarray) -> int:
        """Valid edges one round over ``live``'s shard set relaxes."""
        return int(self.shard_sizes[np.flatnonzero(live)].sum())

    def charge_staged_rounds(self, k: int, live: np.ndarray) -> None:
        """Account ``k`` staged rounds over ``live``: what ``k`` eager rounds
        over the same schedule charge (``stage`` fetched the buffers once,
        through ``_fetch``'s counters)."""
        self.io.edges_relaxed += int(k) * self.live_edges(live)

    def stage(self, live: np.ndarray) -> Optional[StagedShards]:
        """Stage ``live``'s shard set for a device loop, or ``None`` when the
        frontier is dead or the set outgrows the pool (those rounds run
        eager).  Fetches go through ``_fetch`` in ascending order, so the
        pool and its counters after staging are what the first eager round
        over this schedule would have left."""
        sids = [int(s) for s in np.flatnonzero(live)]
        if not sids or len(sids) > self.resident_shards:
            return None
        bufs = [self._fetch(s) for s in sids]
        return StagedShards(
            shards=[self._ready(b) for b in bufs],
            live=torch.from_numpy(np.asarray(live, bool)).to(self.device),
            out_deg=self.out_deg, owner=self.owner,
            n=self.n, m=self.m, n_pad=self.n_pad,
            block_size=self.block_size, nshards=self.nshards, epd=self.epd,
            sids=tuple(sids))


def _pad_cut(src, dst, w, bounds, epd: int, sent: int, pin: bool):
    """The contiguous edge slices at ``bounds``, each packed into one host
    buffer of ``epd`` slots (sentinel on index padding, 0 weight)."""
    shards = []
    for s in range(len(bounds) - 1):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        t = torch.empty((3 * epd,), dtype=torch.int32, pin_memory=pin)
        a = t.numpy()
        a[:2 * epd] = sent
        a[2 * epd:] = 0
        a[: hi - lo] = src[lo:hi]
        a[epd:epd + hi - lo] = dst[lo:hi]
        a[2 * epd:2 * epd + hi - lo] = w[lo:hi].view(np.int32)
        shards.append(t)
    return shards


def tier_graph(
    g: Graph,
    nshards: int,
    resident_shards: int = 2,
    *,
    resident_bytes: Optional[int] = None,
    build_csc: bool = False,
    device=None,
) -> TieredGraph:
    """Cut an in-memory ``Graph`` into a :class:`TieredGraph`.

    ``nshards`` block-granular contiguous shards (``graph.shard_ranges``),
    each padded to one uniform ``epd`` slot count; ``resident_shards`` (or
    a byte budget via ``resident_bytes``, floored at the 2 double buffering
    needs) bounds the device pool.  The host shard copies — pinned when the
    vertex tier lives on a CUDA device — are the only edge storage of the
    result.  ``device`` is that of the vertex tier (``g``'s by default).

    ``build_csc=True`` also cuts the CSC mirror (``from_coo(...,
    build_csc=True)``) into in-edge shards at the same vertex bounds; both
    directions share one ``epd`` (the larger cut's), so ``shard_bytes``
    stays uniform.
    """
    dev = g.device if device is None else torch.device(device)
    vtx, eb = shard_ranges(g, nshards)
    sizes = np.diff(eb)
    epd = round_up(max(int(sizes.max()), 1), 8)
    in_sizes = ieb = None
    if build_csc:
        if not g.has_csc:
            raise ValueError(
                "build_csc=True needs the source graph's CSC mirror; "
                "build it with from_coo(..., build_csc=True)")
        ieb = g.in_row_ptr.cpu().numpy()[vtx].astype(np.int64)
        in_sizes = np.diff(ieb)
        epd = round_up(max(epd, int(in_sizes.max()), 1), 8)
    if resident_bytes is not None:
        resident_shards = max(2, int(resident_bytes) // (epd * 12))
    sent = g.n_pad - 1
    pin = dev.type == "cuda"

    def host(t):
        return t.cpu().numpy()

    shards = _pad_cut(host(g.src_idx), host(g.col_idx), host(g.edge_w), eb,
                      epd, sent, pin)
    csc_kw = {}
    if build_csc:
        cscs = _pad_cut(host(g.in_col_idx), host(g.in_src_idx),
                        host(g.in_edge_w), ieb, epd, sent, pin)
        csc_kw = dict(csc_host=cscs, in_shard_sizes=in_sizes,
                      in_shard_crcs=[shard_crc(*_host_views(t, epd)) for t in cscs],
                      in_deg=host(g.in_deg))
    return TieredGraph(
        n=g.n, m=g.m, n_pad=g.n_pad, block_size=g.block_size,
        nshards=nshards, epd=epd, vtx_bounds=vtx, shard_sizes=sizes,
        host_shards=shards, out_deg=host(g.out_deg),
        resident_shards=resident_shards,
        shard_crcs=[shard_crc(*_host_views(t, epd)) for t in shards],
        device=dev, **csc_kw,
    )
