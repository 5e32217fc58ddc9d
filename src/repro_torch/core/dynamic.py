"""Dynamic graphs: a per-shard edge-log layer over the immutable tiered CSR,
as in ``repro.core.dynamic``.

* Every shard of the base cut has an append-only edge log (src, dst, w)
  of the inserts whose source lies in the shard's vertex range.
* A relax folds the log edges **after** the base shards, in ascending
  shard order, in the eager rounds and in a staged stretch alike, so the
  deterministic-add contract holds: the fold order is a function of the
  container's state, not of its insertion history or the pool size.
* ``compact()`` merges the logs into the canonical (src, dst)-sorted CSR
  and re-cuts it; the container is then bitwise a ``from_coo`` +
  ``tier_graph`` build of the merged edge list.

The logs are small and hot: they live on the device (each padded to the
next power of two, at least 8 slots, with the sentinel), and the I/O
ledger charges their edges as relax work, not as host-to-device traffic.
The dynamic out-degree is a device tensor too; a host copy serves each
batch's ``old_out_deg`` snapshot.

``apply_batch`` is insert-if-absent: self-loops are dropped, duplicates
within a batch keep the minimum weight (``from_coo``'s rule), and pairs
already in the base or a log are dropped.  Accepted edges append in
ascending (src, dst) order, so the logs do not depend on the batch's
order.

A staged stretch captures the log tensors by address, and
``engine.run_streamed`` frees its loops at the end of each run: no loop of
a ``DynamicGraph`` outlives an ``apply_batch`` or ``compact``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .engine import fetch
from .graph import Graph, from_coo
from .tiered import TieredGraph, _round_live, _shard_relax, _VertexTier, tier_graph


def _empty_log():
    return (np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.float32))


@dataclasses.dataclass(frozen=True, eq=False)
class DeltaBatch:
    """The edges one ``apply_batch`` call accepted, in canonical order."""

    src: np.ndarray
    dst: np.ndarray
    w: np.ndarray
    dirty: np.ndarray          # unique accepted source vertices
    old_out_deg: np.ndarray    # (n_pad,) int32 out-degree before the batch
    requested: int             # edges in the caller's batch (before filtering)

    @property
    def inserted(self) -> int:
        return int(self.src.size)


class StagedDynamic(_VertexTier):
    """A staged stretch's container: the staged base shards and the live
    shards' device logs.  A relax folds the base shards in ascending
    order, then the logs in ascending order, as the eager round does, so
    a stretch is bitwise equal to its eager rounds under deterministic
    add."""

    placement = "dynamic"
    has_csc = False

    def __init__(self, base, logs, out_deg, log_sids):
        self.base, self.logs, self.log_sids = base, logs, log_sids
        self.out_deg, self.owner, self.live = out_deg, base.owner, base.live
        self.n, self.m, self.n_pad = base.n, base.m, base.n_pad
        self.block_size, self.nshards, self.epd = (base.block_size, base.nshards,
                                                   base.epd)

    def tiered_push_dense(self, src_val, active, out_init, kind, use_weight,
                          substrate, reverse=False, det=False):
        acc = self.base.tiered_push_dense(src_val, active, out_init, kind,
                                          use_weight, substrate, reverse=reverse,
                                          det=det)
        for s, d, w in self.logs:
            acc = _shard_relax(s, d, w, src_val, active, acc, kind=kind,
                               use_weight=use_weight, sub=substrate, det=det,
                               reverse=False)
        return acc


class DynamicGraph(_VertexTier):
    """Mutable edge-log layer over a :class:`~.tiered.TieredGraph` base.

    It speaks the tier protocol the engine and the operator seam dispatch
    on (``is_tiered``, ``tiered_push_dense``, ``round_live``, ``stage``,
    ``charge_staged_rounds``, ``live_edges``, ``set_live_hint``), so every
    algorithm that runs on a ``TieredGraph`` runs on it unchanged; pulls
    need ``compact()`` first (the logs have no CSC mirror)."""

    placement = "dynamic"

    def __init__(self, base: TieredGraph):
        self.base = base
        self._reset_logs()
        self.m = base.m

    def _reset_logs(self) -> None:
        ns = self.base.nshards
        self._log = [_empty_log() for _ in range(ns)]
        # int64 (src * n_pad + dst) keys, kept sorted, for membership tests
        self._log_keys = [np.zeros(0, np.int64) for _ in range(ns)]
        self._base_keys = [None] * ns   # each shard's keys, built on first use
        self._log_dev = {}   # sid -> padded device triple
        self._lpd = 0        # the logs' common pad (a power of two)
        self._live_hint = None
        self._out_deg_np = self.base.out_deg.cpu().numpy().copy()
        self.out_deg = self.base.out_deg.clone()

    # ---- the base's geometry -------------------------------------------

    def __getattr__(self, name):
        if name in ("n", "n_pad", "block_size", "nshards", "epd", "vtx_bounds",
                    "owner", "io", "fault", "resident_shards", "shard_bytes",
                    "csr_bytes", "resident_budget", "shard_sizes"):
            return getattr(self.base, name)
        raise AttributeError(name)

    @property
    def has_csc(self) -> bool:
        return False   # the logs carry no CSC mirror: compact() first

    def set_fault_injector(self, fault) -> None:
        self.base.set_fault_injector(fault)

    @property
    def log_sizes(self):
        return [s.size for s, _, _ in self._log]

    # ---- membership ----------------------------------------------------

    def _base_key(self, sid: int) -> np.ndarray:
        cached = self._base_keys[sid]
        if cached is None:
            s, d, _ = self.base._host[sid]
            # padding rows are (sentinel, sentinel), the largest key, and
            # real rows are (src, dst)-sorted: the keys are sorted as cut
            cached = s.astype(np.int64) * np.int64(self.n_pad) + d.astype(np.int64)
            self._base_keys[sid] = cached
        return cached

    @staticmethod
    def _sorted_contains(haystack: np.ndarray, needles: np.ndarray) -> np.ndarray:
        if haystack.size == 0:
            return np.zeros(needles.shape, bool)
        pos = np.minimum(np.searchsorted(haystack, needles), haystack.size - 1)
        return haystack[pos] == needles

    def _present(self, key: np.ndarray, home: np.ndarray) -> np.ndarray:
        hit = np.zeros(key.shape, bool)
        for sid in np.unique(home):
            sel = home == sid
            k = key[sel]
            hit[sel] = (self._sorted_contains(self._base_key(int(sid)), k)
                        | self._sorted_contains(self._log_keys[int(sid)], k))
        return hit

    # ---- mutation ------------------------------------------------------

    def apply_batch(self, src, dst, w=None, *, symmetrize=False) -> DeltaBatch:
        """Insert a batch of edges; returns the accepted, canonical delta.
        With ``symmetrize=True`` both directions are inserted (cc's
        undirected contract)."""
        src = np.asarray(src, np.int64).reshape(-1)
        dst = np.asarray(dst, np.int64).reshape(-1)
        if src.shape != dst.shape:
            raise ValueError("src/dst shape mismatch")
        requested = int(src.size)
        if w is None:
            w = np.ones(src.shape, np.float32)
        else:
            w = np.asarray(w, np.float32).reshape(-1)
            if w.shape != src.shape:
                raise ValueError("w shape mismatch")
        if symmetrize:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
            w = np.concatenate([w, w])
        if src.size and (src.min() < 0 or src.max() >= self.n
                         or dst.min() < 0 or dst.max() >= self.n):
            raise ValueError(f"edge endpoints must lie in [0, {self.n})")
        old_out_deg = self._out_deg_np.copy()

        keep = src != dst
        src, dst, w = src[keep], dst[keep], w[keep]
        # in-batch dedup, the minimum weight per (src, dst): from_coo's rule
        key = src * np.int64(self.n_pad) + dst
        order = np.lexsort((w, key))
        key, src, dst, w = key[order], src[order], dst[order], w[order]
        _, first = np.unique(key, return_index=True)
        key, src, dst, w = key[first], src[first], dst[first], w[first]

        home = np.searchsorted(np.asarray(self.vtx_bounds), src, side="right") - 1
        if key.size:
            fresh = ~self._present(key, home)
            key, src, dst, w, home = (key[fresh], src[fresh], dst[fresh],
                                      w[fresh], home[fresh])

        for sid in np.unique(home):
            sel = home == sid
            sid = int(sid)
            ls, ld, lw = self._log[sid]
            self._log[sid] = (np.concatenate([ls, src[sel].astype(np.int32)]),
                              np.concatenate([ld, dst[sel].astype(np.int32)]),
                              np.concatenate([lw, w[sel]]))
            self._log_keys[sid] = np.sort(np.concatenate([self._log_keys[sid],
                                                          key[sel]]))
            self._log_dev.pop(sid, None)

        if src.size:
            np.add.at(self._out_deg_np, src, 1)
            idx = torch.from_numpy(src).to(self.device)
            self.out_deg = self.out_deg.index_add(
                0, idx, torch.ones(idx.shape, dtype=torch.int32, device=self.device))
            self.m += int(src.size)
        return DeltaBatch(src=src, dst=dst, w=w, dirty=np.unique(src),
                          old_out_deg=old_out_deg, requested=requested)

    # ---- the logs on the device ------------------------------------------

    def _log_pad(self) -> int:
        top = max(self.log_sizes, default=0)
        lpd = 8
        while lpd < top:
            lpd *= 2
        return lpd

    def _fetch_log(self, sid: int):
        """Shard ``sid``'s log on the device, padded to the logs' common
        power-of-two pad (sentinel indices, zero weights); the cache is
        cleared when the pad grows."""
        lpd = self._log_pad()
        if lpd != self._lpd:
            self._log_dev.clear()
            self._lpd = lpd
        cached = self._log_dev.get(sid)
        if cached is not None:
            return cached
        s, d, w = self._log[sid]
        pad = lpd - s.size
        sent = np.int32(self.sentinel)
        triple = tuple(torch.from_numpy(np.concatenate([x, np.full(pad, fill, x.dtype)]))
                       .to(self.device)
                       for x, fill in ((s, sent), (d, sent), (w, 0.0)))
        self._log_dev[sid] = triple
        return triple

    # ---- the tier protocol ------------------------------------------------

    def round_live(self, mask):
        # the dynamic out-degree: a shard whose only edges from an active
        # vertex lie in its log is live
        return _round_live(self.owner, self.out_deg, mask, self.nshards)

    def set_live_hint(self, live) -> None:
        self._live_hint = live

    def live_edges(self, live) -> int:
        ids = np.flatnonzero(np.asarray(live))
        logs = self.log_sizes
        return int(self.shard_sizes[ids].sum()) + sum(logs[i] for i in ids)

    def charge_staged_rounds(self, k: int, live) -> None:
        self.io.edges_relaxed += int(k) * self.live_edges(live)

    def stage(self, live):
        sb = self.base.stage(live)
        if sb is None:
            return None
        log_sids = tuple(s for s in sb.sids if self._log[s][0].size)
        return StagedDynamic(sb, tuple(self._fetch_log(s) for s in log_sids),
                             self.out_deg, log_sids)

    def tiered_push_dense(self, src_val, active, out_init, kind, use_weight,
                          substrate, reverse=False, det=False):
        """The base's masked push over the scheduled shards, then each
        scheduled shard's log, in ascending shard order."""
        hint, self._live_hint = self._live_hint, None
        if reverse:
            raise NotImplementedError(
                "DynamicGraph has no CSC mirror for the logs; compact() first")
        if hint is None:
            hint = fetch(self.round_live(active)[1])
        hint = np.asarray(hint, dtype=bool)
        self.base.set_live_hint(hint)
        acc = self.base.tiered_push_dense(src_val, active, out_init, kind,
                                          use_weight, substrate, det=det)
        logsched = [int(s) for s in np.flatnonzero(hint) if self._log[int(s)][0].size]
        self.io.edges_relaxed += sum(self._log[s][0].size for s in logsched)
        for sid in logsched:
            s, d, w = self._fetch_log(sid)
            acc = _shard_relax(s, d, w, src_val, active, acc, kind=kind,
                               use_weight=use_weight, sub=substrate, det=det,
                               reverse=False)
        return acc

    def tiered_pull_dense(self, *args, **kwargs):
        raise NotImplementedError(
            "pull needs a CSC mirror; the logs are push-only: compact() to "
            "fold them into the canonical store")

    # ---- compaction ------------------------------------------------------

    def compact(self) -> None:
        """Merge every log into the base CSR and re-cut it: the container
        is then bitwise a ``tier_graph`` of ``from_coo`` on the merged
        edge list, with empty logs."""
        base = self.base
        parts = []
        for sid in range(base.nshards):
            s, d, w = base._host[sid]
            k = int(base.shard_sizes[sid])
            parts.append((s[:k], d[:k], w[:k]))
            parts.append(self._log[sid])
        src, dst, w = (np.concatenate([p[i] for p in parts]) for i in range(3))
        g = from_coo(src.astype(np.int64), dst.astype(np.int64), self.n, weights=w,
                     block_size=self.block_size, build_csc=base.has_csc,
                     dedup=False, device=self.device)
        if g.m != self.m:
            raise AssertionError(f"compaction changed the edge count: {g.m} != {self.m}")
        new = tier_graph(g, base.nshards, base.resident_shards,
                         build_csc=base.has_csc)
        del g
        new.io, new.fault, new.retry = base.io, base.fault, base.retry
        self.base = new
        self._reset_logs()

    # ---- the store ---------------------------------------------------------

    def _restore_logs(self, host) -> None:
        """Install per-shard log triples loaded from a v3 store."""
        total = 0
        for sid, (s, d, w) in enumerate(host):
            s = np.asarray(s, np.int32)
            d = np.asarray(d, np.int32)
            w = np.asarray(w, np.float32)
            self._log[sid] = (s, d, w)
            self._log_keys[sid] = np.sort(
                s.astype(np.int64) * np.int64(self.n_pad) + d.astype(np.int64))
            if s.size:
                np.add.at(self._out_deg_np, s, 1)
                total += int(s.size)
        if total:
            self.out_deg = torch.from_numpy(self._out_deg_np.copy()).to(self.device)
            self.m += total
        self._log_dev = {}
        self._lpd = 0


def dynamize(g, nshards: int = 8, resident_shards=None, *, resident_bytes=None,
             build_csc: bool = False) -> DynamicGraph:
    """Wrap a ``Graph`` (cut here, on its device) or a ``TieredGraph`` in a
    :class:`DynamicGraph`.  An in-memory graph with no pool given is held
    fully resident."""
    if isinstance(g, TieredGraph):
        return DynamicGraph(g)
    if not isinstance(g, Graph):
        raise TypeError(f"cannot dynamize {type(g).__name__}")
    if resident_shards is None and resident_bytes is None:
        resident_shards = nshards
    return DynamicGraph(tier_graph(
        g, nshards, resident_shards if resident_shards is not None else 2,
        resident_bytes=resident_bytes, build_csc=build_csc))
