"""CPU models of the Hopper designs of edge_relax and advance, held to the
plain versions and to the JAX package.

The CUDA kernels in ``src/repro_torch/kernels/graph_ops/csrc/graph_ops.cu``
run only on the card.  These models follow their decompositions step for
step, on the CPU, so that the decompositions themselves are checked here:

* ``relax_model``: edge_relax's warp tiles of 32 and 128 slots in both
  layouts — four rows of 32 consecutive slots (push, relax_edges,
  relax_batch) and four consecutive slots a lane after a first group of
  ``head`` slots up to a 16-B boundary (pull) — with the mask read before dst
  and w, the clamp flag from the seeds, and, where a tile holds two
  adjacent slots with one dst, the segmented reduction (runs combined in
  a lane, carried across lanes by a shuffle scan and across rows from
  lane 31, one message per run).
* ``advance_model``: advance's single-pass scan with decoupled look-back
  (tiles publish their sums, then look back ``window`` predecessors at a
  time until one holds its prefix; tiles at or past live do nothing) and
  its expansion by blocks of output slots (a 32-ary search for the entries
  that cover a block, those entries staged up to ``stage``, else a search
  per slot; each thread searches its first slot and walks to the next
  three).

Both are held to ``repro_torch.kernels.graph_ops.ref`` and to the JAX
package's ``repro.kernels.graph_ops`` on the same numpy inputs: bitwise,
but for float add, which sums in another order and must lie within
1e-5 of the sum of its terms' magnitudes (``chip_smoke.py``'s
ADD_RTOL_OF_ABS_SUM).  A mutated model of each (a run's carry dropped at
a lane or row edge; the search's side="left") must fail, which shows that
the cases can see such a fault.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import frontier as jfr  # noqa: E402
from repro.core.graph import from_coo as jfrom_coo  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.kernels import graph_ops as jgk  # noqa: E402
from repro_torch.kernels.graph_ops import ref as tref  # noqa: E402

LANES = 32
ADD_RTOL_OF_ABS_SUM = 1e-5
FLT_MAX = np.float32(np.finfo(np.float32).max)


def _key(x) -> int:
    """The ordered-int key of a float32 (-0.0 < +0.0)."""
    b = int(np.float32(x).view(np.int32))
    return b if b >= 0 else b ^ 0x7FFFFFFF


def _wrap32(x: int) -> np.int32:
    return np.int32(((x + 2**31) % 2**32) - 2**31)


class Reducer:
    """The kernel's Reducer<T, K>: neutral, combine, changes, beyond."""

    def __init__(self, kind: str, dtype):
        self.kind = kind
        self.f32 = dtype == np.float32
        self.clamp = self.f32 and kind in ("min", "max")
        self.read_first = kind != "add"
        if kind in ("add", "or"):
            self.neutral = dtype.type(0) if hasattr(dtype, "type") else dtype(0)
        elif self.f32:
            self.neutral = FLT_MAX if kind == "min" else -FLT_MAX
        else:
            info = np.iinfo(np.int32)
            self.neutral = np.int32(info.max if kind == "min" else info.min)

    def key(self, x):
        return _key(x) if self.f32 else int(x)

    def combine(self, a, b):
        if self.kind == "min":
            return b if self.key(b) < self.key(a) else a
        if self.kind in ("max", "or"):
            return b if self.key(b) > self.key(a) else a
        if self.f32:
            return np.float32(a + b)
        return _wrap32(int(a) + int(b))

    def changes(self, msg, cur) -> bool:
        if self.kind == "min":
            return self.key(msg) < self.key(cur)
        if self.kind in ("max", "or"):
            return self.key(msg) > self.key(cur)
        return True

    def beyond(self, x) -> bool:
        if not self.clamp:
            return False
        return _key(x) > _key(FLT_MAX) if self.kind == "min" else _key(x) < _key(-FLT_MAX)


def _message(v, w, kind, use_weight):
    if not use_weight:
        return v
    return np.float32(v + w) if kind in ("min", "max") else np.float32(v * w)


def _send(R, out, sends):
    """Reads of out, then atomics: sequential here, and order-free for
    min/max/or/int add, so any order gives the kernel's result."""
    for d, msg in sends:
        if not R.read_first or R.changes(msg, out[d]):
            out[d] = R.combine(out[d], msg)


def _shfl_up(xs, off):
    return [xs[lane - off] if lane >= off else xs[lane] for lane in range(LANES)]


def _send_runs(R, D, H, M, drop_carry=False):
    """The kernel's send_runs over one warp tile: returns the (dst, msg)
    pairs it sends."""
    S = len(D[0])
    start = [[i == 0 or D[ln][i] != D[ln][i - 1] for i in range(S)] for ln in range(LANES)]
    th, tv, full = [], [], []
    for ln in range(LANES):
        h, v, f = False, R.neutral, True
        for i in range(S):
            if start[ln][i] and i > 0:
                h, f = False, False
            if H[ln][i]:
                v = R.combine(v, M[ln][i]) if h else M[ln][i]
                h = True
        th.append(h)
        tv.append(v)
        full.append(f)
    cont = [ln > 0 and D[ln][0] == D[ln - 1][S - 1] for ln in range(LANES)]
    cont_next = [ln < LANES - 1 and cont[ln + 1] for ln in range(LANES)]
    seg = [not (full[ln] and cont[ln]) for ln in range(LANES)]
    sh, sv = th[:], tv[:]
    off = 1
    while off < LANES:
        yh, yv, yseg = _shfl_up(sh, off), _shfl_up(sv, off), _shfl_up(seg, off)
        for ln in range(LANES):
            if ln >= off and not seg[ln]:
                if yh[ln]:
                    sv[ln] = R.combine(yv[ln], sv[ln]) if sh[ln] else yv[ln]
                sh[ln] = sh[ln] or yh[ln]
                seg[ln] = yseg[ln]
        off *= 2
    ph = [a and c for a, c in zip(_shfl_up(sh, 1), cont)]
    pv = _shfl_up(sv, 1)
    if drop_carry:
        ph = [False] * LANES
    sends = []
    for ln in range(LANES):
        rh, rv, first = False, R.neutral, True
        for i in range(S):
            if start[ln][i]:
                rh = False
            if H[ln][i]:
                rv = R.combine(rv, M[ln][i]) if rh else M[ln][i]
                rh = True
            if not (i == S - 1 or start[ln][i + 1]):
                continue
            h, v = rh, rv
            if first and ph[ln]:
                v = R.combine(pv[ln], v) if h else pv[ln]
                h = True
            if i == S - 1 and cont_next[ln]:
                h = False
            first = False
            if h:
                sends.append((D[ln][i], v))
    return sends


def _send_runs_rows(R, D, H, M, drop_carry=False):
    """The kernel's send_runs_rows over one striped tile (row i holds slots
    32 i + lane): a segmented scan per row, the run at lane 31 carried into
    the next row."""
    rows = len(D)
    cd, ch, cv = -2, False, R.neutral
    sends = []
    for i in range(rows):
        d = D[i]
        up = _shfl_up(d, 1)
        head = [d[ln] != (up[ln] if ln > 0 else cd) for ln in range(LANES)]
        f, sh, sv = head[:], H[i][:], M[i][:]
        off = 1
        while off < LANES:
            yh, yv, yf = _shfl_up(sh, off), _shfl_up(sv, off), _shfl_up(f, off)
            for ln in range(LANES):
                if ln >= off and not f[ln]:
                    if yh[ln]:
                        sv[ln] = R.combine(yv[ln], sv[ln]) if sh[ln] else yv[ln]
                    sh[ln] = sh[ln] or yh[ln]
                    f[ln] = yf[ln]
            off *= 2
        for ln in range(LANES):
            if ch and not drop_carry and not any(head[: ln + 1]):
                sv[ln] = R.combine(cv, sv[ln]) if sh[ln] else cv
                sh[ln] = True
        for ln in range(LANES):
            nxt = d[ln + 1] if ln < LANES - 1 else (D[i + 1][0] if i < rows - 1 else -3)
            if sh[ln] and d[ln] != nxt:
                sends.append((d[ln], sv[ln]))
        cd, ch, cv = d[-1], sh[-1], sv[-1]
    return sends


def _relax_rows(R, out, src, dst, w, mask, src_val, kind, use_weight, vertex_mask,
                clamp, rows, drop_carry):
    """edge_relax's rows layout: a warp's tile is ``rows`` rows of 32
    consecutive slots; dst and w are read per slot that sends."""
    m = len(src)
    tile_n = LANES * rows
    for base in range(0, m, tile_n):
        D, H, M = [], [], []
        for i in range(rows):
            d, h, mg = [], [], []
            for ln in range(LANES):
                e = base + LANES * i + ln
                act = e < m and bool(mask[src[e]] if vertex_mask else mask[e])
                has = e < m and (act or clamp)
                d.append(int(dst[e]) if has else -1)
                h.append(has)
                mg.append(out.dtype.type(_message(src_val[src[e]], w[e], kind, use_weight))
                          if act else R.neutral)
            D.append(d)
            H.append(h)
            M.append(mg)
        pair = False
        for i in range(rows):
            for ln in range(LANES):
                if ln > 0:
                    pd, ph = D[i][ln - 1], H[i][ln - 1]
                elif i > 0:
                    pd, ph = D[i - 1][-1], H[i - 1][-1]
                else:
                    continue
                pair |= H[i][ln] and ph and D[i][ln] == pd
        if pair:
            sends = _send_runs_rows(R, D, H, M, drop_carry)
        else:
            sends = [(D[i][ln], M[i][ln]) for i in range(rows) for ln in range(LANES)
                     if H[i][ln]]
        _send(R, out, sends)
    return out


def relax_model(src, dst, w, mask, src_val, out_init, kind, use_weight,
                vertex_mask, *, slots=4, head=0, rows=False, drop_carry=False):
    """edge_relax's design on numpy arrays; returns the new accumulator.
    ``rows``: the layout of push, relax_edges and relax_batch (``slots``
    rows of 32 consecutive slots); else that of pull (``slots``
    consecutive slots a lane after a first group of ``head``)."""
    widen = out_init.dtype == np.bool_
    if widen:
        src_val, out_init = src_val.astype(np.uint8), out_init.astype(np.uint8)
    R = Reducer(kind, out_init.dtype)
    out = out_init.copy()
    m = len(src)
    clamp = R.clamp and any(R.beyond(x) for x in out_init)
    if rows:
        out = _relax_rows(R, out, src, dst, w, mask, src_val, kind, use_weight,
                          vertex_mask, clamp, slots, drop_carry)
        return out.astype(np.bool_) if widen else out
    ngroups = 1 + (m - head + slots - 1) // slots
    for tile in range((ngroups + LANES - 1) // LANES):
        D, H, M = [], [], []
        for ln in range(LANES):
            g = tile * LANES + ln
            i0, n = 0, 0
            if g == 0:
                n = min(head, m)
            elif g < ngroups:
                i0 = head + (g - 1) * slots
                n = min(slots, m - i0)
            act = [False] * slots
            v = [out.dtype.type(0)] * slots
            for i in range(n):
                if vertex_mask:
                    act[i] = bool(mask[src[i0 + i]])
                    v[i] = src_val[src[i0 + i]]
                else:
                    act[i] = bool(mask[i0 + i])
                    if act[i]:
                        v[i] = src_val[src[i0 + i]]
            sends = any(act) or (clamp and n > 0)
            D.append([int(dst[i0 + i]) if sends and i < n else -1 for i in range(slots)])
            H.append([i < n and (act[i] or clamp) for i in range(slots)])
            M.append([out.dtype.type(_message(v[i], w[i0 + i], kind, use_weight))
                      if act[i] else R.neutral for i in range(slots)])
        pair = False
        for ln in range(LANES):
            if ln > 0 and H[ln][0] and H[ln - 1][-1] and D[ln][0] == D[ln - 1][-1]:
                pair = True
            for i in range(1, slots):
                pair |= H[ln][i] and H[ln][i - 1] and D[ln][i] == D[ln][i - 1]
        if pair:
            sends = _send_runs(R, D, H, M, drop_carry)
        else:
            sends = [(D[ln][i], M[ln][i]) for ln in range(LANES) for i in range(slots)
                     if H[ln][i]]
        _send(R, out, sends)
    return out.astype(np.bool_) if widen else out


# ---- advance ------------------------------------------------------------------


def _warp_upper_bound(cum, n, key, left=False):
    """The kernel's 32-ary search: first index of cum[0, n) above key."""
    gt = (lambda x: x >= key) if left else (lambda x: x > key)
    lo, hi = 0, n
    while hi - lo > LANES:
        span = hi - lo
        q = [lo + (lane + 1) * span // LANES - 1 for lane in range(LANES)]
        hits = [gt(cum[x]) for x in q]
        if not any(hits):
            return hi
        f = hits.index(True)
        lo, hi = (q[f - 1] + 1 if f > 0 else lo), q[f]
    hits = [lo + lane < hi and gt(cum[lo + lane]) for lane in range(LANES)]
    return lo + hits.index(True) if any(hits) else hi


def _lookback_scan(deg, live, tile, window, order):
    """cum and total by tiles with decoupled look-back.  Every live tile
    publishes its sum first (tile 0 its prefix); ``order`` is the order in
    which the others resolve: "asc" finds the prefix at once, "desc" makes
    each look back through aggregates, ``window`` at a time."""
    cap = len(deg)
    cum = np.zeros(cap, np.int32)
    live_tiles = [t for t in range(-(-cap // tile)) if t * tile < live]
    if not live_tiles:
        return cum, 0
    local, agg = {}, {}
    for t in live_tiles:
        d = [int(deg[i]) if i < live else 0 for i in range(t * tile, min((t + 1) * tile, cap))]
        local[t] = np.cumsum(d)
        agg[t] = int(local[t][-1])
    status = {t: (2 if t == 0 else 1, agg[t]) for t in live_tiles}
    excl = {0: 0}
    rest = [t for t in live_tiles if t]
    for t in (rest if order == "asc" else rest[::-1]):
        e, pred = 0, t - 1
        while True:
            sts = [status[i] if i >= 0 else (2, 0) for i in (pred - lane for lane in range(window))]
            assert all(f != 0 for f, _ in sts)
            done = [f == 2 for f, _ in sts]
            last = done.index(True) if any(done) else window - 1
            e += sum(v for lane, (_, v) in enumerate(sts) if lane <= last)
            if any(done):
                break
            pred -= window
        excl[t] = e
        status[t] = (2, e + agg[t])
    for t in live_tiles:
        for k, x in enumerate(local[t]):
            if t * tile + k < live:
                cum[t * tile + k] = excl[t] + x
    lt = live_tiles[-1]
    return cum, excl[lt] + agg[lt]


def advance_model(f_idx, f_count, out_deg, row_ptr, col_idx, edge_w, budget,
                  sentinel, m_pad, *, tile=2048, window=32, order="asc",
                  block=1024, stage=2048, left=False):
    """advance's design on numpy arrays: (src, dst, w, valid, total)."""
    cap = len(f_idx)
    live = min(int(f_count), cap)
    deg = np.array([out_deg[f_idx[i]] if i < live else 0 for i in range(cap)], np.int32)
    cum, total = _lookback_scan(deg, live, tile, window, order)
    le = (lambda a, b: a < b) if left else (lambda a, b: a <= b)
    u_out = np.empty(budget, np.int32)
    e_out = np.empty(budget, np.int64)
    ok_out = np.zeros(budget, np.bool_)
    for j0 in range(0, budget, block):
        slots = range(j0, min(j0 + block, budget))
        if j0 >= total:
            u_out[slots.start:slots.stop] = sentinel
            e_out[slots.start:slots.stop] = m_pad - 1
            continue
        k0 = _warp_upper_bound(cum, live, j0, left)
        k1 = _warp_upper_bound(cum, live, min(j0 + block, total, budget) - 1, left)
        nk = k1 - k0 + 1
        staged = nk <= stage
        s_cum, s_u = cum[k0:k0 + nk], f_idx[k0:k0 + nk]
        s_row = row_ptr[s_u]
        prev0 = int(cum[k0 - 1]) if k0 > 0 else 0
        for jt in range(j0, j0 + block, 4):
            k = -1
            for j in range(jt, jt + 4):
                if j >= budget:
                    break
                u, e, ok = sentinel, m_pad - 1, j < total
                if ok and staged:
                    if k < 0:
                        lo, hi = 0, nk - 1
                        while lo < hi:
                            mid = (lo + hi) // 2
                            lo, hi = (mid + 1, hi) if le(s_cum[mid], j) else (lo, mid)
                        k = lo
                    while k < nk - 1 and le(s_cum[k], j):
                        k += 1
                    prev = int(s_cum[k - 1]) if k > 0 else prev0
                    u, e = int(s_u[k]), int(s_row[k]) + j - prev
                elif ok:
                    lo, hi = k0, k1
                    while lo < hi:
                        mid = (lo + hi) // 2
                        lo, hi = (mid + 1, hi) if le(cum[mid], j) else (lo, mid)
                    prev = int(cum[lo - 1]) if lo > 0 else 0
                    u = int(f_idx[lo])
                    e = int(row_ptr[u]) + j - prev
                u_out[j], e_out[j], ok_out[j] = u, e, ok
    return (u_out, col_idx[e_out], edge_w[e_out], ok_out, np.int32(total))


# ---- inputs --------------------------------------------------------------------

KINDS = [("f32", "min"), ("f32", "max"), ("f32", "add"), ("i32", "min"),
         ("i32", "max"), ("i32", "add"), ("bool", "or")]
# (slots, head, rows): a tile of 32 slots; tiles of 128 as four consecutive
# slots a lane (pull), also after a first group of three slots before the
# 16-B boundary, and as four rows of 32 (push, relax_edges, relax_batch)
LAYOUTS = {"tile32": (1, 0, False), "lanes128": (4, 0, False),
           "lanes128_head3": (4, 3, False), "rows128": (4, 0, True)}


def _values(rng, n, dtype, kind, signed_zeros=False, seeds=False):
    """(src_val, out_init) for the kind: float data with signed zeros and,
    under the clamp, seeds of +inf (min) or -inf (max)."""
    if dtype == "bool":
        return rng.random(n) < 0.4, rng.random(n) < 0.2
    if dtype == "i32":
        lo = 0 if kind == "add" else -1000
        return (rng.integers(lo, 1000, n).astype(np.int32),
                rng.integers(lo, 1000, n).astype(np.int32))
    sv = (rng.normal(size=n) * 3).astype(np.float32)
    init = (rng.normal(size=n) * 3).astype(np.float32)
    if signed_zeros:
        pick = rng.random(n)
        sv[pick < 0.2] = -0.0
        sv[(pick >= 0.2) & (pick < 0.3)] = 0.0
        init[rng.random(n) < 0.15] = -0.0
    if seeds and kind in ("min", "max"):
        init[rng.random(n) < 0.3] = np.inf if kind == "min" else -np.inf
    if kind == "add":
        init[:] = 0.0
    return sv, init


def _runs_case(rng, dtype, kind):
    """dst sorted in runs of 1 to 300 (longer than a tile of 128), src
    random: pull's shape, under a vertex mask."""
    n = 400
    lens = [1, 2, 3, 40, 150, 300, 5, 129, 33, 31, 64, 1, 1, 97]
    dst = np.concatenate([np.full(k, (7 * i + 3) % (n - 1), np.int32) for i, k in enumerate(lens)])
    dst = np.sort(dst).astype(np.int32)
    m = len(dst)
    src = rng.integers(0, n - 1, m).astype(np.int32)
    w = (rng.integers(1, 5, m) * np.where(rng.random(m) < 0.2, -1, 1)).astype(np.float32)
    mask = rng.random(n) < 0.5
    mask[n - 1] = False
    sv, init = _values(rng, n, dtype, kind, seeds=True)
    return src, dst, w, mask, sv, init, True


def _masked_tile_case(rng, dtype, kind):
    """CSR order (src sorted, dst random) with a masked hub whose 300
    slots cover whole tiles, and one stretch of 260 slots all masked."""
    n = 300
    deg = rng.integers(0, 9, n - 1)
    deg[17] = 300
    src = np.repeat(np.arange(n - 1), deg).astype(np.int32)
    m = len(src)
    dst = rng.integers(0, n - 1, m).astype(np.int32)
    w = rng.integers(1, 5, m).astype(np.float32)
    mask = rng.random(n) < 0.6
    mask[17] = False
    mask[n - 1] = False
    lo = int(np.searchsorted(src, 100))
    mask[src[lo:lo + 260]] = False
    sv, init = _values(rng, n, dtype, kind, seeds=True)
    return src, dst, w, mask, sv, init, True


def _clamp_case(rng, dtype, kind):
    """Signed zeros in the messages and seeds, +inf (or -inf) seeds under
    the clamp, and a dst repeated in runs, under a per-slot mask."""
    n = 200
    m = 1500
    src = np.sort(rng.integers(0, n - 1, m)).astype(np.int32)
    dst = rng.integers(0, n - 1, m).astype(np.int32)
    dst[300:420] = 5                       # a run under the clamp
    dst[700:705] = dst[699]
    w = np.where(rng.random(m) < 0.3, np.float32(-0.0),
                 rng.integers(0, 3, m).astype(np.float32)).astype(np.float32)
    mask = rng.random(m) < 0.4
    mask[300:420] = rng.random(120) < 0.1
    sv, init = _values(rng, n, dtype, kind, signed_zeros=True, seeds=True)
    return src, dst, w, mask, sv, init, False


def _batch_graph():
    src, dst, n = jgen.web_crawl_like(8, 4, 6, 2, seed=1)
    w = np.random.default_rng(5).integers(1, 5, len(src)).astype(np.float32)
    return jfrom_coo(src, dst, n, w, block_size=64)


def _batch_case(rng, dtype, kind):
    """relax_batch over advance's output whose budget is 4x its total: a
    3x padding tail, all naming edge m_pad - 1."""
    jg = _batch_graph()
    fmask = rng.random(jg.n_pad) < 0.3
    fmask[jg.sentinel] = False
    f = jfr.compact(jnp.asarray(fmask), jg.n_pad, jg.sentinel)
    total = int(np.asarray(jg.out_deg)[np.asarray(f.idx)[: int(f.count)]].sum())
    budget = 4 * total
    b = jgk.advance_ref(f.idx, f.count, jg.out_deg, jg.row_ptr, jg.col_idx,
                        jg.edge_w, budget, jg.sentinel, jg.m_pad)
    src, dst, w, valid, tot = (np.asarray(x) for x in b)
    assert int(tot) == total and int(valid.sum()) == total
    sv, init = _values(rng, jg.n_pad, dtype, kind, seeds=True)
    return src, dst, w, valid, sv, init, False


CASES = {"runs_cross_tiles": _runs_case, "all_masked_tile": _masked_tile_case,
         "signed_zeros_clamp": _clamp_case, "batch_3x_tail": _batch_case}


def _inputs(case, dtype, kind, seed=0):
    rng = np.random.default_rng(seed)
    return CASES[case](rng, dtype, kind)


def _refs(src, dst, w, mask, sv, init, kind, use_w, vm):
    """The port's plain version and the JAX package's, as numpy."""
    T = [torch.from_numpy(np.array(x)) for x in (src, dst, w, mask, sv, init)]
    J = [jnp.asarray(x) for x in (src, dst, w, mask, sv, init)]
    if vm:
        t = tref.push_ref(T[0], T[1], T[2], T[4], T[3], T[5], kind, use_w)
        j = jgk.push_ref(J[0], J[1], J[2], J[4], J[3], J[5], kind, use_w)
    else:
        t = tref.relax_ref(*T, kind, use_w)
        j = jgk.relax_ref(*J, kind, use_w)
    return t.numpy(), np.asarray(j)


def _abs_scale(src, dst, w, mask, sv, init, use_w, vm):
    act = mask[src] if vm else mask
    terms = np.where(act, np.abs(_message_arr(sv[src], w, use_w)), 0.0)
    scale = np.abs(init).astype(np.float64)
    np.add.at(scale, dst, terms)
    return scale


def _message_arr(v, w, use_w):
    return v * w if use_w else v


def _assert_relax(got, want, kind, dtype, scale=None, what=""):
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if kind == "add" and dtype == "f32":
        err = np.abs(got.astype(np.float64) - want.astype(np.float64))
        assert (err <= ADD_RTOL_OF_ABS_SUM * scale + 1e-30).all(), (what, err.max())
    elif dtype == "f32":
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype,kind", KINDS)
def test_relax_model_matches_plain_and_jax(dtype, kind, case, layout):
    src, dst, w, mask, sv, init, vm = _inputs(case, dtype, kind)
    use_w = dtype == "f32"
    slots, head, rows = LAYOUTS[layout]
    got = relax_model(src, dst, w, mask, sv, init, kind, use_w, vm, slots=slots, head=head,
                      rows=rows)
    t, j = _refs(src, dst, w, mask, sv, init, kind, use_w, vm)
    scale = _abs_scale(src, dst, w, mask, sv, init, use_w, vm) if kind == "add" else None
    _assert_relax(got, t, kind, dtype, scale, f"{case}/{layout} vs ref.py")
    _assert_relax(got, j, kind, dtype, scale, f"{case}/{layout} vs JAX")


def test_relax_cases_take_both_paths():
    """The cases reach what they are named for: a run longer than a tile,
    an all-masked tile, seeds beyond the neutral (the clamp flag), and a
    padding tail three times the valid slots."""
    src, dst, *_ = _inputs("runs_cross_tiles", "f32", "min")
    assert np.max(np.unique(dst, return_counts=True)[1]) > 128
    src, dst, w, mask, *_ = _inputs("all_masked_tile", "f32", "min")
    act = mask[src]
    assert any(not act[i:i + 128].any() for i in range(0, len(src) - 128, 128))
    *_, init, _ = _inputs("signed_zeros_clamp", "f32", "min")
    assert np.isinf(init).any() and (np.signbit(init) & (init == 0)).any()
    src, dst, w, valid, *_ = _inputs("batch_3x_tail", "f32", "min")
    assert (~valid).sum() == 3 * valid.sum() and len(np.unique(dst[~valid])) == 1


@pytest.mark.parametrize("rows", [False, True], ids=["lanes", "rows"])
def test_relax_model_without_carry_fails(rows):
    """A run's carry dropped at a lane (row) edge loses the messages of the
    run's earlier lanes (rows): the model then disagrees with the plain
    version."""
    src, dst, w, mask, sv, init, vm = _inputs("runs_cross_tiles", "f32", "min")
    got = relax_model(src, dst, w, mask, sv, init, "min", True, vm, rows=rows,
                      drop_carry=True)
    t, _ = _refs(src, dst, w, mask, sv, init, "min", True, vm)
    assert not np.array_equal(got.view(np.int32), t.view(np.int32))


# ---- advance ------------------------------------------------------------------


def _star(n_leaves=90):
    """A hub whose leaves have no out-edges but every tenth: runs of
    frontier entries of degree 0 between entries of degree 1."""
    src = np.zeros(n_leaves, np.int64)
    dst = np.arange(1, n_leaves + 1)
    extra_s = np.arange(1, n_leaves, 10)
    return (np.concatenate([src, extra_s]), np.concatenate([dst, extra_s + 1]),
            n_leaves + 1)


def _hub(n_leaves=200):
    src = [0] * n_leaves + list(range(1, n_leaves))
    dst = list(range(1, n_leaves + 1)) + list(range(2, n_leaves + 1))
    return np.array(src), np.array(dst), n_leaves + 1


def _adv_inputs(case):
    """(JAX graph, frontier mask, capacity, budget)."""
    rng = np.random.default_rng(4)
    if case in ("zero_degree", "f_count_0"):
        s, d, n = _star()
    else:
        s, d, n = _hub()
    jg = jfrom_coo(s, d, n, rng.integers(1, 5, len(s)).astype(np.float32), block_size=16)
    deg = np.asarray(jg.out_deg)
    mask = np.zeros(jg.n_pad, bool)
    if case == "f_count_0":
        return jg, mask, 32, 64
    mask[: jg.n] = rng.random(jg.n) < 0.6
    mask[0] = True                                   # the hub
    total = int(deg[mask].sum())
    if case == "zero_degree":
        mask[: jg.n] = True                          # every leaf: degree 0
        return jg, mask, jg.n_pad, 2 * int(deg[mask].sum())
    if case == "f_count_gt_cap":
        return jg, mask, 48, 4 * total
    if case == "budget_lt_total":
        return jg, mask, jg.n_pad, total // 3
    return jg, mask, jg.n_pad, 2 * total             # hub_spans_blocks


ADV_CASES = ["f_count_0", "f_count_gt_cap", "budget_lt_total", "zero_degree",
             "hub_spans_blocks"]
# (scan tile, look-back window, resolve order, block of slots, staged entries)
ADV_LAYOUTS = {"tiles16_asc": (16, 32, "asc", 32, 2048),
               "tiles4_desc_window4_stage4": (4, 4, "desc", 8, 4)}


def _run_advance(case, layout, left=False):
    jg, mask, cap, budget = _adv_inputs(case)
    f = jfr.compact(jnp.asarray(mask), cap, jg.sentinel)
    arrays = [np.asarray(x) for x in (f.idx, f.count, jg.out_deg, jg.row_ptr,
                                      jg.col_idx, jg.edge_w)]
    tile, window, order, block, stage = ADV_LAYOUTS[layout]
    got = advance_model(*arrays, budget, jg.sentinel, jg.m_pad, tile=tile, window=window,
                        order=order, block=block, stage=stage, left=left)
    T = [torch.from_numpy(np.array(x)) for x in arrays]
    t = tref.advance_ref(*T, budget, jg.sentinel, jg.m_pad)
    j = jgk.advance_ref(f.idx, f.count, jg.out_deg, jg.row_ptr, jg.col_idx, jg.edge_w,
                        budget, jg.sentinel, jg.m_pad)
    return got, [x.numpy() for x in t], [np.asarray(x) for x in j], (jg, f, cap, budget)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("layout", list(ADV_LAYOUTS))
@pytest.mark.parametrize("case", ADV_CASES)
def test_advance_model_matches_plain_and_jax(case, layout):
    got, t, j, (jg, f, cap, budget) = _run_advance(case, layout)
    for fld, a, b, c in zip(("src", "dst", "w", "valid", "total"), got, t, j):
        assert _same(a, b), f"{case}/{layout}: {fld} differs from ref.py"
        assert _same(a, c), f"{case}/{layout}: {fld} differs from JAX"
    count, total = int(f.count), int(got[4])
    if case == "f_count_0":
        assert count == 0 and total == 0 and not got[3].any()
    if case == "f_count_gt_cap":
        assert count > cap
    if case == "budget_lt_total":
        assert budget < total and got[3].all()
    if case == "zero_degree":
        deg = np.asarray(jg.out_deg)[np.asarray(f.idx)[:count]]
        assert (deg == 0).sum() > 80
    if case == "hub_spans_blocks":
        assert int(np.asarray(jg.out_deg)[0]) > 4 * ADV_LAYOUTS[layout][3]


def test_advance_model_side_left_fails():
    """The search with side="left" (a lower bound) puts each entry's first
    slot on the entry before: the model then disagrees with the plain
    version."""
    got, t, _, _ = _run_advance("hub_spans_blocks", "tiles16_asc", left=True)
    assert not all(_same(a, b) for a, b in zip(got[:4], t[:4]))
