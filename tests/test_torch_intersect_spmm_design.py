"""CPU models of the Hopper designs of intersect and spmm_bsr, held to the
plain versions and to the JAX package.

The CUDA kernels (``graph_ops.cu``'s ``intersect_scan`` and
``intersect_count``, ``spmm_bsr.cu``'s ``spmm_kernel``) run only on the
card.  These models follow their decompositions step for step on the CPU:

* ``intersect_model``: the single-pass scan of each edge's candidate mass
  (its source row's real length) with decoupled look-back, the record of
  the edge that holds each tile's first candidate, then tiles of
  ``threads x items`` candidates: the tile's edges staged up to
  ``edges_stage`` with a scan of their target rows' lengths, the rows
  copied in until ``rows_stage`` entries are full, each warp of ``warp``
  lanes on ``warp x items`` consecutive candidates, a lane on ``items`` of
  them ``warp`` apart, its first candidate's edge found by bisecting the
  tile's scan, and each candidate bisected in its staged row or, past the
  stage, in adj itself, and counted into its chunk's partial (one add per
  tile for the tile's first chunk, one per hit for a later one).  Held bitwise
  to ``ref.intersect_ref`` per chunk and to the JAX ``intersect_count``.
  A mutated model (a later chunk's hits kept in the tile's first chunk;
  the searches with side="left") must fail.
* ``spmm_model``: the tensor-core arithmetic of ``spmm_kernel`` in torch:
  TF32 rounding (round to nearest, ties away, to 10 mantissa bits) on the
  int32 view, each f32 operand split into hi + lo, the three products
  A_hi X_hi + A_hi X_lo + A_lo X_hi (a bf16 operand is exact in TF32: no
  lo), each slot's partial summed in f32, rounded to out's dtype and added
  in, as the reference rounds.  Held to the JAX ``spmm_bsr(interpret=True)``
  within the reference's tolerances (f32 2e-4, bf16 and mixed 0.2, as
  ``tests/test_torch_kernels.py`` holds the port); one case prints a single
  TF32 pass's error beside the split's.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core.algorithms import tc as jtc  # noqa: E402
from repro.core.graph import from_coo as jfrom_coo  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.kernels import graph_ops as jgk  # noqa: E402
from repro.kernels.spmm_bsr.spmm_bsr import spmm_bsr as j_spmm, to_bsr as j_to_bsr  # noqa: E402
from repro_torch.kernels.graph_ops import ref as tref  # noqa: E402
from test_torch_kernels import SPMM_CASES, TOL, _random_graph  # noqa: E402
from test_torch_relax_advance_design import _lookback_scan, _warp_upper_bound  # noqa: E402

# ---- intersect ------------------------------------------------------------------


def intersect_model(adj, src, dst, sentinel, row_len, chunk, *, threads, items, edges_stage,
                    rows_stage, scan_tile, window, order, warp, left=False, drop_carry=False):
    """intersect's design on numpy arrays: the (ceil(e / chunk),) int32
    partial counts and what the run went through (``stats``)."""
    e = len(src)
    n_rows = adj.shape[0]
    le = (lambda a, b: a < b) if left else (lambda a, b: a <= b)
    ok = (src >= 0) & (src < n_rows) & (dst >= 0) & (dst < n_rows)
    mass = np.where(ok, row_len[np.clip(src, 0, n_rows - 1)], 0).astype(np.int32)
    cum, total = _lookback_scan(mass, e, scan_tile, window, order)
    tile = threads * items
    tile_k, before = {}, 0
    for i in range(e):      # the scan's emit: the edge of each tile's first candidate
        t = -(-before // tile)
        while t * tile < cum[i]:
            tile_k[t] = i
            t += 1
        before = int(cum[i])
    partial = np.zeros(-(-e // chunk), np.int64)
    stats = dict(staged_tiles=0, unstaged_tiles=0, rows_past_stage=0, runs_across_edges=0,
                 tiles_across_chunks=0, hits_in_later_chunks=0, empty_target_rows=0)
    ntiles = -(-total // tile)
    for t in range(ntiles):
        c0 = t * tile
        c_end = min(c0 + tile, total)
        k0 = tile_k[t]
        if t + 1 < ntiles:
            k1 = tile_k[t + 1]
        else:
            k1 = k0 + _warp_upper_bound(cum[k0:], e - k0, total - 1, left)
        nk = k1 - k0 + 1
        prev0 = int(cum[k0 - 1]) if k0 > 0 else 0
        boundary = (k0 // chunk + 1) * chunk
        stats["tiles_across_chunks"] += k0 + nk > boundary
        s_cum, s_src, s_dst = cum[k0:k0 + nk], src[k0:k0 + nk], dst[k0:k0 + nk]
        staged = nk <= edges_stage
        stats["staged_tiles" if staged else "unstaged_tiles"] += 1
        if staged:
            prevs = np.concatenate([[prev0], s_cum[:-1]])
            ln = np.where(s_cum > prevs, row_len[np.clip(s_dst, 0, n_rows - 1)], 0)
            s_off = np.concatenate([[0], np.cumsum(ln)])
            over = [int(s_off[i]) for i in range(nk)
                    if s_off[i] <= rows_stage < s_off[i] + ln[i]]
            fit = min(over + [int(s_off[nk])])
            s_rows = np.concatenate([adj[s_dst[i], :ln[i]] for i in range(nk)] + [[]])[:fit]
            stats["rows_past_stage"] += int(sum(1 for i in range(nk) if s_off[i + 1] > fit))
        tile_hits = 0
        for th in range(threads):
            wq, lane = divmod(th, warp)
            cw = c0 + wq * warp * items + lane
            cands = [cw + warp * i for i in range(items) if cw + warp * i < c_end]
            if not cands:
                continue
            lo, hi = 0, nk - 1          # the edge of cw: bisect the tile's scan
            while lo < hi:
                mid = (lo + hi) // 2
                lo, hi = (mid + 1, hi) if le(s_cum[mid], cw) else (lo, mid)
            k, run = lo, []
            for c in cands:
                while le(s_cum[k], c):
                    k += 1
                prev = int(s_cum[k - 1]) if k > 0 else prev0
                j = c - prev
                run.append((k, adj[s_src[k], j] if j < adj.shape[1] else sentinel))
            stats["runs_across_edges"] += run[0][0] != run[-1][0]
            for k, w in run:
                if staged and s_off[k + 1] <= fit:
                    row = s_rows[s_off[k]:s_off[k + 1]]
                else:
                    row = adj[s_dst[k], :row_len[s_dst[k]]]
                stats["empty_target_rows"] += len(row) == 0
                pos, hi = 0, len(row)   # the lower bound of w in row
                while pos < hi:
                    mid = (pos + hi) // 2
                    pos, hi = (mid + 1, hi) if row[mid] < w else (pos, mid)
                if pos < len(row) and row[pos] == w:
                    if k0 + k < boundary or drop_carry:
                        tile_hits += 1
                    else:
                        partial[(k0 + k) // chunk] += 1
                        stats["hits_in_later_chunks"] += 1
        partial[k0 // chunk] += tile_hits
    return partial.astype(np.int32), stats


def _clique_kron():
    """A 48-clique (oriented rows up to 47 long: past 32 and past the
    small stage) beside kron(8), whose rows are short or empty."""
    ks, kd, kn = jgen.kron(8, 8, seed=3)
    cs, cd = np.triu_indices(48, 1)
    return np.concatenate([cs, ks + 48]), np.concatenate([cd, kd + 48]), kn + 48


INTERSECT_GRAPHS = {"clique_kron": _clique_kron,
                    "web": lambda: jgen.web_crawl_like(2, 6, 8, 2, seed=5)}


def _intersect_inputs(gname, edges, chunk):
    """(adj, src, dst, sentinel, row_len) as numpy: the oriented list padded
    with sentinels to whole chunks (a tail chunk); "empty_rows" pairs
    endpoints with empty oriented rows with full ones; "shuffled" puts the
    oriented edges in random order with padding among them, one run of it
    longer than a small stage."""
    rng = np.random.default_rng(7)
    s, d, n = INTERSECT_GRAPHS[gname]()
    jg = jfrom_coo(s, d, n, block_size=16, symmetrize=True)
    adj, osrc, odst = (np.array(x) for x in jtc.oriented_adjacency(jg))
    sent = jg.sentinel
    row_len = (adj != sent).sum(1).astype(np.int32)
    if edges == "empty_rows":
        empty = np.flatnonzero(row_len == 0)
        full = np.flatnonzero(row_len > 0)
        osrc = np.concatenate([rng.choice(empty, 30), rng.choice(full, 60), rng.choice(full, 60)])
        odst = np.concatenate([rng.choice(full, 30), rng.choice(empty, 60), rng.choice(full, 60)])
    elif edges == "shuffled":
        # scattered padding, and a run of it that no staged tile can hold
        at = np.concatenate([rng.integers(0, len(osrc), 40), np.full(40, len(osrc) // 2)])
        order = rng.permutation(len(osrc))
        osrc = np.insert(osrc[order], at, sent)
        odst = np.insert(odst[order], at, sent)
    pad = -len(osrc) % chunk
    osrc = np.concatenate([osrc, np.full(pad, sent)]).astype(np.int32)
    odst = np.concatenate([odst, np.full(pad, sent)]).astype(np.int32)
    return adj, osrc, odst, sent, row_len


# (threads, items, edges_stage, rows_stage, scan_tile, window, order, warp):
# small stages that force every path, and the kernel's own sizes
INTERSECT_LAYOUTS = {"small_stages": (16, 4, 12, 40, 32, 4, "desc", 4),
                     "kernel": (256, 8, 1024, 6144, 2048, 32, "asc", 32)}


def _run_intersect(gname, edges, layout, chunk=40, **mutation):
    adj, src, dst, sent, row_len = _intersect_inputs(gname, edges, chunk)
    threads, items, es, rs, st, win, order, warp = INTERSECT_LAYOUTS[layout]
    got, stats = intersect_model(adj, src, dst, sent, row_len, chunk, threads=threads,
                                 items=items, edges_stage=es, rows_stage=rs, scan_tile=st,
                                 window=win, order=order, warp=warp, **mutation)
    want = tref.intersect_chunks_ref(*(torch.from_numpy(x) for x in (adj, src, dst)), sent,
                                     chunk).numpy()
    return got, want, stats, (adj, src, dst, sent, row_len)


@pytest.mark.parametrize("chunk", [40, 300])
@pytest.mark.parametrize("layout", list(INTERSECT_LAYOUTS))
@pytest.mark.parametrize("edges", ["oriented", "empty_rows", "shuffled"])
@pytest.mark.parametrize("gname", list(INTERSECT_GRAPHS))
def test_intersect_model_matches_plain_and_jax(gname, edges, layout, chunk):
    got, want, stats, (adj, src, dst, sent, row_len) = _run_intersect(gname, edges, layout,
                                                                       chunk)
    assert got.dtype == np.int32 and np.array_equal(got, want), stats
    jtotal = int(jgk.intersect_count(*(jnp.asarray(x) for x in (adj, src, dst)), sentinel=sent))
    assert int(got.sum()) == jtotal
    assert (row_len == 0).any() and src[-1] == sent
    if gname == "clique_kron":
        assert row_len.max() > max(32, INTERSECT_LAYOUTS["small_stages"][3])
    if (edges, layout, gname, chunk) == ("oriented", "small_stages", "clique_kron", 40):
        # partitions cross edges and chunks, rows pass the stage
        assert stats["runs_across_edges"] > 0 and stats["tiles_across_chunks"] > 0
        assert stats["hits_in_later_chunks"] > 0 and stats["rows_past_stage"] > 0
    if edges == "empty_rows":
        assert stats["empty_target_rows"] > 0 and jtotal >= 0
    if edges == "shuffled" and layout == "small_stages":
        assert stats["unstaged_tiles"] > 0 and stats["staged_tiles"] > 0


def test_intersect_model_whole_list_is_each_chunk():
    """One launch over the whole list writes each chunk's count: the same
    as the model run on each chunk alone, and as the JAX count of each."""
    got, want, _, (adj, src, dst, sent, row_len) = _run_intersect(
        "clique_kron", "oriented", "small_stages", chunk=256)
    for c in range(len(got)):
        sl = slice(c * 256, (c + 1) * 256)
        alone, _ = intersect_model(adj, src[sl], dst[sl], sent, row_len, 256, threads=16,
                                   items=4, edges_stage=12, rows_stage=40, scan_tile=32,
                                   window=4, order="asc", warp=4)
        j = int(jgk.intersect_count(*(jnp.asarray(x) for x in (adj, src[sl], dst[sl])),
                                    sentinel=sent))
        assert int(alone[0]) == int(got[c]) == int(want[c]) == j


@pytest.mark.parametrize("mutation", ["drop_carry", "left"])
def test_intersect_model_mutations_fail(mutation):
    """A later chunk's hits kept in the tile's first chunk, or the searches
    with side="left" (a candidate read from the edge before), disagree with
    the plain version: the cases can see either fault."""
    got, want, _, _ = _run_intersect("clique_kron", "oriented", "small_stages",
                                     **{mutation: True})
    assert not np.array_equal(got, want)


# ---- spmm_bsr ----------------------------------------------------------------------


def tf32(x):
    """cvt.rna.tf32.f32 on an f32 tensor: round to nearest, ties away from
    zero, to 10 mantissa bits (the int32 view, 0x1000 added to the
    magnitude, the low 13 bits cleared)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    """(hi, lo) of a tensor in TF32: hi = tf32(x), lo = tf32(x - hi); a bf16
    tensor is exact in TF32 and has no lo."""
    if x.dtype == torch.bfloat16:
        return x.float(), None
    hi = tf32(x)
    return hi, tf32(x - hi)


def spmm_model(indices, blocks, x, passes=3):
    """spmm_kernel's arithmetic in torch: per slot, the TF32 split products
    (passes=3; 1 is a single TF32 pass, hi x hi) or, for bf16 x bf16, the
    exact products, summed in f32, rounded to x's dtype and added into the
    output row block as the reference does."""
    R, K, bm, bk = blocks.shape
    xb = x.reshape(-1, bk, x.shape[1])
    c_blocks = xb.shape[0]
    out = torch.zeros((R, bm, x.shape[1]), dtype=x.dtype)
    for j in range(K):
        c = indices[:, j]
        valid = (c >= 0) & (c < c_blocks)
        a = blocks[:, j]
        g = xb[c.clamp(0, c_blocks - 1).long()]
        if a.dtype == g.dtype == torch.bfloat16:
            prod = torch.bmm(a.float(), g.float())
        else:
            (ah, al), (gh, gl) = split(a), split(g)
            prod = torch.bmm(ah, gh)
            if passes == 3:
                if gl is not None:
                    prod = prod + torch.bmm(ah, gl)
                if al is not None:
                    prod = prod + torch.bmm(al, gh)
        out = torch.where(valid[:, None, None], out + prod.to(x.dtype), out)
    return out.reshape(R * bm, x.shape[1])


def test_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23,
                      1 + 1.5 * ulp, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, 0.0])
    assert torch.equal(tf32(x), want)
    v = torch.from_numpy(np.random.default_rng(2).normal(size=1000).astype(np.float32))
    hi, lo = split(v)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert bool(((hi + lo - v).abs() <= 2.0 ** -21 * v.abs()).all())


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
J_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.mark.parametrize("blocks_dtype,x_dtype", [("float32", "float32"),
                                                  ("bfloat16", "bfloat16"),
                                                  ("float32", "bfloat16"),
                                                  ("bfloat16", "float32")])
@pytest.mark.parametrize("n,m,f,bm,bk", SPMM_CASES)
def test_spmm_model_matches_jax(n, m, f, bm, bk, blocks_dtype, x_dtype):
    rng = np.random.default_rng(n + m + f)
    src, dst, w = _random_graph(rng, n, m)
    idx, blocks = j_to_bsr(src, dst, w, n, bm=bm, bk=bk)
    idx, blocks = np.array(idx), np.array(blocks)
    x = rng.normal(size=(((n + bk - 1) // bk) * bk, f))
    want = np.asarray(j_spmm(jnp.asarray(idx), jnp.asarray(blocks, J_DTYPES[blocks_dtype]),
                             jnp.asarray(x, J_DTYPES[x_dtype]), interpret=True), np.float32)
    tb = torch.from_numpy(blocks).to(DTYPES[blocks_dtype])
    tx = torch.from_numpy(x).to(DTYPES[x_dtype])
    got = spmm_model(torch.from_numpy(idx), tb, tx)
    assert got.dtype == DTYPES[x_dtype] and got.shape == (idx.shape[0] * bm, f)
    tol = TOL["float32"] * 10 if blocks_dtype == x_dtype == "float32" else TOL["bfloat16"] * 10
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def test_spmm_single_tf32_pass_error_beside_the_split():
    """The largest case in f32 with weights from 1 to 8 and
    ``web_crawl_like``'s structure: the split's error and a single TF32
    pass's, against the JAX kernel, printed side by side; the split keeps
    the reference's 2e-4, and the single pass lies far above the split."""
    s, d, n = jgen.web_crawl_like(1, 9, 16, 3, seed=0)
    w = jgen.random_weights(len(s), seed=1)
    idx, blocks = (np.array(a) for a in j_to_bsr(s, d, w, n))
    x = np.random.default_rng(3).normal(size=(idx.shape[0] * 128, 128)).astype(np.float32)
    want = np.asarray(j_spmm(jnp.asarray(idx), jnp.asarray(blocks), jnp.asarray(x),
                             interpret=True))
    tol = TOL["float32"] * 10
    errs = {}
    for passes in (3, 1):
        got = spmm_model(torch.from_numpy(idx), torch.from_numpy(blocks),
                         torch.from_numpy(x), passes=passes).numpy()
        errs[passes] = float(np.max((np.abs(got - want) - tol * np.abs(want))))
    print(f"spmm_bsr n={n} edges={len(s)} F=128 f32: max(|err| - {tol} |want|): split TF32 "
          f"{errs[3]}, single TF32 pass {errs[1]} (limit {tol})")
    assert errs[3] <= tol < errs[1] and errs[1] > 100 * max(errs[3], 2.0 ** -20)
    assert math.isfinite(errs[1])
