"""The port's dynamic graphs (``repro_torch.core.dynamic``, the v3 store,
the incremental algorithms and ``benchmarks/dynamic.py``) against the JAX
package's, case by case after ``tests/test_dynamic.py`` and
``tests/test_dynamic_properties.py``, on the same seeds.

Held: ``apply_batch``'s accepted edges, logs, ``dirty``, ``old_out_deg``
and ``inserted`` bitwise; the logs invariant to the batch's order;
incremental bfs and cc bitwise to a from-scratch run and to the JAX
package's; ``pr_incremental`` allclose to the port's scratch ``pr_push``
(rtol 1e-3, atol 1e-6), to the JAX package's (rtol 1e-4, atol 1e-10, the
`PERF.md` §2 limit) and to ``oracles.pagerank`` on the merged edge list
(rtol 2e-3, atol 1e-8, ``tests/test_algorithms.py``'s); its replay under
deterministic add bitwise across pool sizes (the reference's
``tests/test_dynamic.py:191`` assertion); compaction bitwise to a
``from_coo`` + ``tier_graph`` build; v3 stores opened across packages.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro import checkpoint as jck  # noqa: E402
from repro.core import dynamize as jdynamize  # noqa: E402
from repro.core import from_coo as jfrom_coo  # noqa: E402
from repro.core import operators as jops  # noqa: E402
from repro.core.algorithms import bfs as jbfs  # noqa: E402
from repro.core.algorithms import cc as jcc  # noqa: E402
from repro.core.algorithms import pagerank as jpr  # noqa: E402
from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch.core import DynamicGraph, dynamize, from_coo, tier_graph  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core.algorithms import bfs as tbfs  # noqa: E402
from repro_torch.core.algorithms import cc as tcc  # noqa: E402
from repro_torch.core.algorithms import pagerank as tpr  # noqa: E402
from repro_torch.core.faultio import ShardCorruptError  # noqa: E402

import oracles  # noqa: E402


def same(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def stats_equal(js, ts):
    """Every RunStats counter equal but ``substrate`` and ``io_wait_us``."""
    a, b = js.as_dict(), ts.as_dict()
    for key in ("substrate", "io_wait_us"):
        a.pop(key), b.pop(key)
    assert a == b


def ring(n=40, block_size=16, **kw):
    src = np.arange(n)
    return src, (src + 1) % n, n, dict(block_size=block_size, **kw)


def rand_edges(rng, n, m):
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = src != dst
    return src[keep], dst[keep]


def base_and_holdout(seed=0, n=60, m=240, holdout=40):
    rng = np.random.default_rng(seed)
    src, dst = rand_edges(rng, n, m)
    return (src[:-holdout], dst[:-holdout]), (src[-holdout:], dst[-holdout:]), n


def both(src, dst, n, nshards, pool=None, w=None, **kw):
    """(reference DynamicGraph, port DynamicGraph) on the same arrays; the
    cut carries a CSC mirror when the graph does."""
    kw.setdefault("block_size", 16)
    csc = kw.get("build_csc", False)
    return (jdynamize(jfrom_coo(src, dst, n, w, **kw), nshards=nshards,
                      resident_shards=pool, build_csc=csc),
            dynamize(from_coo(src, dst, n, w, device="cpu", **kw), nshards=nshards,
                     resident_shards=pool, build_csc=csc))


def logs_equal(jd, td):
    for a, b in zip(jd._log, td._log):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x.view(np.int32), y.view(np.int32))


def delta_equal(a, b):
    for f in ("src", "dst", "w", "dirty", "old_out_deg"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8))
    assert (a.inserted, a.requested) == (b.inserted, b.requested)


# ---------------------------------------------------------------------------
# apply_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("symmetrize", [False, True])
@pytest.mark.parametrize("nshards", [3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_batch_matches_reference(seed, nshards, symmetrize):
    (bs, bd), (hs, hd), n = base_and_holdout(seed)
    w = np.random.default_rng(seed).uniform(1, 3, hs.size).astype(np.float32)
    jd, td = both(bs, bd, n, nshards, symmetrize=symmetrize)
    for k in range(0, hs.size, 10):
        a = jd.apply_batch(hs[k:k + 10], hd[k:k + 10], w[k:k + 10],
                           symmetrize=symmetrize)
        b = td.apply_batch(hs[k:k + 10], hd[k:k + 10], w[k:k + 10],
                           symmetrize=symmetrize)
        delta_equal(a, b)
        logs_equal(jd, td)
        same(jd.out_deg, td.out_deg)
        np.testing.assert_array_equal(jd._out_deg_np, td._out_deg_np)
        assert jd.m == td.m and jd.log_sizes == td.log_sizes


def test_apply_batch_insert_if_absent():
    src, dst, n, kw = ring()
    dyn = dynamize(from_coo(src, dst, n, device="cpu", **kw), nshards=4)
    m0 = dyn.m
    # 0->1 is in the base; (5,5) a self-loop; (3,7) twice keeps one
    delta = dyn.apply_batch([0, 5, 3, 3, 9], [1, 5, 7, 7, 2],
                            [1.0, 1.0, 4.0, 2.0, 1.0])
    assert delta.requested == 5 and delta.inserted == 2
    assert dyn.m == m0 + 2 and list(delta.dirty) == [3, 9]
    assert delta.w[list(delta.src).index(3)] == 2.0
    again = dyn.apply_batch([3, 9], [7, 2])
    assert again.inserted == 0 and dyn.m == m0 + 2


def test_apply_batch_rejects_out_of_range():
    src, dst, n, kw = ring()
    dyn = dynamize(from_coo(src, dst, n, device="cpu", **kw), nshards=4)
    with pytest.raises(ValueError):
        dyn.apply_batch([0], [40])
    with pytest.raises(ValueError):
        dyn.apply_batch([-1], [3])


def test_apply_batch_symmetrize_updates_out_deg_on_device():
    src, dst, n, kw = ring(symmetrize=True)
    dyn = dynamize(from_coo(src, dst, n, device="cpu", **kw), nshards=4)
    od0 = dyn.out_deg.clone()
    base0 = dyn.base.out_deg.clone()
    delta = dyn.apply_batch([4], [20], symmetrize=True)
    assert delta.inserted == 2 and set(delta.dirty) == {4, 20}
    assert int(dyn.out_deg[4]) == int(od0[4]) + 1
    assert int(dyn.out_deg[20]) == int(od0[20]) + 1
    np.testing.assert_array_equal(delta.old_out_deg, od0.numpy())
    assert torch.equal(dyn.base.out_deg, base0)   # the base stays as cut


def test_duplicates_keep_min_weight_like_from_coo():
    """Within a batch the minimum weight wins, with from_coo's tie rules:
    -0.0 against +0.0 and NaN resolve as its lexsort resolves them."""
    n = 12
    s = np.array([1, 1, 1, 2, 2, 2, 3, 3, 4, 4, 5])
    d = np.array([6, 6, 6, 7, 7, 7, 8, 8, 9, 9, 10])
    w = np.array([3.0, -0.0, 0.0, np.nan, 2.0, 5.0, 0.0, -0.0, np.nan, np.nan,
                  1.5], np.float32)
    jd, td = both(np.array([0]), np.array([11]), n, 2)
    a, b = jd.apply_batch(s, d, w), td.apply_batch(s, d, w)
    delta_equal(a, b)
    g = from_coo(np.concatenate([[0], s]), np.concatenate([[11], d]), n,
                 np.concatenate([[1.0], w]).astype(np.float32), block_size=16,
                 device="cpu")
    ew = g.edge_w[1:g.m].numpy()   # (0, 11) sorts first
    np.testing.assert_array_equal(ew.view(np.int32), b.w.view(np.int32))


batches_st = st.lists(st.tuples(st.integers(0, 59), st.integers(0, 59)),
                      min_size=1, max_size=40)


@settings(max_examples=20, deadline=None)
@given(batch=batches_st, perm_seed=st.integers(0, 2**31 - 1),
       nshards=st.integers(2, 5), symmetrize=st.booleans())
def test_log_state_permutation_invariant(batch, perm_seed, nshards, symmetrize):
    (bs, bd), _, n = base_and_holdout(3)
    s = np.array([e[0] for e in batch])
    d = np.array([e[1] for e in batch])
    w = np.random.default_rng(perm_seed).uniform(1, 3, s.size).astype(np.float32)
    perm = np.random.default_rng(perm_seed).permutation(s.size)
    logs = []
    for order in (np.arange(s.size), perm):
        dyn = dynamize(from_coo(bs, bd, n, block_size=16, device="cpu"),
                       nshards=nshards)
        dyn.apply_batch(s[order], d[order], w[order], symmetrize=symmetrize)
        logs.append(dyn)
    a, b = logs
    for x, y in zip(a._log, b._log):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u.view(np.int32), v.view(np.int32))
    assert torch.equal(a.out_deg, b.out_deg)


# ---------------------------------------------------------------------------
# fold order: the logs relax like the rebuilt graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("pool", [2, 4])
def test_log_relax_matches_rebuilt_graph(pool, fused):
    (bs, bd), (hs, hd), n = base_and_holdout(seed=1)
    jd, td = both(bs, bd, n, 4, pool)
    a, b = jd.apply_batch(hs, hd), td.apply_batch(hs, hd)
    g2 = from_coo(np.concatenate([bs, b.src]), np.concatenate([bd, b.dst]), n,
                  block_size=16, device="cpu")
    assert g2.m == td.m
    d_dyn, st_t = tbfs.bfs_dd_sparse(td, 0, fused=fused)
    assert torch.equal(d_dyn, tbfs.bfs_dd_sparse(g2, 0)[0])
    jdist, st_j = jbfs.bfs_dd_sparse(jd, 0, fused=fused)
    same(jdist, d_dyn)
    stats_equal(st_j, st_t)
    assert st_t.placement == "dynamic"


def test_log_only_shard_counts_live():
    n = 40
    src = np.arange(0, 20)
    dyn = dynamize(from_coo(src, (src + 1) % 20, n, block_size=8, device="cpu"),
                   nshards=4)
    assert int(dyn.base.out_deg[30]) == 0
    dyn.apply_batch([19, 30], [30, 35])   # 35 is reached only through 30
    d, _ = tbfs.bfs_dd_sparse(dyn, 0)
    assert float(d[30]) == 20.0 and float(d[35]) == 21.0


def test_pull_requires_compaction():
    src, dst, n, kw = ring(build_csc=True)
    dyn = dynamize(from_coo(src, dst, n, device="cpu", **kw), nshards=4)
    dyn.apply_batch([0], [5])
    assert not dyn.has_csc
    with pytest.raises(NotImplementedError):
        dyn.tiered_pull_dense(torch.zeros(dyn.n_pad), None, None, "min", True,
                              "torch")


# ---------------------------------------------------------------------------
# incremental bfs and cc
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("substrate", ["torch", "cuda"])
def test_bfs_cc_incremental_bitwise(substrate, fused):
    (bs, bd), (hs, hd), n = base_and_holdout(seed=2)
    jd, td = both(bs, bd, n, 4, 2, symmetrize=True)
    with tops.substrate_scope(substrate):
        dist, _ = tbfs.bfs_dd_sparse(td, 0)
        lab, _ = tcc.cc_dd_sparse(td)
        jdist, _ = jbfs.bfs_dd_sparse(jd, 0)
        jlab, _ = jcc.cc_dd_sparse(jd)
        for k in range(0, hs.size, 10):
            a = jd.apply_batch(hs[k:k + 10], hd[k:k + 10], symmetrize=True)
            b = td.apply_batch(hs[k:k + 10], hd[k:k + 10], symmetrize=True)
            dist, sb = tbfs.bfs_incremental(td, dist, b, fused=fused)
            lab, sc = tcc.cc_incremental(td, lab, b, fused=fused)
            jdist, jsb = jbfs.bfs_incremental(jd, jdist, a, fused=fused)
            jlab, jsc = jcc.cc_incremental(jd, jlab, a, fused=fused)
            same(jdist, dist)
            same(jlab, lab)
            stats_equal(jsb, sb)
            stats_equal(jsc, sc)
            assert torch.equal(dist, tbfs.bfs_dd_sparse(td, 0)[0])
            assert torch.equal(lab, tcc.cc_dd_sparse(td)[0])
        td.compact()
        assert td.log_sizes == [0] * td.nshards
        assert torch.equal(dist, tbfs.bfs_dd_sparse(td, 0)[0])
        assert torch.equal(lab, tcc.cc_dd_sparse(td)[0])


def test_incremental_touches_fewer_edges():
    (bs, bd), (hs, hd), n = base_and_holdout(seed=4, m=400, holdout=10)
    _, td = both(bs, bd, n, 4, symmetrize=True)
    dist, _ = tbfs.bfs_dd_sparse(td, 0)
    delta = td.apply_batch(hs, hd, symmetrize=True)
    _, inc = tbfs.bfs_incremental(td, dist, delta)
    _, scr = tbfs.bfs_dd_sparse(td, 0)
    assert inc.edges_touched < scr.edges_touched


edge_list = st.lists(st.tuples(st.integers(0, 39), st.integers(0, 39)),
                     min_size=1, max_size=80)
batch_list = st.lists(
    st.lists(st.tuples(st.integers(0, 39), st.integers(0, 39)),
             min_size=1, max_size=20),
    min_size=1, max_size=3)


def coo(edges, n, rng):
    src = np.array([e[0] % n for e in edges], np.int64)
    dst = np.array([e[1] % n for e in edges], np.int64)
    return src, dst, rng.uniform(1, 3, len(src)).astype(np.float32)


@settings(max_examples=15, deadline=None)
@given(n=st.integers(8, 40), base=edge_list, batches=batch_list,
       seed=st.integers(0, 2**31 - 1), nshards=st.integers(2, 5),
       pool=st.integers(2, 5), compact_at=st.integers(0, 3),
       substrate=st.sampled_from(["torch", "cuda"]), src0=st.integers(0, 39))
def test_incremental_bfs_cc_bitwise_property(n, base, batches, seed, nshards, pool,
                                             compact_at, substrate, src0):
    """Incremental bfs (weighted min relax) and cc equal the from-scratch
    runs bitwise after every batch, with a compaction at any point."""
    rng = np.random.default_rng(seed)
    bs, bd, bw = coo(base, n, rng)
    src0 %= n
    with tops.substrate_scope(substrate):
        dyn = dynamize(from_coo(bs, bd, n, bw, block_size=16, symmetrize=True,
                                device="cpu"),
                       nshards=nshards, resident_shards=pool)
        dist, _ = tbfs.bfs_dd_sparse(dyn, src0)
        lab, _ = tcc.cc_dd_sparse(dyn)
        for i, batch in enumerate(batches):
            if i == compact_at:
                dyn.compact()
            s, d, w = coo(batch, n, rng)
            delta = dyn.apply_batch(s, d, w, symmetrize=True)
            dist, _ = tbfs.bfs_incremental(dyn, dist, delta)
            lab, _ = tcc.cc_incremental(dyn, lab, delta)
            assert torch.equal(dist, tbfs.bfs_dd_sparse(dyn, src0)[0])
            assert torch.equal(lab, tcc.cc_dd_sparse(dyn)[0])
        dyn.compact()
        assert torch.equal(dist, tbfs.bfs_dd_sparse(dyn, src0)[0])
        assert torch.equal(lab, tcc.cc_dd_sparse(dyn)[0])


# ---------------------------------------------------------------------------
# incremental pagerank
# ---------------------------------------------------------------------------

def pr_base(seed=5, n=60, m=240, holdout=40):
    """A symmetrized ring plus random edges (no dangling vertex, so push and
    the oracle's power iteration share a fixed point) and a held-out tail."""
    (bs, bd), (hs, hd), n = base_and_holdout(seed, n, m, holdout)
    ring_s = np.arange(n)
    return (np.concatenate([bs, ring_s]), np.concatenate([bd, (ring_s + 1) % n])), \
        (hs, hd), n


def port_replay(bs, bd, n, hs, hd, *, pool, fused=True, tol=1e-7, step=20,
                substrate="torch"):
    with tops.substrate_scope(substrate), tops.deterministic_add_scope(True):
        dyn = dynamize(from_coo(bs, bd, n, block_size=16, symmetrize=True,
                                device="cpu"),
                       nshards=4, resident_shards=pool)
        _, _, state = tpr.pr_incremental(dyn, tol=tol)
        for k in range(0, hs.size, step):
            delta = dyn.apply_batch(hs[k:k + step], hd[k:k + step], symmetrize=True)
            _, _, state = tpr.pr_incremental(dyn, delta, state, tol=tol)
        rank, _, _ = tpr.pr_incremental(dyn, state=state, tol=tol)
    return dyn, state, rank


def test_pr_incremental_allclose_to_scratch_reference_and_oracle():
    (bs, bd), (hs, hd), n = pr_base()
    dyn, state, rank = port_replay(bs, bd, n, hs, hd, pool=4, tol=1e-10)
    with tops.deterministic_add_scope(True):
        scratch, _ = tpr.pr_push(dyn, tol=1e-10)
    torch.testing.assert_close(rank, scratch, rtol=1e-3, atol=1e-6)
    with jops.deterministic_add_scope(True):
        jd = jdynamize(jfrom_coo(bs, bd, n, block_size=16, symmetrize=True),
                       nshards=4, resident_shards=4)
        _, _, js = jpr.pr_incremental(jd, tol=1e-10)
        for k in range(0, hs.size, 20):
            delta = jd.apply_batch(hs[k:k + 20], hd[k:k + 20], symmetrize=True)
            _, _, js = jpr.pr_incremental(jd, delta, js, tol=1e-10)
        jrank, _, _ = jpr.pr_incremental(jd, state=js, tol=1e-10)
    np.testing.assert_allclose(rank.numpy(), np.asarray(jrank), rtol=1e-4, atol=1e-10)
    # the merged edge list: the base cut's valid edges and the logs
    parts = [(s[:k], d[:k]) for (s, d, _), k in zip(dyn.base._host,
                                                    dyn.base.shard_sizes)]
    parts += [(s, d) for s, d, _ in dyn._log]
    ms = np.concatenate([p[0] for p in parts]).astype(np.int64)
    md = np.concatenate([p[1] for p in parts]).astype(np.int64)
    assert ms.size == dyn.m
    ref = oracles.pagerank(ms, md, n, tol=1e-12, iters=2000)
    np.testing.assert_allclose(rank.numpy()[:n], ref, rtol=2e-3, atol=1e-8)


@pytest.mark.parametrize("fused", [True, False])
def test_pr_incremental_det_replay_bitwise_across_pools(fused):
    """The reference's own contract (``pagerank.pr_incremental``), which
    its ``tests/test_dynamic.py:191`` fails: the det-add replay's state is
    bitwise equal at pools of 4 and 2."""
    (bs, bd), (hs, hd), n = base_and_holdout(seed=5)
    results = [port_replay(bs, bd, n, hs, hd, pool=pool) for pool in (4, 2)]
    (_, s4, r4), (_, s2, r2) = results
    assert torch.equal(s4.rank, s2.rank) and torch.equal(s4.resid, s2.resid)
    assert torch.equal(r4, r2)


def test_pr_cold_bitwise_across_pool_and_substrate():
    (bs, bd), (hs, hd), n = base_and_holdout(seed=6)
    ranks = []
    for pool, substrate in [(2, "torch"), (4, "torch"), (4, "cuda")]:
        with tops.substrate_scope(substrate), tops.deterministic_add_scope(True):
            dyn = dynamize(from_coo(bs, bd, n, block_size=16, device="cpu"),
                           nshards=4, resident_shards=pool)
            dyn.apply_batch(hs, hd)
            ranks.append(tpr.pr_incremental(dyn, tol=1e-7)[0])
    assert all(torch.equal(ranks[0], r) for r in ranks[1:])


@settings(max_examples=10, deadline=None)
@given(n=st.integers(8, 30), base=edge_list, batches=batch_list,
       seed=st.integers(0, 2**31 - 1), nshards=st.integers(2, 4),
       pools=st.tuples(st.integers(2, 4), st.integers(2, 4)))
def test_incremental_pagerank_det_add_invariant(n, base, batches, seed, nshards, pools):
    """Any batch sequence replays bitwise at any two pool sizes under
    deterministic add, and the warm rank lands allclose to scratch."""
    rng = np.random.default_rng(seed)
    bs, bd, bw = coo(base, n, rng)
    arrays = [coo(b, n, np.random.default_rng(seed + 1 + i))
              for i, b in enumerate(batches)]

    def replay(pool):
        with tops.deterministic_add_scope(True):
            dyn = dynamize(from_coo(bs, bd, n, bw, block_size=16, device="cpu"),
                           nshards=nshards, resident_shards=pool)
            _, _, state = tpr.pr_incremental(dyn, tol=1e-6, max_iters=500)
            for s, d, w in arrays:
                delta = dyn.apply_batch(s, d, w)
                _, _, state = tpr.pr_incremental(dyn, delta, state, tol=1e-6,
                                                 max_iters=500)
            rank, _, _ = tpr.pr_incremental(dyn, state=state, tol=1e-6,
                                            max_iters=500)
        return state, rank, dyn

    sa, ra, dyn = replay(pools[0])
    sb, rb, _ = replay(pools[1])
    assert torch.equal(sa.rank, sb.rank) and torch.equal(sa.resid, sb.resid)
    assert torch.equal(ra, rb)
    with tops.deterministic_add_scope(True):
        scratch, _ = tpr.pr_push(dyn, tol=1e-6, max_iters=500)
    torch.testing.assert_close(ra, scratch, rtol=1e-3, atol=1e-5)


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("csc", [False, True])
def test_compact_equals_from_coo_tier_graph(csc):
    (bs, bd), (hs, hd), n = base_and_holdout(seed=7)
    w = np.random.default_rng(7).uniform(1, 3, bs.size).astype(np.float32)
    jd, td = both(bs, bd, n, 4, 2, w=w, build_csc=csc)
    hw = np.random.default_rng(8).uniform(1, 3, hs.size).astype(np.float32)
    a, b = jd.apply_batch(hs, hd, hw), td.apply_batch(hs, hd, hw)
    before = tbfs.bfs_dd_sparse(td, 0)[0]
    td.compact()
    jd.compact()
    assert td.log_sizes == [0] * 4 and td.m == jd.m
    assert torch.equal(before, tbfs.bfs_dd_sparse(td, 0)[0])
    merged = from_coo(np.concatenate([bs, b.src]), np.concatenate([bd, b.dst]), n,
                      np.concatenate([w, b.w]), block_size=16, build_csc=csc,
                      device="cpu")
    want = tier_graph(merged, 4, 2, build_csc=csc)
    got = td.base
    assert (got.epd, got.m) == (want.epd, want.m)
    np.testing.assert_array_equal(got.vtx_bounds, want.vtx_bounds)
    np.testing.assert_array_equal(got.shard_sizes, want.shard_sizes)
    assert got.shard_crcs == want.shard_crcs == list(jd.base.shard_crcs)
    for host in (("_host",) + (("_csc_host",) if csc else ())):
        for x, y, z in zip(getattr(got, host), getattr(want, host),
                           getattr(jd.base, host)):
            for u, v, r in zip(x, y, z):
                np.testing.assert_array_equal(u, v)
                np.testing.assert_array_equal(u, np.asarray(r))
    assert torch.equal(got.out_deg, want.out_deg)
    assert torch.equal(td.out_deg, want.out_deg)


# ---------------------------------------------------------------------------
# the v3 store, across packages
# ---------------------------------------------------------------------------

def test_port_opens_reference_v3_store(tmp_path):
    (bs, bd), (hs, hd), n = base_and_holdout(seed=7)
    jck.save_graph(jfrom_coo(bs, bd, n, block_size=16), str(tmp_path), nshards=4)
    jd = jck.open_dynamic(str(tmp_path), resident_shards=2)
    jd.apply_batch(hs, hd)
    jck.save_dynamic(jd, str(tmp_path))
    td = tck.open_dynamic(str(tmp_path), resident_shards=2, device="cpu")
    assert isinstance(td, DynamicGraph) and td.m == jd.m
    logs_equal(jd, td)
    same(jd.out_deg, td.out_deg)
    same(jbfs.bfs_dd_sparse(jd, 0)[0], tbfs.bfs_dd_sparse(td, 0)[0])


def test_reference_opens_port_v3_store(tmp_path):
    (bs, bd), (hs, hd), n = base_and_holdout(seed=8)
    tck.save_graph(from_coo(bs, bd, n, block_size=16, device="cpu"), str(tmp_path),
                   nshards=4)
    td = tck.open_dynamic(str(tmp_path), device="cpu")
    assert td.log_sizes == [0, 0, 0, 0]    # a v2 store opens with empty logs
    td.apply_batch(hs, hd)
    tck.save_dynamic(td, str(tmp_path))
    jd = jck.open_dynamic(str(tmp_path))
    assert jd.m == td.m
    logs_equal(jd, td)
    same(jbfs.bfs_dd_sparse(jd, 0)[0], tbfs.bfs_dd_sparse(td, 0)[0])
    with pytest.raises(ValueError, match="open_dynamic"):
        tck.open_graph(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="pending edge-log deltas"):
        jck.open_graph(str(tmp_path))
    # after compaction the logs drain and the plain open works again
    td.compact()
    tck.save_dynamic(td, str(tmp_path))
    assert tck.open_graph(str(tmp_path), device="cpu").m == td.m
    assert jck.open_graph(str(tmp_path)).m == td.m


def test_save_dynamic_reuses_base_shards(tmp_path):
    (bs, bd), (hs, hd), n = base_and_holdout(seed=9)
    _, td = both(bs, bd, n, 4, 2)
    tck.save_dynamic(td, str(tmp_path))

    def mtimes():
        return [os.path.getmtime(tmp_path / f) for f in sorted(os.listdir(tmp_path))
                if f.startswith("shard_")]

    mt0 = mtimes()
    td.apply_batch(hs, hd)
    tck.save_dynamic(td, str(tmp_path))
    assert mtimes() == mt0
    assert tck.open_dynamic(str(tmp_path), device="cpu").m == td.m


def test_corrupt_log_refused(tmp_path):
    (bs, bd), (hs, hd), n = base_and_holdout(seed=10)
    _, td = both(bs, bd, n, 4, 2)
    td.apply_batch(hs, hd)
    tck.save_dynamic(td, str(tmp_path))
    logf = next(tmp_path / f for f in sorted(os.listdir(tmp_path))
                if f.startswith("log_"))
    data = dict(np.load(logf))
    data["w"] = data["w"] + 1.0
    with open(logf, "wb") as f:
        np.savez(f, **data)
    with pytest.raises(ShardCorruptError, match="log shard"):
        tck.open_dynamic(str(tmp_path), device="cpu")
    assert tck.open_dynamic(str(tmp_path), verify="off", device="cpu").m == td.m


# ---------------------------------------------------------------------------
# the suite
# ---------------------------------------------------------------------------

def test_dynamic_suite_rows_match_reference():
    from benchmarks import dynamic as jsuite
    from repro_torch.benchmarks import dynamic as tsuite

    trows = {r[0]: r for r in tsuite.run(device="cpu")}
    jrows = {r[0]: r for r in jsuite.run()}
    assert list(trows) == list(jrows)
    flags = {"dynamic/stream_incremental": ("bitwise_equal",),
             "dynamic/pr_incremental": ("allclose", "det_bitwise"),
             "dynamic/compact": ("bitwise_after_compact", "roundtrip_equal")}
    for name, keys in flags.items():
        for key in keys:
            assert trows[name][3][key] == 1, (name, key)
    for name in ("dynamic/stream_incremental", "dynamic/stream_recompute",
                 "dynamic/pr_incremental"):
        assert trows[name][3]["edges_touched"] == jrows[name][3]["edges_touched"], name
    for name, key in (("dynamic/stream_incremental", "inserts"),
                      ("dynamic/compact", "m"), ("dynamic/compact", "budget_ratio")):
        assert trows[name][3][key] == jrows[name][3][key], (name, key)


@pytest.mark.parametrize("broken", [False, True])
def test_dynamic_suite_depth_cuts_and_allclose_flag(monkeypatch, broken):
    """The suite's two depth cuts: the replays over the first batch only,
    and with ``det_iters`` a capped cross-pool pair beside the converged
    replay, which is still the one held to scratch.  A ``pr_incremental``
    that drops the batch's correction sets ``allclose`` to 0 and leaves
    ``det`` at 1 (both pools run the same wrong sum)."""
    from repro_torch.benchmarks import dynamic as tsuite

    if broken:
        monkeypatch.setattr(tpr, "_delta_correction",
                            lambda g, delta, rank, resid, damping: resid)
    lines = []
    rows = {r[0]: r[3] for r in tsuite.run(pr_batches=1, det_iters=5, device="cpu",
                                           log=lines.append)}
    assert rows["dynamic/pr_incremental"]["allclose"] == int(not broken)
    assert rows["dynamic/pr_incremental"]["det_bitwise"] == 1
    replays = [line for line in lines if line.startswith("pagerank replay")]
    assert [line.split(",")[0] for line in replays] == [
        "pagerank replay at a pool of 4", "pagerank replay at a pool of 4",
        "pagerank replay at a pool of 8"]
    assert ["at most 300 rounds" in line for line in replays] == [True, False, False]
    assert all("rounds per solve [5, 5, 5]" in line for line in replays[1:])


def test_pr_atol_is_the_reference_suites_at_its_size_and_scales_with_n():
    """``allclose``'s atol is the JAX suite's 1e-6 on its rmat(10, 12) and
    shrinks with the mean rank 1/n: at n = 2^22 ranks a few percent off
    pass 1e-6 but not the scaled atol."""
    from repro_torch.benchmarks import dynamic as tsuite

    assert tsuite.pr_atol(1024) == 1e-6
    n = 1 << 22
    rank = torch.from_numpy(np.random.default_rng(0).uniform(0.5, 1.5, n) / n)
    off = rank * 1.03
    assert torch.allclose(off, rank, rtol=tsuite.PR_RTOL, atol=1e-6)
    assert not torch.allclose(off, rank, rtol=tsuite.PR_RTOL, atol=tsuite.pr_atol(n))
