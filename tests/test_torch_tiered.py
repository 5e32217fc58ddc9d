"""The port's out-of-core tier (``repro_torch.core.tiered``) against the
JAX package's (``repro.core.tiered``), case by case after
``tests/test_tiered.py`` and ``tests/test_tiered_properties.py``.

Each case builds its graph once from a seed with numpy, runs the
reference and the port on the same arrays, and holds:

* streamed ≡ all-resident pool ≡ plain ``Graph`` labels, bitwise for min;
* pagerank bitwise across pool sizes (deterministic add: fused against
  eager too) and allclose to the plain graph;
* reversed pushes and CSC pulls bitwise;
* ``h2d_bytes == shards_streamed × shard_bytes`` exactly, edges charged by
  valid shard sizes (uneven padding included), and every counter equal to
  the reference's;
* injected read faults: retries counted, corrupt shards refused.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import faultio as jfault  # noqa: E402
from repro.core import from_coo as jfrom_coo  # noqa: E402
from repro.core import operators as jops  # noqa: E402
from repro.core import tier_graph as jtier  # noqa: E402
from repro.core.algorithms import bfs as jbfs  # noqa: E402
from repro.core.algorithms import cc as jcc  # noqa: E402
from repro.core.algorithms import kcore as jkcore  # noqa: E402
from repro.core.algorithms import pagerank as jpr  # noqa: E402
from repro.core.algorithms import sssp as jsssp  # noqa: E402
from repro.core.graph import shard_ranges as jshard_ranges  # noqa: E402
from repro.graphs import generators as gen  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import faultio as tfault  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core import tiered as ttiered  # noqa: E402
from repro_torch.core.algorithms import bfs as tbfs  # noqa: E402
from repro_torch.core.algorithms import cc as tcc  # noqa: E402
from repro_torch.core.algorithms import kcore as tkcore  # noqa: E402
from repro_torch.core.algorithms import pagerank as tpr  # noqa: E402
from repro_torch.core.algorithms import sssp as tsssp  # noqa: E402
from repro_torch.core.graph import shard_ranges as tshard_ranges  # noqa: E402
from repro_torch.distributed import fault as tdfault  # noqa: E402
from test_torch_graph import port_graph  # noqa: E402

ttier = ttiered.tier_graph


def graphs(seed=3, n=300, m=2500, block=32, csc=False, sym=False):
    """(reference graph, port graph) on the same arrays."""
    src, dst, n = gen.erdos(n, m, seed=seed)
    w = np.random.default_rng(seed).uniform(0.5, 3.0, len(src)).astype(np.float32)
    jg = jfrom_coo(src, dst, n, None if sym else w, block_size=block,
                   build_csc=csc, symmetrize=sym)
    return jg, port_graph(jg)


def same(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def stats_equal(js, ts):
    """Every RunStats counter equal but ``substrate`` and ``io_wait_us``
    (the miss path's wall time)."""
    a, b = js.as_dict(), ts.as_dict()
    for key in ("substrate", "io_wait_us"):
        a.pop(key), b.pop(key)
    assert a == b


# ---------------------------------------------------------------------------
# shard cut + budget accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nshards", [2, 6, 8])
def test_cut_matches_reference(nshards):
    jg, tg = graphs(csc=True)
    jv, je = jshard_ranges(jg, nshards)
    tv, te = tshard_ranges(tg, nshards)
    np.testing.assert_array_equal(jv, tv)
    np.testing.assert_array_equal(je, te)
    a = jtier(jg, nshards=nshards, resident_shards=2, build_csc=True)
    b = ttier(tg, nshards=nshards, resident_shards=2, build_csc=True)
    assert (a.epd, a.shard_bytes, a.csr_bytes, a.resident_budget) == (
        b.epd, b.shard_bytes, b.csr_bytes, b.resident_budget)
    assert a.shard_crcs == b.shard_crcs and a.in_shard_crcs == b.in_shard_crcs
    for x, y in zip(a._host + a._csc_host, b._host + b._csc_host):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(np.asarray(u), v)
    np.testing.assert_array_equal(a.shard_sizes, b.shard_sizes)
    np.testing.assert_array_equal(np.asarray(a.owner), b.owner.numpy())
    assert b.placement == "tiered" and b.m_pad == nshards * b.epd


def test_tier_graph_budget_vs_csr():
    _, g = graphs()
    tg = ttier(g, nshards=8, resident_shards=2)
    assert tg.csr_bytes == tg.nshards * tg.shard_bytes
    assert tg.resident_budget == 2 * tg.shard_bytes
    assert tg.csr_bytes >= 4 * tg.resident_budget
    with pytest.raises(ValueError):
        ttier(g, nshards=8, resident_shards=1)  # no double buffer
    assert ttier(g, nshards=8, resident_bytes=3 * tg.shard_bytes).resident_shards == 3


# ---------------------------------------------------------------------------
# streamed == resident == in-memory, against the reference
# ---------------------------------------------------------------------------

def _counted_fetches(tg):
    fetched = []
    orig = tg._fetch

    def counting(sid, direction="csr"):
        fetched.append(sid)
        return orig(sid, direction)

    tg._fetch = counting
    return fetched


@pytest.mark.parametrize("seed,nshards,pool,src", [
    (3, 8, 2, 0), (3, 8, 3, 5), (3, 8, 8, 0), (7, 5, 2, 11), (8, 7, 4, 2),
    (21, 4, 2, 1), (30, 2, 2, 0)])
def test_bfs_streamed_bitwise_fused_eager_resident(seed, nshards, pool, src):
    """streamed bfs labels ≡ the plain Graph's in both regimes, with the
    stream accounting exact and every counter the reference's."""
    jg, g = graphs(seed=seed, n=120 + seed, m=900)
    plain, _ = tbfs.bfs_dd_sparse(g, src)
    for fused in (False, True):
        jt = jtier(jg, nshards=nshards, resident_shards=pool)
        tg = ttier(g, nshards=nshards, resident_shards=pool)
        fetched = _counted_fetches(tg) if not fused else None
        jlab, jst = jbfs.bfs_dd_sparse(jt, src, fused=fused)
        lab, st = tbfs.bfs_dd_sparse(tg, src, fused=fused)
        assert torch.equal(plain, lab)
        same(jlab, lab)
        stats_equal(jst, st)
        assert st.placement == "tiered" and st.rounds > 0
        assert st.h2d_bytes == st.shards_streamed * tg.shard_bytes
        if fetched is not None:
            assert st.buffer_hits + st.shards_streamed == len(fetched)
            assert st.edges_touched == (
                int(tg.shard_sizes[np.asarray(fetched)].sum()) if fetched else 0)


@pytest.mark.parametrize("algo", ["sssp", "cc", "kcore", "bfs_topo", "bfs_dd_dense"])
def test_engine_algorithms_stream_like_reference(algo):
    """sssp, cc and kcore reach ``_run_streamed`` through their ladder
    engines, bfs_topo and bfs_dd_dense ``run_streamed`` directly: labels
    bitwise equal to the plain graph and the reference, counters equal."""
    sym = algo in ("cc", "kcore")
    jg, g = graphs(seed=12, n=200, m=1500, sym=sym)
    port, ref = {
        "sssp": (lambda x: tsssp.sssp_dd_sparse(x, 0), lambda x: jsssp.sssp_dd_sparse(x, 0)),
        "cc": (tcc.cc_dd_sparse, jcc.cc_dd_sparse),
        "kcore": (lambda x: tkcore.kcore_dd_sparse(x, 14),
                  lambda x: jkcore.kcore_dd_sparse(x, 14)),
        "bfs_topo": (lambda x: tbfs.bfs_topo(x, 0), lambda x: jbfs.bfs_topo(x, 0)),
        "bfs_dd_dense": (lambda x: tbfs.bfs_dd_dense(x, 0),
                         lambda x: jbfs.bfs_dd_dense(x, 0)),
    }[algo]
    plain, _ = port(g)
    tg = ttier(g, nshards=5, resident_shards=2)
    lab, st = port(tg)
    jlab, jst = ref(jtier(jg, nshards=5, resident_shards=2))
    assert torch.equal(plain, lab)
    same(jlab, lab)
    stats_equal(jst, st)
    assert st.h2d_bytes == st.shards_streamed * tg.shard_bytes > 0


@pytest.mark.parametrize("seed,nshards", [(9, 8), (4, 5), (17, 3)])
def test_pagerank_bitwise_across_pools_allclose_vs_plain(seed, nshards):
    jg, g = graphs(seed=seed)
    ref = tpr.pr_push(g, max_iters=80)[0]
    outs = [tpr.pr_push(ttier(g, nshards=nshards, resident_shards=pool),
                        max_iters=80)[0] for pool in (2, 4, nshards)]
    # the ascending-shard fold is a pure function of the cut, not the pool
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    np.testing.assert_allclose(outs[0].numpy(), ref.numpy(), rtol=1e-5, atol=1e-8)
    jout = jpr.pr_push(jtier(jg, nshards=nshards, resident_shards=2),
                       max_iters=80)[0]
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-8)


def _pr_push_eager(tg, iters, damping=0.85, tol=1e-9):
    """pr_push with the staged stretches off (``run_streamed(fused=False)``),
    normalised as ``pr_push`` does."""
    valid = tg.valid_vertex_mask()
    step, cond, active = tpr._pr_streamed_fns(damping, tol)
    state0 = (torch.zeros(tg.n_pad), torch.where(valid, 1.0 - damping, 0.0))
    _, (rank, resid) = teng.run_streamed(tg, step, state0, cond, active, iters,
                                         fused=False)
    rank = rank + resid
    return torch.where(valid, rank / rank.sum(), 0.0)


@pytest.mark.parametrize("seed,nshards,pool", [(9, 4, 2), (5, 5, 3), (2, 3, 3)])
def test_pagerank_det_add_bitwise_across_regimes_and_reference(seed, nshards, pool):
    """Under deterministic add, streamed pagerank is bitwise equal fused
    against eager and across pools, and its raw (rank, residual) pair to
    the reference's streamed run (the final normalising sums are each
    framework's own reduction)."""
    jg, g = graphs(seed=seed, n=90, m=600)
    with tops.deterministic_add_scope(True), jops.deterministic_add_scope(True):
        fused = tpr.pr_push(ttier(g, nshards=nshards, resident_shards=pool),
                            max_iters=40)[0]
        eager = _pr_push_eager(ttier(g, nshards=nshards, resident_shards=pool), 40)
        whole = tpr.pr_push(ttier(g, nshards=nshards, resident_shards=nshards),
                            max_iters=40)[0]
        raw = tpr._pr_push_raw(ttier(g, nshards=nshards, resident_shards=pool),
                               0.85, 1e-9, 40)
        jraw = jpr._pr_push_raw(jtier(jg, nshards=nshards, resident_shards=pool),
                                0.85, 1e-9, 40)
    assert torch.equal(fused, eager) and torch.equal(fused, whole)
    same(jraw[0], raw[0])
    same(jraw[1], raw[1])
    assert int(jraw[2]) == raw[2]


def test_reverse_push_streams_all_shards():
    jg, g = graphs(seed=4)
    jt = jtier(jg, nshards=4, resident_shards=2)
    tg = ttier(g, nshards=4, resident_shards=2)
    vals = np.random.default_rng(0).uniform(0, 5, g.n_pad).astype(np.float32)
    active = g.valid_vertex_mask()
    tv = torch.from_numpy(vals)
    for kind in ("min", "max", "add"):
        want = tops.push_dense(g, tv, active, tv, kind=kind, reverse=True)
        got = tops.push_dense(tg, tv, active, tv, kind=kind, reverse=True)
        jgot = jops.push_dense(jt, jnp.asarray(vals), jg.valid_vertex_mask(),
                               jnp.asarray(vals), kind=kind, reverse=True)
        if kind == "add":
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)
            np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-5)
        else:
            assert torch.equal(want, got)
            same(jgot, got)
    # reverse activates on destinations → every shard was scheduled, and
    # the charge is each shard's valid edges (= m a relax), never epd slots
    assert tg.io.edges_relaxed == 3 * g.m == jt.io.edges_relaxed
    assert g.m < tg.nshards * tg.epd  # the cut really pads


def test_pull_refused_without_csc_mirror():
    _, g = graphs()
    tg = ttier(g, nshards=4)
    with pytest.raises(NotImplementedError, match="build_csc=True"):
        tops.pull_dense(tg, tg.vertex_full(0.0, torch.float32),
                        tg.valid_vertex_mask(),
                        tg.vertex_full(0.0, torch.float32), kind="min")
    with pytest.raises(ValueError, match="build_csc=True"):
        ttier(g, nshards=4, build_csc=True)
    with pytest.raises(NotImplementedError, match="out-of-core"):
        tops.relax_edges(tg, tg.vertex_full(0.0, torch.float32),
                         torch.ones(tg.m_pad, dtype=torch.bool),
                         tg.vertex_full(0.0, torch.float32))


@pytest.mark.parametrize("kind", ["min", "max", "add"])
def test_tiered_pull_bitwise_vs_resident(kind):
    jg, g = graphs(seed=17, csc=True)
    vals = np.random.default_rng(1).uniform(0, 5, g.n_pad).astype(np.float32)
    tv = torch.from_numpy(vals)
    active = g.valid_vertex_mask()
    init = g.vertex_full(0.0 if kind == "add" else 1e9, torch.float32)
    want = tops.pull_dense(g, tv, active, init, kind=kind)
    tg = ttier(g, nshards=4, resident_shards=2, build_csc=True)
    got = tops.pull_dense(tg, tv, active, init, kind=kind)
    jt = jtier(jg, nshards=4, resident_shards=2, build_csc=True)
    jgot = jops.pull_dense(jt, jnp.asarray(vals), jg.valid_vertex_mask(),
                           jnp.asarray(init.numpy()), kind=kind)
    if kind == "add":
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)
    else:
        assert torch.equal(want, got)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-6)
    assert tg.io.edges_relaxed == g.m
    assert tg.io.h2d_bytes == tg.io.shards_streamed * tg.shard_bytes


def test_bfs_dirop_and_pr_pull_stream_the_csc_mirror():
    jg, g = graphs(seed=18, csc=True)
    tg = ttier(g, nshards=6, resident_shards=2, build_csc=True)
    jt = jtier(jg, nshards=6, resident_shards=2, build_csc=True)
    ref, rst = tbfs.bfs_dirop(g, 0)
    got, sst = tbfs.bfs_dirop(tg, 0)
    jgot, jst = jbfs.bfs_dirop(jt, 0)
    assert torch.equal(ref, got)
    same(jgot, got)
    stats_equal(jst, sst)
    # identical direction switches and the work convention
    assert (sst.rounds, sst.pull_rounds, sst.edges_touched) == (
        rst.rounds, rst.pull_rounds, rst.edges_touched)
    assert sst.pull_rounds > 0
    assert sst.h2d_bytes == sst.shards_streamed * tg.shard_bytes
    pr, pst = tpr.pr_pull(tg)
    jpr_, jpst = jpr.pr_pull(jt)
    np.testing.assert_allclose(pr.numpy(), tpr.pr_pull(g)[0].numpy(),
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jpr_), rtol=1e-5, atol=1e-8)
    stats_equal(jpst, pst)


# ---------------------------------------------------------------------------
# streaming accounting: the analytic h2d model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pool", [2, 3])
def test_h2d_matches_analytic_model_exactly(pool):
    jg, g = graphs(seed=11)
    tg = ttier(g, nshards=8, resident_shards=pool)
    fetched = _counted_fetches(tg)
    _, stats = tbfs.bfs_dd_sparse(tg, 0, fused=False)
    assert stats.h2d_bytes == stats.shards_streamed * tg.shard_bytes
    assert stats.buffer_hits + stats.shards_streamed == len(fetched)
    assert stats.edges_touched == int(tg.shard_sizes[np.asarray(fetched)].sum())
    # fused streaming changes fetches only: identical h2d model and work
    tf = ttier(g, nshards=8, resident_shards=pool)
    _, fstats = tbfs.bfs_dd_sparse(tf, 0, fused=True)
    assert fstats.h2d_bytes == fstats.shards_streamed * tf.shard_bytes
    assert (fstats.h2d_bytes, fstats.shards_streamed, fstats.edges_touched) == (
        stats.h2d_bytes, stats.shards_streamed, stats.edges_touched)


def test_streamed_edge_accounting_matches_resident_with_uneven_padding():
    """Shards pad unevenly; bfs_topo activates every vertex every round, so
    the streamed run charges exactly the resident rounds·m."""
    jg, g = graphs(seed=21)
    tg = ttier(g, nshards=4, resident_shards=2)
    assert len({int(s) for s in tg.shard_sizes}) > 1  # genuinely uneven
    assert int(tg.shard_sizes.sum()) == g.m < tg.nshards * tg.epd
    ref, rst = tbfs.bfs_topo(g, 0)
    got, sst = tbfs.bfs_topo(tg, 0)
    assert torch.equal(ref, got)
    assert rst.edges_touched == rst.rounds * g.m
    assert (sst.rounds, sst.edges_touched) == (rst.rounds, rst.edges_touched)
    stats_equal(jbfs.bfs_topo(jtier(jg, nshards=4, resident_shards=2), 0)[1], sst)


def test_all_resident_pool_streams_each_shard_at_most_once():
    _, g = graphs(seed=12)
    tg = ttier(g, nshards=8, resident_shards=8)
    _, s1 = tbfs.bfs_dd_sparse(tg, 0)
    assert s1.shards_streamed <= tg.nshards  # cold fills only
    _, s2 = tbfs.bfs_dd_sparse(tg, 1)
    assert s2.shards_streamed == 0 and s2.h2d_bytes == 0 and s2.buffer_hits > 0


def test_fused_streaming_fetches_scale_with_live_set_switches():
    """On a path graph the live-shard set changes only when the frontier
    crosses a shard boundary: the fused streamed run fetches O(switches)
    times, the eager one once a round, with equal labels."""
    src, dst, n = gen.path(256)
    jg = jfrom_coo(src, dst, n, block_size=16)
    g = port_graph(jg)
    before = teng.fetch.calls
    dist, st = tbfs.bfs_dd_sparse(ttier(g, nshards=4, resident_shards=2), 0)
    fused = teng.fetch.calls - before
    assert st.rounds >= n - 2
    assert fused <= 24, (fused, st.rounds)
    before = teng.fetch.calls
    dist_p, st_p = tbfs.bfs_dd_sparse(ttier(g, nshards=4, resident_shards=2), 0,
                                      fused=False)
    eager = teng.fetch.calls - before
    assert eager >= st_p.rounds
    assert torch.equal(dist, dist_p)
    assert fused * 8 <= eager
    stats_equal(jbfs.bfs_dd_sparse(jtier(jg, nshards=4, resident_shards=2), 0)[1], st)


# ---------------------------------------------------------------------------
# faults: retries, corruption
# ---------------------------------------------------------------------------

def test_stream_accounting_exact_under_injected_retries():
    """A healed miss charges one shard_bytes however many attempts it took,
    as in the reference under the same plan."""
    jg, g = graphs(seed=14)
    ref_dist, ref_st = tbfs.bfs_dd_sparse(ttier(g, nshards=6, resident_shards=2), 0)
    plan = lambda m: [m.eio("shard_read", at=0, times=1),  # noqa: E731
                      m.eio("shard_read", at=4, times=2)]
    tg = ttier(g, nshards=6, resident_shards=2)
    tg.set_fault_injector(tfault.FaultInjector(plan(tfault)))
    dist, st = tbfs.bfs_dd_sparse(tg, 0)
    jt = jtier(jg, nshards=6, resident_shards=2)
    jt.set_fault_injector(jfault.FaultInjector(plan(jfault)))
    jdist, jst = jbfs.bfs_dd_sparse(jt, 0)
    assert torch.equal(ref_dist, dist)
    same(jdist, dist)
    assert st.io_retries == 3 == jst.io_retries
    assert st.h2d_bytes == st.shards_streamed * tg.shard_bytes
    assert (st.shards_streamed, st.buffer_hits) == (ref_st.shards_streamed,
                                                    ref_st.buffer_hits)
    assert tg.fault.fired_kinds() == {"eio": 3}


@pytest.mark.parametrize("kind", ["bitflip", "torn"])
def test_corrupt_read_heals_or_raises(kind):
    """A corrupt read is caught by the CRC: one bad read heals on retry
    (counted), a persistent one raises ShardCorruptError and nothing of it
    reaches the labels."""
    _, g = graphs(seed=15)
    ref, _ = tbfs.bfs_dd_sparse(g, 0)
    make = getattr(tfault, kind)
    tg = ttier(g, nshards=4, resident_shards=2)
    tg.set_fault_injector(tfault.FaultInjector([make("shard_read", at=0, times=1)]))
    got, st = tbfs.bfs_dd_sparse(tg, 0)
    assert torch.equal(ref, got)
    assert st.checksum_failures == 1 and st.io_retries == 1
    bad = ttier(g, nshards=4, resident_shards=2)
    bad.set_fault_injector(tfault.FaultInjector([make("shard_read", key=0)]))
    with pytest.raises(tfault.ShardCorruptError, match="csr shard 0"):
        tbfs.bfs_dd_sparse(bad, 0)
    assert bad.io.checksum_failures == 3   # the first read and two retries


def test_round_fault_ticks_force_eager_rounds():
    _, g = graphs(seed=16)
    tg = ttier(g, nshards=4, resident_shards=2)
    inj = tfault.FaultInjector([tfault.delay("round", 0.0, at=1)])
    tg.set_fault_injector(inj)
    _, st = tbfs.bfs_dd_sparse(tg, 0)
    assert inj.calls("round") == st.rounds
    assert inj.fired_kinds() == {"delay": 1}


def test_fault_modules_match_reference():
    """The port's copies of faultio and the retry policy behave as the
    reference's: the same plan fires the same faults on the same calls,
    corrupts the same bits, and the backoff schedule is the same."""
    plan = lambda m: [m.bitflip("shard_read", at=1, times=2, key=3),  # noqa: E731
                      m.torn("shard_read", at=0, times=1, key=1),
                      m.delay("round", 0.0, at=2)]
    arrays = (np.arange(64, dtype=np.int32), np.arange(64, dtype=np.int32)[::-1].copy(),
              np.linspace(0, 1, 64, dtype=np.float32))
    a, b = jfault.FaultInjector(plan(jfault), seed=5), tfault.FaultInjector(plan(tfault), seed=5)
    for sid in (3, 1, 3, 3, 1, 0):
        for x, y in zip(a.shard_read(sid, *arrays), b.shard_read(sid, *arrays)):
            np.testing.assert_array_equal(x, y)
    for r in range(4):
        a.tick("round", key=r), b.tick("round", key=r)
    assert a.fired == b.fired
    with pytest.raises(ValueError):
        tfault.FaultSpec(op="x", kind="melt")
    from repro.distributed import fault as jdfault

    kw = dict(max_retries=4, base_delay_s=0.5, max_delay_s=3.0)
    assert tdfault.RetryPolicy(**kw).delays() == jdfault.RetryPolicy(**kw).delays()
    calls = []
    pol = tdfault.RetryPolicy(max_retries=2, base_delay_s=0.0, retryable=(OSError,))

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("eio")
        return "ok"

    assert pol.run(flaky) == "ok" and len(calls) == 3
    mon = tdfault.StragglerMonitor(threshold=2.0, patience=2)
    flags = [mon.observe(t) for t in [1.0] * 8 + [5.0, 5.0]]
    assert flags[-1] and not any(flags[:-1])
    assert tdfault.ElasticPolicy().choose(70) == (8, 8)


# ---------------------------------------------------------------------------
# from_coo dedup: minimum weight per (src, dst), self-loops dropped
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("perm_seed", [0, 1, 2])
def test_dedup_min_weight_is_permutation_invariant(perm_seed):
    from repro_torch.core.graph import from_coo as tfrom_coo

    rng = np.random.default_rng(perm_seed)
    n = 12
    src = rng.integers(0, n, 60)
    dst = rng.integers(0, n, 60)
    w = rng.uniform(0.5, 9.0, 60).astype(np.float32)
    perm = rng.permutation(60)
    g1 = tfrom_coo(src, dst, n, w, block_size=16, device="cpu")
    g2 = tfrom_coo(src[perm], dst[perm], n, w[perm], block_size=16, device="cpu")
    jg1 = jfrom_coo(src, dst, n, w, block_size=16)
    for g in (g1, g2):
        for f in ("src_idx", "col_idx", "edge_w"):
            same(getattr(jg1, f), getattr(g, f))


# ---------------------------------------------------------------------------
# the outofcore and memtier suites
# ---------------------------------------------------------------------------

def test_outofcore_suite_rows_match_reference(monkeypatch):
    """The port's ``outofcore`` rows on the CPU: the JAX suite's names, its
    derived counters, every stream counter of its stats, and labels equal
    in every row (each timed callable run once)."""
    import jax

    import benchmarks.outofcore as jsuite
    from repro_torch.benchmarks import outofcore as tsuite

    monkeypatch.setattr(jsuite, "time_call",
                        lambda fn, *a, **k: (jax.block_until_ready(fn(*a)), 0.0)[1])
    monkeypatch.setattr(tsuite, "time_call", lambda fn, *a, **k: (fn(*a), 0.0)[1])
    jrows, trows = jsuite.run(), tsuite.run(device="cpu")
    assert [r[0] for r in trows] == [r[0] for r in jrows]
    for jr, tr in zip(jrows, trows):
        assert tr[2] == jr[2], tr[0]
        if jr[3] is None:
            continue
        a, b = dict(jr[3]), dict(tr[3])
        for key in ("substrate", "io_wait_us"):
            a.pop(key), b.pop(key)
        assert a == b, tr[0]
        assert b["h2d_bytes"] == b["shards_streamed"] * b["shard_bytes"]
        assert b["bitwise_equal"] == 1


def test_memtier_cpu_run_measures_no_device_tier(capsys):
    from repro_torch.benchmarks import memtier

    assert memtier.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("memtier: no device tier")
    assert [line.split(",")[0] for line in out[1:]] == [
        f"fig3/host_write_{p}_{mb}MB" for mb in (64, 256) for p in ("cold", "warm")]
