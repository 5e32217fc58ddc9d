"""The port's kcore, bc and tc against their JAX twins and the numpy oracles.

kcore alive masks and core numbers, the oriented adjacency and triangle
counts are integer results: bitwise equal.  bc is float: allclose (rtol
1e-5, atol 1e-6: sigma and delta are scatter-add sums in each backend's
order), and bitwise under deterministic add on both sides.  Every
``RunStats`` counter is equal; only ``substrate`` names each package's
backend.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import operators as jops  # noqa: E402
from repro.core.algorithms import bc as jbc  # noqa: E402
from repro.core.algorithms import kcore as jkcore  # noqa: E402
from repro.core.algorithms import tc as jtc  # noqa: E402
from repro.core.graph import from_coo as jfrom_coo  # noqa: E402
from repro.graphs import generators as gen  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core.algorithms import bc as tbc  # noqa: E402
from repro_torch.core.algorithms import kcore as tkcore  # noqa: E402
from repro_torch.core.algorithms import tc as ttc  # noqa: E402
from test_torch_graph import hub_and_leaves, port_graph  # noqa: E402

import oracles  # noqa: E402

GRAPHS = {
    "crawl": lambda: gen.web_crawl_like(12, 4, 6, 2, seed=7),
    "rmat": lambda: gen.rmat(7, 6, seed=8),
    "hub_leaves": hub_and_leaves,
}
BC_RTOL, BC_ATOL = 1e-5, 1e-6


def sym_graphs(gname):
    src, dst, n = GRAPHS[gname]()
    jg = jfrom_coo(src, dst, n, block_size=64, symmetrize=True, build_csc=True)
    return jg, port_graph(jg)


def directed_graphs(gname):
    src, dst, n = GRAPHS[gname]()
    w = gen.random_weights(len(src), seed=7)
    jg = jfrom_coo(src, dst, n, w, block_size=64, build_csc=True)
    source = int(np.argmax(np.bincount(src, minlength=n)))
    return jg, port_graph(jg), source


def edges(g):
    return g.src_idx.numpy()[: g.m], g.col_idx.numpy()[: g.m]


def stats_equal(js, ts):
    a, b = js.as_dict(), ts.as_dict()
    assert a.pop("substrate") in jops.SUBSTRATES
    assert b.pop("substrate") == "torch"   # CPU tensors: no kernel ran
    assert a == b


def check(jres, tres, exact=True):
    (jl, js), (tl, ts) = jres, tres
    a, b = np.asarray(jl), tl.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    if exact:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(b, a, rtol=BC_RTOL, atol=BC_ATOL)
    stats_equal(js, ts)
    return b, ts


# ---- kcore -----------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 3, 5])
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_kcore_peel_bitwise(gname, k):
    jg, tg = sym_graphs(gname)
    alive, stats = check(jkcore.kcore_peel(jg, k), tkcore.kcore_peel(tg, k))
    np.testing.assert_array_equal(
        alive[: tg.n], oracles.kcore_alive(*edges(tg), tg.n, k))
    assert stats.edges_touched == int(tg.out_deg[torch.from_numpy(~alive)].sum())


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("k", [3, 6])
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_kcore_dd_sparse_bitwise(gname, k, fused):
    jg, tg = sym_graphs(gname)
    alive, _ = check(jkcore.kcore_dd_sparse(jg, k, fused=fused),
                     tkcore.kcore_dd_sparse(tg, k, fused=fused))
    peel, _ = tkcore.kcore_peel(tg, k)
    np.testing.assert_array_equal(alive, peel.numpy())


def test_kcore_dd_sparse_dense_rounds_charge_mass():
    """A k above most degrees makes the first removal frontier heavy, so
    the engine runs a dense round and charges its frontier mass, less than
    the m a ``dense_cost="m"`` engine charges for the same rounds."""
    jg, tg = sym_graphs("rmat")
    k = 40
    for fused in (True, False):
        _, stats = check(jkcore.kcore_dd_sparse(jg, k, fused=fused),
                         tkcore.kcore_dd_sparse(tg, k, fused=fused))
        assert stats.dense_rounds > 0
        eng = teng.SparseLadderEngine(tg, tkcore._kcore_sparse_step(k),
                                      tkcore._kcore_dense_step(k), fused=fused)
        deg0 = tg.out_deg.clone()
        eng.run((tg.valid_vertex_mask(), deg0), tg.valid_vertex_mask() & (deg0 < k))
        assert eng.stats.rounds == stats.rounds
        assert eng.stats.dense_rounds == stats.dense_rounds
        assert stats.edges_touched < eng.stats.edges_touched


@pytest.mark.parametrize("gname", list(GRAPHS))
def test_core_numbers_bitwise(gname):
    jg, tg = sym_graphs(gname)
    want = np.asarray(jkcore.core_numbers(jg, 16))
    got = tkcore.core_numbers(tg, 16)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())
    s, d = edges(tg)
    for k in (1, 2, 4):
        np.testing.assert_array_equal(got.numpy()[: tg.n] >= k,
                                      oracles.kcore_alive(s, d, tg.n, k))


def test_kcore_variants():
    assert set(tkcore.VARIANTS) == set(jkcore.VARIANTS)
    assert tkcore._kcore_sparse_step(3) is tkcore._kcore_sparse_step(3)
    assert tkcore._kcore_dense_step(3) is tkcore._kcore_dense_step(3)


# ---- bc --------------------------------------------------------------------


@pytest.mark.parametrize("gname", list(GRAPHS))
def test_bc_allclose_and_oracle(gname):
    jg, tg, source = directed_graphs(gname)
    score, _ = check(jbc.bc_brandes(jg, source), tbc.bc_brandes(tg, source),
                     exact=False)
    want = oracles.brandes_bc(*edges(tg), tg.n, source)
    np.testing.assert_allclose(score[: tg.n], want, rtol=1e-4, atol=1e-4)
    assert score[source] == 0.0


@pytest.mark.parametrize("gname", list(GRAPHS))
def test_bc_bitwise_under_det_add(gname):
    jg, tg, source = directed_graphs(gname)
    with jops.deterministic_add_scope(True), tops.deterministic_add_scope(True):
        check(jbc.bc_brandes(jg, source), tbc.bc_brandes(tg, source))


@pytest.mark.parametrize("substrate", ["torch", "cuda"])
@pytest.mark.parametrize("n", [2, 9, 33])
def test_bc_path_closed_form(substrate, n):
    """Directed path 0->1->...->n-1 from source 0: bc[u] = n-1-u for the
    interior vertices, bc[0] = 0 (integer-valued, exact)."""
    src, dst, nn = gen.path(n)
    jg = jfrom_coo(src, dst, nn, block_size=16)
    with tops.substrate_scope(substrate):
        score, stats = tbc.bc_brandes(port_graph(jg), 0)
    expect = np.maximum(nn - 1.0 - np.arange(nn), 0.0)
    expect[0] = 0.0
    np.testing.assert_array_equal(score.numpy()[:nn], expect)
    stats_equal(jbc.bc_brandes(jg, 0)[1], stats)


def test_bc_edgeless_graph_counters():
    """The only edge is a self-loop, which from_coo drops: m = 0, so every
    relax touches nothing and ``edges_touched`` is 0, as in the reference."""
    src, dst = np.array([0]), np.array([0])
    jg = jfrom_coo(src, dst, 4, block_size=16)
    tg = port_graph(jg)
    assert tg.m == 0
    score, stats = check(jbc.bc_brandes(jg, 0), tbc.bc_brandes(tg, 0))
    assert stats.edges_touched == 0 and stats.rounds == 2
    np.testing.assert_array_equal(score, np.zeros(tg.n_pad, np.float32))


def test_bc_forward_sweep_levels():
    jg, tg, source = directed_graphs("crawl")
    levels, dist, sigma = tbc.brandes_forward(tg, source)
    _, stats = tbc.bc_brandes(tg, source)
    assert 2 * levels == stats.rounds
    reached = dist.numpy() < tbc.INF
    assert sigma.numpy()[reached].min() >= 1.0
    assert (sigma.numpy()[~reached] == 0.0).all()


# ---- tc --------------------------------------------------------------------


@pytest.mark.parametrize("gname", list(GRAPHS))
def test_oriented_adjacency_bitwise(gname):
    jg, tg = sym_graphs(gname)
    for a, b in zip(jtc.oriented_adjacency(jg), ttc.oriented_adjacency(tg)):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and a.shape == tuple(b.shape)
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("edge_chunk", [64, 1000, 32_768])
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_tc_count_exact(gname, edge_chunk):
    jg, tg = sym_graphs(gname)
    jcount, jstats = jtc.tc_count(jg, edge_chunk=edge_chunk)
    tcount, tstats = ttc.tc_count(tg, edge_chunk=edge_chunk)
    assert isinstance(tcount, int) and tcount == jcount
    stats_equal(jstats, tstats)
    assert tcount == oracles.triangle_count(*edges(tg), tg.n)


@pytest.mark.parametrize("edge_chunk", [64, 500, 32_768])
def test_tc_count_stats_follow_the_chunks(edge_chunk):
    """tc_count's counters do not depend on how its intersections are
    launched: rounds = ne_pad // edge_chunk and edges_touched = ne_pad x
    dmax on both substrates, with ne_pad the oriented list padded to whole
    chunks; the counts agree."""
    jg, tg = sym_graphs("crawl")
    adj, osrc, _ = ttc.oriented_adjacency(tg)
    ne_pad = -(-osrc.shape[0] // edge_chunk) * edge_chunk
    out = {}
    for sub in tops.SUBSTRATES:
        with tops.substrate_scope(sub):
            out[sub] = ttc.tc_count(tg, edge_chunk=edge_chunk)
    for count, stats in out.values():
        assert count == out["torch"][0] > 0
        assert stats.rounds == ne_pad // edge_chunk
        assert stats.edges_touched == ne_pad * adj.shape[1]
    stats_equal(jtc.tc_count(jg, edge_chunk=edge_chunk)[1], out["torch"][1])


def test_tc_substrates_agree():
    _, tg = sym_graphs("crawl")
    counts = {}
    for sub in tops.SUBSTRATES:
        with tops.substrate_scope(sub):
            counts[sub] = ttc.tc_count(tg, edge_chunk=128)[0]
    assert counts["torch"] == counts["cuda"] > 0
    assert set(ttc.VARIANTS) == set(jtc.VARIANTS)
