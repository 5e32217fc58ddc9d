"""One blocking fetch per stretch: the port's ``engine.fetch`` against the
reference's ``jax.device_get``.

The reference pins its fused engine's host syncs in
``tests/test_engine_properties.py`` (a path graph's BFS makes at most 3
fetches; a web-crawl sssp has at most half as many stretches as rounds).
The port's fused engine runs each stretch as one device loop
(``kernels.device_loop.do_while``) and reads the device only through
``engine.fetch``, whose ``calls`` these tests count: the same bounds, the
reference's exact counts, and labels and ``RunStats`` unchanged between
fused and per-round dispatch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core.algorithms import bfs as jbfs  # noqa: E402
from repro.core.algorithms import cc as jcc  # noqa: E402
from repro.core.algorithms import kcore as jkcore  # noqa: E402
from repro.core.algorithms import pagerank as jpr  # noqa: E402
from repro.core.algorithms import sssp as jsssp  # noqa: E402
from repro.core.graph import from_coo as jfrom_coo  # noqa: E402
from repro.graphs import generators as gen  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.algorithms import bfs as tbfs  # noqa: E402
from repro_torch.core.algorithms import cc as tcc  # noqa: E402
from repro_torch.core.algorithms import kcore as tkcore  # noqa: E402
from repro_torch.core.algorithms import pagerank as tpr  # noqa: E402
from repro_torch.core.algorithms import sssp as tsssp  # noqa: E402
from repro_torch.kernels.device_loop import do_while, do_while_plain  # noqa: E402
from test_torch_engine import engine_graph, stats_equal  # noqa: E402
from test_torch_graph import port_graph  # noqa: E402


@pytest.fixture
def jax_fetches(monkeypatch):
    """Counts the reference's blocking ``jax.device_get`` calls."""
    calls = {"n": 0}
    real = jax.device_get

    def counting(x):
        calls["n"] += 1
        return real(x)

    monkeypatch.setattr(jax, "device_get", counting)
    return calls


def port_fetches(fn):
    """``(fn(), engine.fetch calls it made)``."""
    before = teng.fetch.calls
    out = fn()
    return out, teng.fetch.calls - before


def test_fused_fetches_scale_with_rung_switches(jax_fetches):
    """A path graph's BFS is one rung stretch: the fused run fetches at
    most 3 times (entry scalars, then the stretch's settle), the
    per-round run once a round, as in the reference."""
    src, dst, n = gen.path(256)
    jg = jfrom_coo(src, dst, n, block_size=16)
    g = port_graph(jg)
    (dist, st), fused = port_fetches(lambda: tbfs.bfs_dd_sparse(g, 0))
    assert st.rounds >= n - 2 and st.sparse_rounds == st.rounds
    assert fused <= 3, (st.rounds, fused)
    (dist_p, st_p), per_round = port_fetches(
        lambda: tbfs.bfs_dd_sparse(g, 0, fused=False))
    assert per_round >= st_p.rounds
    assert torch.equal(dist, dist_p)
    assert fused < per_round // 50
    jdist, jst = jbfs.bfs_dd_sparse(jg, 0)
    assert jax_fetches["n"] == fused
    np.testing.assert_array_equal(np.asarray(jdist), dist.numpy())
    stats_equal(jst, st)


def test_fused_fetches_bounded_on_mixed_regime_run(jax_fetches):
    """A web-crawl sssp crosses rungs and the dense cutoff: one fetch per
    stretch plus the entry fetch, at most half as many stretches as
    rounds, and the reference's count exactly."""
    src, dst, n = gen.web_crawl_like(24, 5, 10, 2, seed=2)
    w = gen.random_weights(len(src), seed=3)
    jg = jfrom_coo(src, dst, n, w, block_size=64)
    g = port_graph(jg)
    (dist, st), fetches = port_fetches(lambda: tsssp.sssp_dd_sparse(g, 0))
    stretches = fetches - 1
    assert 1 <= stretches
    assert 2 * stretches <= st.rounds, (stretches, st.rounds)
    jdist, jst = jsssp.sssp_dd_sparse(jg, 0)
    assert jax_fetches["n"] == fetches
    np.testing.assert_array_equal(np.asarray(jdist), dist.numpy())
    stats_equal(jst, st)


def _kcore_runs(tg, jg, k=8):
    def port(fused):
        deg = tg.out_deg.clone()
        eng = teng.SparseLadderEngine(tg, tkcore._kcore_sparse_step(k),
                                      tkcore._kcore_dense_step(k),
                                      dense_cost="mass", fused=fused)
        (alive, _), _ = eng.run((tg.valid_vertex_mask(), deg),
                                tg.valid_vertex_mask() & (deg < k))
        return alive, eng.stats

    def ref(fused):
        deg = jg.out_deg.astype(np.int32)
        eng = jeng.SparseLadderEngine(jg, jkcore._kcore_sparse_step(k),
                                      jkcore._kcore_dense_step(k),
                                      dense_cost="mass", fused=fused)
        (alive, _), _ = eng.run((jg.valid_vertex_mask(), deg),
                                jg.valid_vertex_mask() & (deg < k))
        return alive, eng.stats

    return port, ref


ALGOS = {
    "bfs": (lambda g, f: tbfs.bfs_dd_sparse(g, 0, fused=f),
            lambda g, f: jbfs.bfs_dd_sparse(g, 0, fused=f), False),
    "sssp": (lambda g, f: tsssp.sssp_dd_sparse(g, 0, fused=f),
             lambda g, f: jsssp.sssp_dd_sparse(g, 0, fused=f), False),
    "cc": (lambda g, f: tcc.cc_dd_sparse(g, fused=f),
           lambda g, f: jcc.cc_dd_sparse(g, fused=f), True),
    "kcore": (None, None, True),
}


@pytest.mark.parametrize("gname", ["chain", "hub_leaves", "erdos"])
@pytest.mark.parametrize("algo", list(ALGOS))
def test_fused_equals_per_round_with_reference_fetches(algo, gname, jax_fetches):
    """On the engine tests' ladder cases: fused and per-round runs give
    the same labels and every RunStats counter but ``compiles`` (stretch
    keys against rung steps), both equal to the reference's, with the
    reference's fetch count in each regime."""
    port_fn, ref_fn, sym = ALGOS[algo]
    jg, tg = engine_graph(gname, sym=sym)
    if algo == "kcore":
        port_run, ref_run = _kcore_runs(tg, jg)
    else:
        port_run = lambda f: port_fn(tg, f)  # noqa: E731
        ref_run = lambda f: ref_fn(jg, f)  # noqa: E731
    out = {}
    for fused in (True, False):
        (labels, st), fetches = port_fetches(lambda: port_run(fused))
        jax_fetches["n"] = 0
        jlabels, jst = ref_run(fused)
        assert jax_fetches["n"] == fetches, (fused, jax_fetches["n"], fetches)
        np.testing.assert_array_equal(np.asarray(jlabels), labels.numpy())
        stats_equal(jst, st)
        out[fused] = (labels, st.as_dict(), fetches)
    assert torch.equal(out[True][0], out[False][0])
    a, b = out[True][1], out[False][1]
    a.pop("compiles"), b.pop("compiles")
    assert a == b
    assert out[False][2] >= a["rounds"]
    assert out[True][2] <= out[False][2]


@pytest.mark.parametrize("algo", ["pr_push", "pr_pull", "bfs_topo", "kcore_peel"])
def test_run_dense_makes_one_fetch(algo):
    """``run_dense`` is one device loop: one fetch of its round count,
    whatever the rounds; results and counters equal the reference's."""
    src, dst, n = gen.web_crawl_like(16, 4, 8, 2, seed=5)
    jg = jfrom_coo(src, dst, n, block_size=64, symmetrize=True, build_csc=True)
    g = port_graph(jg)
    port, ref = {
        "pr_push": (lambda: tpr.pr_push(g), lambda: jpr.pr_push(jg)),
        "pr_pull": (lambda: tpr.pr_pull(g), lambda: jpr.pr_pull(jg)),
        "bfs_topo": (lambda: tbfs.bfs_topo(g, 0), lambda: jbfs.bfs_topo(jg, 0)),
        "kcore_peel": (lambda: tkcore.kcore_peel(g, 4),
                       lambda: jkcore.kcore_peel(jg, 4)),
    }[algo]
    (out, st), fetches = port_fetches(port)
    jout, jst = ref()
    assert st.rounds > 1
    assert fetches == 1
    stats_equal(jst, st)
    if algo.startswith("pr_"):
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                                   atol=1e-8)
    else:
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_run_host_fetches_once_a_round():
    rounds, state = teng.run_host(lambda s: s + 1, torch.tensor(0),
                                  lambda s: s < 5, 100)
    assert (rounds, int(state)) == (5, 5)
    before = teng.fetch.calls
    teng.run_host(lambda s: s + 1, torch.tensor(0), lambda s: s < 5, 100)
    assert teng.fetch.calls - before == 6   # five rounds and the exit
    with pytest.raises(NotImplementedError, match="item 8"):
        teng.run_host(lambda s: s, 0, lambda s: False, 1, checkpointer=object())


@pytest.mark.parametrize("limit", [0, 1, 3, 7, 100])
@pytest.mark.parametrize("enter", [None, True, False])
def test_do_while_plain_contract(limit, enter):
    """The loop's plain version: a do-while capped at ``limit`` rounds, a
    while loop with ``enter``; on CPU tensors ``do_while`` is it."""
    def one_round(st):
        x, y = st
        return (x + 1, y * 2), x + 1 < 7

    state = (torch.tensor(0), torch.ones(3))
    ent = None if enter is None else torch.tensor(enter)
    (x, y), k = do_while(one_round, state, limit, enter=ent)
    (xp, yp), kp = do_while_plain(one_round, state, limit, enter=ent)
    want = 0 if limit <= 0 or enter is False else min(limit, 7)
    assert k == kp == want == int(x) == int(xp)
    assert torch.equal(y, torch.full((3,), 2.0 ** want)) and torch.equal(y, yp)


def test_fetch_one_transfer_shapes():
    before = teng.fetch.calls
    got = teng.fetch(torch.tensor([3, 4], dtype=torch.int32), torch.tensor(True),
                     torch.tensor(0.5), 7)
    assert got == ([3, 4], True, 0.5, 7)
    assert teng.fetch(torch.tensor(2**40, dtype=torch.int64)) == 2**40
    assert teng.fetch.calls - before == 2


@pytest.mark.parametrize("k", [0, 1, 2, 9])
def test_settle_counts_the_rounds_a_loop_replayed(k):
    """On the card a loop's first round runs eagerly (its wrappers count
    it) and a capture launches nothing; settling a launch whose fetched
    count is ``k`` adds its captured round's launches for each of the
    ``k - 1`` rounds the graph replayed, once."""
    from types import SimpleNamespace

    from repro_torch import kernels
    from repro_torch.kernels.device_loop import StretchGraphs

    graphs = StretchGraphs()
    before = kernels.launch_counts()
    graphs.unsettled = SimpleNamespace(launches={"edge_relax": 2, "advance": 1})
    try:
        graphs.settle(k)
        graphs.settle(k)   # nothing is left to settle
        got = {name: n - before[name] for name, n in kernels.launch_counts().items()}
    finally:
        for name, n in before.items():
            kernels.KERNELS[name].launches = n
    rounds = max(k - 1, 0)
    assert got == {name: {"edge_relax": 2 * rounds, "advance": rounds}.get(name, 0)
                   for name in before}
