"""Every ported algorithm against its JAX twin on the same graph.

bfs, sssp and cc labels are bitwise equal; pagerank is allclose (rtol
1e-5, atol 1e-9: scatter-add and the normalising sum associate in the
backend's order) and its raw residual-push state is bitwise equal under
deterministic add on both sides.  Every ``RunStats`` counter is equal;
only ``substrate`` names each package's own backend.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import operators as jops  # noqa: E402
from repro.core.algorithms import bfs as jbfs  # noqa: E402
from repro.core.algorithms import cc as jcc  # noqa: E402
from repro.core.algorithms import pagerank as jpr  # noqa: E402
from repro.core.algorithms import sssp as jsssp  # noqa: E402
from repro.core.graph import from_coo as jfrom_coo  # noqa: E402
from repro.graphs import generators as gen  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core.algorithms import bfs as tbfs  # noqa: E402
from repro_torch.core.algorithms import cc as tcc  # noqa: E402
from repro_torch.core.algorithms import pagerank as tpr  # noqa: E402
from repro_torch.core.algorithms import sssp as tsssp  # noqa: E402
from test_torch_graph import port_graph  # noqa: E402

GRAPHS = {
    "crawl": lambda: gen.web_crawl_like(12, 4, 6, 2, seed=7),
    "rmat": lambda: gen.rmat(7, 6, seed=8),
}


def graphs(gname):
    src, dst, n = GRAPHS[gname]()
    w = gen.random_weights(len(src), seed=1)
    jg = jfrom_coo(src, dst, n, w, block_size=64, build_csc=True)
    jgs = jfrom_coo(src, dst, n, block_size=64, symmetrize=True)
    source = int(np.argmax(np.bincount(src, minlength=n)))
    return jg, port_graph(jg), jgs, port_graph(jgs), source


def check(jres, tres, exact=True):
    (jl, js), (tl, ts) = jres, tres
    a, b = np.asarray(jl), tl.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    if exact:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-9)
    da, db = js.as_dict(), ts.as_dict()
    assert da.pop("substrate") in jops.SUBSTRATES
    assert db.pop("substrate") == "torch"   # CPU tensors: no kernel ran
    assert da == db


DIRECTED = {
    "bfs_topo": (jbfs.bfs_topo, tbfs.bfs_topo),
    "bfs_dd_dense": (jbfs.bfs_dd_dense, tbfs.bfs_dd_dense),
    "bfs_dd_sparse": (jbfs.bfs_dd_sparse, tbfs.bfs_dd_sparse),
    "bfs_dirop": (jbfs.bfs_dirop, tbfs.bfs_dirop),
    "sssp_bellman_ford": (jsssp.sssp_bellman_ford, tsssp.sssp_bellman_ford),
    "sssp_dd_dense": (jsssp.sssp_dd_dense, tsssp.sssp_dd_dense),
    "sssp_dd_sparse": (jsssp.sssp_dd_sparse, tsssp.sssp_dd_sparse),
    "sssp_delta": (jsssp.sssp_delta, tsssp.sssp_delta),
}


@pytest.mark.parametrize("gname", list(GRAPHS))
@pytest.mark.parametrize("algo", list(DIRECTED))
def test_traversal_bitwise(algo, gname):
    jg, tg, _, _, source = graphs(gname)
    jf, tf = DIRECTED[algo]
    check(jf(jg, source), tf(tg, source))


@pytest.mark.parametrize("algo", ["bfs_dd_sparse", "sssp_dd_sparse"])
def test_sparse_per_round_equals_fused(algo):
    jg, tg, _, _, source = graphs("crawl")
    jf, tf = DIRECTED[algo]
    check(jf(jg, source, fused=False), tf(tg, source, fused=False))
    lf, sf = tf(tg, source, fused=True)
    lp, sp = tf(tg, source, fused=False)
    assert torch.equal(lf, lp)
    a, b = sf.as_dict(), sp.as_dict()
    a.pop("compiles"), b.pop("compiles")
    assert a == b


def test_sssp_delta_other_delta():
    jg, tg, _, _, source = graphs("crawl")
    check(jsssp.sssp_delta(jg, source, delta=1.5),
          tsssp.sssp_delta(tg, source, delta=1.5))


CC = {
    "cc_labelprop": (jcc.cc_labelprop, tcc.cc_labelprop),
    "cc_labelprop_sc": (jcc.cc_labelprop_sc, tcc.cc_labelprop_sc),
    "cc_pointer_jump": (jcc.cc_pointer_jump, tcc.cc_pointer_jump),
    "cc_dd_sparse": (jcc.cc_dd_sparse, tcc.cc_dd_sparse),
}


@pytest.mark.parametrize("gname", list(GRAPHS))
@pytest.mark.parametrize("algo", list(CC))
def test_cc_bitwise(algo, gname):
    _, _, jgs, tgs, _ = graphs(gname)
    jf, tf = CC[algo]
    check(jf(jgs), tf(tgs))
    assert tf(tgs)[0].dtype == torch.int32


@pytest.mark.parametrize("gname", list(GRAPHS))
def test_pagerank_allclose(gname):
    jg, tg, jgs, tgs, source = graphs(gname)
    check(jpr.pr_push(jgs), tpr.pr_push(tgs), exact=False)
    check(jpr.pr_pull(jg), tpr.pr_pull(tg), exact=False)
    check(jpr.ppr_push(jg, source), tpr.ppr_push(tg, source), exact=False)


@pytest.mark.parametrize("gname", list(GRAPHS))
def test_pagerank_push_state_bitwise_under_det_add(gname):
    """Deterministic add fixes every float sum's order, so the raw
    (rank, resid) state of the residual push is bitwise equal; only the
    final normalising sum, a plain reduction, stays allclose."""
    jg, tg, jgs, tgs, _ = graphs(gname)
    with jops.deterministic_add_scope(True), tops.deterministic_add_scope(True):
        jr, jres, jrounds = jpr._pr_push_raw(jgs, 0.85, 1e-9, 10_000)
        tr, tres, trounds = tpr._pr_push_raw(tgs, 0.85, 1e-9, 10_000)
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
        np.testing.assert_array_equal(np.asarray(jres), tres.numpy())
        assert int(jrounds) == trounds
        check(jpr.pr_push(jgs), tpr.pr_push(tgs), exact=False)
        check(jpr.pr_pull(jg), tpr.pr_pull(tg), exact=False)


def test_algorithms_follow_graph_device():
    _, tg, _, _, source = graphs("crawl")
    dist, stats = tbfs.bfs_dd_sparse(tg, source)
    assert dist.device.type == "cpu" and stats.substrate == "torch"
    with tops.substrate_scope("torch"):
        dist2, stats2 = tbfs.bfs_dd_sparse(tg, source)
    assert torch.equal(dist, dist2) and stats2.substrate == "torch"
