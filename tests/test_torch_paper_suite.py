"""The slice as a whole: ``examples/paper_suite.py``'s sequence — the seven
paper benchmarks (bfs, sssp, cc, pr, kcore, bc, tc) on the Table-3
stand-ins ``kron30`` (low diameter, heavy skew) and ``clueweb12`` (web
crawl) at ``table3_suite(0)`` — through both packages, every output and
counter compared, with the suite's own oracle checks alongside.  The port
builds its graphs from the COO arrays itself (its own generator and
``from_coo``).

Tolerances: integer and min-reduced results bitwise; pagerank rtol 1e-5
and bc rtol 1e-5 / atol 1e-6 against the JAX package (float scatter-add
order); the oracle checks use the suite's own tolerances.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import from_coo as jfrom_coo  # noqa: E402
from repro.core.algorithms import bc as jbc  # noqa: E402
from repro.core.algorithms import bfs as jbfs  # noqa: E402
from repro.core.algorithms import cc as jcc  # noqa: E402
from repro.core.algorithms import kcore as jkcore  # noqa: E402
from repro.core.algorithms import pagerank as jpr  # noqa: E402
from repro.core.algorithms import sssp as jsssp  # noqa: E402
from repro.core.algorithms import tc as jtc  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch import from_coo as tfrom_coo  # noqa: E402
from repro_torch.core.algorithms import bc, bfs, cc, kcore, pagerank, sssp, tc  # noqa: E402
from repro_torch.graphs import generators as tgen  # noqa: E402
from test_torch_graph import assert_same_graph  # noqa: E402

import oracles  # noqa: E402

INPUTS = ("kron30", "clueweb12")


def build(pkg_from_coo, gen_mod, name, **kw):
    src, dst, n = gen_mod.table3_suite(0)[name]()
    w = gen_mod.random_weights(len(src), seed=7)
    g = pkg_from_coo(src, dst, n, w, build_csc=True, **kw)
    g_unw = pkg_from_coo(src, dst, n, build_csc=True, **kw)
    gsym = pkg_from_coo(src, dst, n, symmetrize=True, build_csc=True, **kw)
    return g, g_unw, gsym


def run_suite(algos, g, g_unw, gsym, source):
    """The seven calls of ``paper_suite.run_input``, in its order."""
    bfs_, sssp_, cc_, pr_, kcore_, bc_, tc_ = algos
    return {
        "bfs": bfs_.bfs_dd_sparse(g_unw, source),
        "sssp": sssp_.sssp_delta(g, source),
        "cc": cc_.cc_pointer_jump(gsym),
        "pr": pr_.pr_push(gsym),
        "kcore": kcore_.kcore_peel(gsym, 3),
        "bc": bc_.bc_brandes(g, source),
        "tc": tc_.tc_count(gsym),
    }


@pytest.fixture(scope="module", params=INPUTS)
def suite(request):
    name = request.param
    jgraphs = build(jfrom_coo, jgen, name)
    tgraphs = build(tfrom_coo, tgen, name, device="cpu")
    for jg, tg in zip(jgraphs, tgraphs):
        assert_same_graph(jg, tg)
    g = tgraphs[0]
    s_arr = g.src_idx.numpy()[: g.m]
    source = int(np.argmax(np.bincount(s_arr, minlength=g.n)))
    jres = run_suite((jbfs, jsssp, jcc, jpr, jkcore, jbc, jtc), *jgraphs, source)
    tres = run_suite((bfs, sssp, cc, pagerank, kcore, bc, tc), *tgraphs, source)
    return name, tgraphs, source, jres, tres


def edges(g):
    return g.src_idx.numpy()[: g.m], g.col_idx.numpy()[: g.m]


def compare(jres, tres, algo):
    (jout, js), (tout, ts) = jres[algo], tres[algo]
    da, db = js.as_dict(), ts.as_dict()
    da.pop("substrate"), db.pop("substrate")
    assert da == db
    assert ts.substrate == "torch"   # CPU tensors: no kernel ran
    if algo == "tc":
        assert isinstance(tout, int) and tout == jout
        return tout
    a, b = np.asarray(jout), tout.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape
    if algo == "pr":
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-9)
    elif algo == "bc":
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(a, b)
    return b


def test_suite_bfs(suite):
    _, (g, _, _), source, jres, tres = suite
    out = compare(jres, tres, "bfs")[: g.n]
    got = np.where(out > 1e30, np.inf, out)
    np.testing.assert_array_equal(got, oracles.bfs(*edges(g), g.n, source))


def test_suite_sssp(suite):
    _, (g, _, _), source, jres, tres = suite
    out = compare(jres, tres, "sssp")[: g.n]
    s, d = edges(g)
    want = oracles.dijkstra(s, d, g.edge_w.numpy()[: g.m], g.n, source)
    np.testing.assert_allclose(np.where(out > 1e30, np.inf, out), want, rtol=1e-5)


def test_suite_cc(suite):
    _, (_, _, gsym), _, jres, tres = suite
    out = compare(jres, tres, "cc")[: gsym.n]
    want = oracles.connected_components(*edges(gsym), gsym.n)
    np.testing.assert_array_equal(np.unique(want, return_inverse=True)[1],
                                  np.unique(out, return_inverse=True)[1])


def test_suite_pr(suite):
    _, (_, _, gsym), _, jres, tres = suite
    out = compare(jres, tres, "pr")[: gsym.n]
    np.testing.assert_allclose(out, oracles.pagerank(*edges(gsym), gsym.n),
                               rtol=5e-3, atol=1e-7)


def test_suite_kcore(suite):
    _, (_, _, gsym), _, jres, tres = suite
    out = compare(jres, tres, "kcore")[: gsym.n]
    np.testing.assert_array_equal(out, oracles.kcore_alive(*edges(gsym), gsym.n, 3))


def test_suite_bc(suite):
    _, (g, _, _), source, jres, tres = suite
    out = compare(jres, tres, "bc")[: g.n]
    np.testing.assert_allclose(out, oracles.brandes_bc(*edges(g), g.n, source),
                               rtol=1e-3, atol=1e-4)


def test_suite_tc(suite):
    name, (_, _, gsym), _, jres, tres = suite
    count = compare(jres, tres, "tc")
    assert count == oracles.triangle_count(*edges(gsym), gsym.n)
    assert count > 0
