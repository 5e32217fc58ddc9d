"""The slice as a whole: ``examples/quickstart.py``'s sequence — generator,
CSR+CSC and symmetrized containers, bfs_dd_sparse, sssp_delta,
cc_pointer_jump and pr_push — through both packages at the example's
size, every output and counter compared.  The port builds its graphs
from the COO arrays itself (its own generator and ``from_coo``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import from_coo as jfrom_coo  # noqa: E402
from repro.core.algorithms import bfs as jbfs  # noqa: E402
from repro.core.algorithms import cc as jcc  # noqa: E402
from repro.core.algorithms import pagerank as jpr  # noqa: E402
from repro.core.algorithms import sssp as jsssp  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch import from_coo as tfrom_coo  # noqa: E402
from repro_torch.core.algorithms import bfs, cc, pagerank, sssp  # noqa: E402
from repro_torch.graphs import generators as tgen  # noqa: E402
from test_torch_graph import assert_same_graph  # noqa: E402


@pytest.fixture(scope="module")
def quickstart():
    src, dst, n = jgen.web_crawl_like(16, 5, 8, 2, seed=0)
    w = jgen.random_weights(len(src), seed=1)
    tsrc, tdst, tn = tgen.web_crawl_like(16, 5, 8, 2, seed=0)
    tw = tgen.random_weights(len(tsrc), seed=1)
    jg = jfrom_coo(src, dst, n, w, build_csc=True)
    jgs = jfrom_coo(src, dst, n, symmetrize=True)
    tg = tfrom_coo(tsrc, tdst, tn, tw, build_csc=True, device="cpu")
    tgs = tfrom_coo(tsrc, tdst, tn, symmetrize=True, device="cpu")
    source = int(np.argmax(np.bincount(src, minlength=n)))
    tsource = int(np.argmax(np.bincount(tsrc, minlength=tn)))
    assert source == tsource
    return jg, jgs, tg, tgs, source


def compare(jres, tres, exact=True):
    (jl, js), (tl, ts) = jres, tres
    a, b = np.asarray(jl), tl.numpy()
    assert a.dtype == b.dtype
    if exact:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-9)
    da, db = js.as_dict(), ts.as_dict()
    da.pop("substrate"), db.pop("substrate")
    assert da == db
    return b, ts


def test_quickstart_graphs(quickstart):
    jg, jgs, tg, tgs, _ = quickstart
    assert_same_graph(jg, tg)
    assert_same_graph(jgs, tgs)


@pytest.mark.parametrize("fused", [True, False])
def test_quickstart_bfs(quickstart, fused):
    jg, _, tg, _, source = quickstart
    dist, stats = compare(jbfs.bfs_dd_sparse(jg, source, fused=fused),
                          bfs.bfs_dd_sparse(tg, source, fused=fused))
    assert stats.sparse_rounds > 0 and (dist < 1e30).sum() > 1


def test_quickstart_sssp(quickstart):
    jg, _, tg, _, source = quickstart
    compare(jsssp.sssp_delta(jg, source, delta=4.0),
            sssp.sssp_delta(tg, source, delta=4.0))


def test_quickstart_cc(quickstart):
    _, jgs, _, tgs, _ = quickstart
    labels, _ = compare(jcc.cc_pointer_jump(jgs), cc.cc_pointer_jump(tgs))
    assert len(np.unique(labels[: tgs.n])) >= 1


def test_quickstart_pagerank(quickstart):
    _, jgs, _, tgs, _ = quickstart
    rank, _ = compare(jpr.pr_push(jgs), pagerank.pr_push(tgs), exact=False)
    np.testing.assert_allclose(rank.sum(), 1.0, rtol=1e-5)
