"""The torch port's graph container and generators against the JAX package.

Every array of ``repro_torch.core.graph.from_coo`` must equal
``repro.core.graph.from_coo`` bitwise (same dtype, same values), with and
without the CSC mirror and symmetrization, and the port's generators must
return the JAX package's arrays for the same seeds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import graph as jgraph  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.graphs import generators as tgen  # noqa: E402

FIELDS = ("row_ptr", "col_idx", "src_idx", "edge_w", "out_deg",
          "in_row_ptr", "in_col_idx", "in_src_idx", "in_edge_w", "in_deg")
STATIC = ("n", "m", "n_pad", "m_pad", "block_size")


def hub_and_leaves(n_leaves=70):
    src = [0] * n_leaves + list(range(1, n_leaves))
    dst = list(range(1, n_leaves + 1)) + list(range(2, n_leaves + 1))
    return np.array(src), np.array(dst), n_leaves + 1


GRAPHS = {
    "hub_leaves": hub_and_leaves,
    "web_like": lambda: jgen.web_crawl_like(8, 4, 6, 2, seed=1),
    "erdos": lambda: jgen.erdos(150, 1200, seed=2),
}


def port_graph(jg, device="cpu"):
    """The JAX container's arrays carried into the port unchanged."""
    arrays = {f: np.asarray(getattr(jg, f)) for f in FIELDS
              if getattr(jg, f) is not None}
    return tgraph.from_arrays(arrays, **{k: getattr(jg, k) for k in STATIC},
                              device=device)


def assert_same_graph(jg, tg):
    for k in STATIC:
        assert getattr(jg, k) == getattr(tg, k), k
    assert jg.has_csc == tg.has_csc
    for f in FIELDS:
        a, b = getattr(jg, f), getattr(tg, f)
        if a is None:
            assert b is None, f
            continue
        a, b = np.asarray(a), b.cpu().numpy()
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("opts", [
    dict(), dict(build_csc=True), dict(symmetrize=True),
    dict(build_csc=True, weighted=True), dict(dedup=False, weighted=True),
])
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_from_coo_bitwise(gname, opts):
    src, dst, n = GRAPHS[gname]()
    opts = dict(opts)
    w = (np.random.default_rng(5).uniform(1, 8, len(src)).astype(np.float32)
         if opts.pop("weighted", False) else None)
    jg = jgraph.from_coo(src, dst, n, w, block_size=64, **opts)
    tg = tgraph.from_coo(src, dst, n, w, block_size=64, device="cpu", **opts)
    assert_same_graph(jg, tg)
    assert tg.device.type == "cpu"


def test_duplicate_edges_keep_min_weight():
    src = np.array([0, 0, 0, 1, 1, 2, 2, 2])
    dst = np.array([1, 1, 1, 2, 2, 0, 0, 2])   # (2, 2) is a self-loop
    w = np.array([5.0, 2.0, 7.0, 3.0, 1.5, 9.0, 4.0, 1.0], np.float32)
    for opts in (dict(), dict(build_csc=True), dict(symmetrize=True)):
        jg = jgraph.from_coo(src, dst, 3, w, block_size=64, **opts)
        tg = tgraph.from_coo(src, dst, 3, w, block_size=64, device="cpu", **opts)
        assert_same_graph(jg, tg)
    tg = tgraph.from_coo(src, dst, 3, w, block_size=64, device="cpu")
    assert tg.m == 3
    assert tg.edge_w[:3].tolist() == [2.0, 1.5, 4.0]


@pytest.mark.parametrize("gname", list(GRAPHS))
def test_from_arrays_equals_from_coo(gname):
    src, dst, n = GRAPHS[gname]()
    jg = jgraph.from_coo(src, dst, n, block_size=64, build_csc=True)
    carried = port_graph(jg)
    assert_same_graph(jg, carried)
    tg = tgraph.from_coo(src, dst, n, block_size=64, build_csc=True,
                         device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(carried, f), getattr(tg, f)), f


GENERATORS = {
    "rmat": lambda g: g.rmat(8, 8, seed=3),
    "kron": lambda g: g.kron(7, 4, seed=4),
    "erdos": lambda g: g.erdos(200, 900, seed=5),
    "grid2d": lambda g: g.grid2d(7, 9),
    "path": lambda g: g.path(33),
    "web_crawl_like": lambda g: g.web_crawl_like(16, 5, 8, 2, seed=0),
    "random_weights": lambda g: (g.random_weights(500, seed=1),
                                 g.random_weights(40, seed=2, lo=0.5, hi=2.0)),
}


def _flatten(x):
    if isinstance(x, (tuple, list)):
        return [y for item in x for y in _flatten(item)]
    return [x]


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generators_equal(name):
    a = _flatten(GENERATORS[name](jgen))
    b = _flatten(GENERATORS[name](tgen))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


def test_table3_suite_equal():
    ja, ta = jgen.table3_suite(), tgen.table3_suite()
    assert list(ja) == list(ta)
    for name in ja:
        for x, y in zip(ja[name](), ta[name]()):
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_graph_helpers_match():
    src, dst, n = GRAPHS["web_like"]()
    jg = jgraph.from_coo(src, dst, n, block_size=64, build_csc=True)
    tg = port_graph(jg)
    assert tg.sentinel == jg.sentinel and tg.csr_bytes == jg.csr_bytes
    assert tgraph.round_up(130, 64) == jgraph.round_up(130, 64) == 192
    for nshards in (1, 3, 4):
        for a, b in zip(jgraph.shard_ranges(jg, nshards),
                        tgraph.shard_ranges(tg, nshards)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jgraph.to_dense(jg), tgraph.to_dense(tg))
    np.testing.assert_array_equal(
        np.asarray(jgraph.degrees_from_edges(jg.src_idx, jg.n_pad)),
        tgraph.degrees_from_edges(tg.src_idx, tg.n_pad).numpy())
    np.testing.assert_array_equal(np.asarray(jg.valid_vertex_mask()),
                                  tg.valid_vertex_mask().numpy())
    mask = np.random.default_rng(0).random(jg.n_pad) < 0.4
    assert int(jg.budget_edge_mass(mask)) == int(
        tg.budget_edge_mass(torch.from_numpy(mask)))
    full = tg.vertex_full(3.5, torch.float32)
    assert full.shape == (tg.n_pad,) and bool((full == 3.5).all())
