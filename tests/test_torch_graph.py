"""The torch port's graph container and generators against the JAX package.

Every array of ``repro_torch.core.graph.from_coo`` must equal
``repro.core.graph.from_coo`` bitwise (same dtype, same bytes), with and
without the CSC mirror and symmetrization, on edge cases of the dedup's
weight order (signed zeros, NaN, infinities), without dedup, with no edge
left and around a block boundary; ``oriented_adjacency`` likewise on the
same graphs and on a CSR whose edges are out of order.  The port's
generators must return the JAX package's arrays for the same seeds.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")
torch.set_num_threads(1)

from repro.core import graph as jgraph  # noqa: E402
from repro.core.algorithms import tc as jtc  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core.algorithms import tc as ttc  # noqa: E402
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
        assert a.shape == b.shape, (f, a.shape, b.shape)
        # bitwise: -0.0 against +0.0 and NaN payloads count
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=f)


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


def signed_zeros(flip):
    """Duplicates whose weights are -0.0 and +0.0 (equal to numpy's sort, so
    the first in input order survives), in either input order."""
    src = np.array([0, 0, 1, 1, 2, 2, 3, 0])
    dst = np.array([1, 1, 2, 2, 3, 3, 0, 2])
    w = np.array([-0.0, 0.0, 0.0, -0.0, -0.0, 1.0, 0.0, -0.0], np.float32)
    if flip:
        src, dst, w = src[::-1].copy(), dst[::-1].copy(), w[::-1].copy()
    return src, dst, 5, w


def special_weights():
    """NaN (two payloads, both signs), +-inf and finite duplicates: NaN
    sorts last, so a key keeps a NaN only when all its weights are NaN."""
    nan2 = np.array([0x7FC00001], np.uint32).view(np.float32)[0]
    src = np.array([0, 0, 0, 1, 1, 1, 2, 2, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6])
    dst = np.array([1, 1, 1, 2, 2, 2, 3, 3, 4, 4, 5, 5, 5, 0, 1, 1, 0, 0])
    w = np.array([np.nan, 3.0, np.inf, -np.nan, nan2, np.nan, -np.inf, 2.0,
                  np.inf, np.inf, -0.0, np.nan, -np.inf, nan2, nan2, np.nan,
                  -np.nan, 5.0], np.float32)
    return src, dst, 7, w


def with_duplicates():
    rng = np.random.default_rng(9)
    src = rng.integers(0, 20, 300)
    dst = rng.integers(0, 20, 300)
    w = rng.integers(1, 4, 300).astype(np.float32)   # ties among duplicates
    return src, dst, 20, w


def self_loops_only():
    v = np.arange(10)
    return v, v.copy(), 10, None


def boundary(n):
    """n + 1 one below, at and one above the block (64), and as many edges."""
    src = np.arange(n + 1) % n
    dst = (3 * np.arange(n + 1) + 1) % n
    return src, dst, n, np.linspace(1, 2, n + 1).astype(np.float32)


EDGE_CASES = {
    "signed_zeros": (lambda: signed_zeros(False), {}),
    "signed_zeros_flipped": (lambda: signed_zeros(True), {}),
    "signed_zeros_sym_csc": (lambda: signed_zeros(True),
                             dict(symmetrize=True, build_csc=True)),
    "nan_inf": (special_weights, dict(build_csc=True)),
    "nan_inf_sym": (special_weights, dict(symmetrize=True)),
    "no_dedup": (with_duplicates, dict(dedup=False, build_csc=True)),
    "no_dedup_sym": (with_duplicates, dict(dedup=False, symmetrize=True,
                                           build_csc=True)),
    "dedup_ties": (with_duplicates, dict(build_csc=True)),
    "self_loops_only": (self_loops_only, dict(build_csc=True)),
    "self_loops_only_sym": (self_loops_only, dict(symmetrize=True)),
    "n62": (lambda: boundary(62), dict(build_csc=True)),
    "n63": (lambda: boundary(63), dict(build_csc=True)),
    "n64": (lambda: boundary(64), dict(symmetrize=True, build_csc=True)),
    "web_sym_csc": (lambda: GRAPHS["web_like"]() + (None,),
                    dict(symmetrize=True, build_csc=True)),
}


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_from_coo_edge_cases_bitwise(case):
    make, opts = EDGE_CASES[case]
    src, dst, n, w = make()
    jg = jgraph.from_coo(src, dst, n, w, block_size=64, **opts)
    tg = tgraph.from_coo(src, dst, n, w, block_size=64, device="cpu", **opts)
    assert_same_graph(jg, tg)
    if case == "self_loops_only":
        assert tg.m == 0 and tg.m_pad == 64


def assert_same_oriented(jg, tg):
    for a, b in zip(jtc.oriented_adjacency(jg), ttc.oriented_adjacency(tg)):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", [c for c in EDGE_CASES if c != "no_dedup"])
def test_oriented_adjacency_edge_cases_bitwise(case):
    make, opts = EDGE_CASES[case]
    src, dst, n, w = make()
    opts = dict(opts, symmetrize=True)
    jg = jgraph.from_coo(src, dst, n, w, block_size=64, **opts)
    tg = tgraph.from_coo(src, dst, n, w, block_size=64, device="cpu", **opts)
    assert_same_oriented(jg, tg)


def test_oriented_adjacency_unsorted_csr():
    """A Graph carried in through ``from_arrays`` need not be (src, dst)
    sorted: its real edges shuffled, the oriented list and adjacency are
    still the reference's."""
    src, dst, n = GRAPHS["erdos"]()
    jg = jgraph.from_coo(src, dst, n, block_size=64, symmetrize=True)
    perm = np.random.default_rng(3).permutation(jg.m)
    arrays = {f: np.asarray(getattr(jg, f)).copy() for f in FIELDS
              if getattr(jg, f) is not None}
    for f in ("src_idx", "col_idx", "edge_w"):
        arrays[f][: jg.m] = arrays[f][: jg.m][perm]
    shuffled = dataclasses.replace(
        jg, **{f: jnp.asarray(arrays[f]) for f in ("src_idx", "col_idx", "edge_w")})
    tg = tgraph.from_arrays(arrays, **{k: getattr(jg, k) for k in STATIC},
                            device="cpu")
    assert not np.array_equal(arrays["src_idx"], np.asarray(jg.src_idx))
    assert_same_oriented(shuffled, tg)
    assert_same_oriented(jg, tg)


def test_from_coo_rejects_out_of_range_ids():
    """Ids outside [0, n): the dedup's key src * n + dst would merge
    distinct edges, and the degree scatter would write past the arrays."""
    with pytest.raises(ValueError, match="outside"):
        tgraph.from_coo(np.array([0, 5]), np.array([1, 2]), 5, block_size=64,
                        device="cpu")
    with pytest.raises(ValueError, match="outside"):
        tgraph.from_coo(np.array([0, 1]), np.array([-1, 2]), 5, block_size=64,
                        device="cpu")


def test_from_coo_timings():
    src, dst, n = GRAPHS["web_like"]()
    times = {}
    tgraph.from_coo(src, dst, n, block_size=64, build_csc=True, device="cpu",
                    timings=times)
    assert list(times) == ["copy", "dedup", "csr", "csc"]
    assert all(t >= 0 for t in times.values())


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
