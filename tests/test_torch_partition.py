"""The port's placement and partitions (``core/placement.py``,
``core/partition.py``) against the JAX package's, in process (neither
needs a mesh of devices).

Held bitwise: ``shard_owner``, ``vertex_owner``, ``owner_layout``,
``interleave_blocks``, ``ChurnModel``; ``partition_1d`` / ``partition_2d``
in both directions under the three policies, at ndev 1, 2, 3, 4, 8 and on
grids (2, 2), (4, 2), (2, 3): every array of the ``PartitionedGraph``
(src, dst, w sentinel-padded in (src, dst) order, row_ptr, deg with
``deg[sentinel] = 0``, reduce_owner) and its static fields.  Plus the
reference's own properties (``tests/test_placement_partition.py``): every
edge on exactly one shard, the owner map tiling the vertex range, each
2-D shard's targets owned by its grid column — on hypothesis graphs too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import from_coo as jfrom_coo  # noqa: E402
from repro.core import partition as jpt  # noqa: E402
from repro.core import placement as jpl  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch.core import partition as tpt  # noqa: E402
from repro_torch.core import placement as tpl  # noqa: E402
from repro_torch.core.mesh import Mesh  # noqa: E402
from test_torch_graph import port_graph  # noqa: E402

POLICIES = ("local", "interleaved", "blocked")
FIELDS = ("src", "dst", "w", "out_deg", "row_ptr", "deg", "reduce_owner")
STATIC = ("n", "n_pad", "ndev", "epd", "scheme", "policy", "rows", "cols")


def build(seed=7, n=60, m=400, csc=True):
    src, dst, n_ = jgen.erdos(n, m, seed=seed)
    w = jgen.random_weights(len(src), seed=seed + 1).astype(np.float32)
    jg = jfrom_coo(src, dst, n_, w, block_size=16, build_csc=csc)
    return jg, port_graph(jg)


def same_partition(jp, tp):
    for k in STATIC:
        assert getattr(jp, k) == getattr(tp, k), k
    for f in FIELDS:
        want, got = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
        assert want.dtype == got.dtype and np.array_equal(want, got), f


def edge_multiset(src, dst, w, sentinel):
    src, dst, w = (np.asarray(x) for x in (src, dst, w))
    keep = src != sentinel
    return sorted(zip(src[keep].tolist(), dst[keep].tolist(), w[keep].tolist()))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 8])
def test_owner_maps_match_reference(policy, ndev):
    n_pad, block = 128, 16
    v = np.random.default_rng(ndev).integers(0, n_pad, 300)
    assert np.array_equal(tpl.shard_owner(v, n_pad, block, ndev, policy).numpy(),
                          jpl.shard_owner(v, n_pad, block, ndev, policy))
    owner = tpl.vertex_owner(n_pad, block, ndev, policy)
    jowner = jpl.vertex_owner(n_pad, block, ndev, policy)
    assert owner.dtype == torch.int64 and np.array_equal(owner.numpy(), jowner)
    idx, valid = tpl.owner_layout(owner, ndev)
    jidx, jvalid = jpl.owner_layout(jowner, ndev)
    assert np.array_equal(idx.numpy(), jidx) and np.array_equal(valid.numpy(), jvalid)
    # the owner map tiles the vertex range: no gaps, no overlaps
    assert np.array_equal(np.sort(idx[valid].numpy()), np.arange(n_pad))
    assert bool((idx[~valid] == n_pad - 1).all())


def test_blocked_owner_is_not_block_rounded():
    """The reference's blocked cut is ceil(n_pad / ndev) vertices, not a
    block multiple (the tier's ``graph.shard_ranges`` rounds; this does
    not)."""
    owner = tpl.vertex_owner(96, 32, 4, "blocked").numpy()
    assert np.array_equal(owner, jpl.vertex_owner(96, 32, 4, "blocked"))
    assert owner[24] == 1   # a block-rounded cut would keep 24..31 on 0


@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 8])
def test_interleave_blocks_matches_reference(ndev):
    x = np.arange(16 * 24, dtype=np.int32)
    got = tpl.interleave_blocks(torch.from_numpy(x), 16, ndev).numpy()
    assert np.array_equal(got, np.asarray(jpl.interleave_blocks(jnp.asarray(x), 16, ndev)))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("direction", ["out", "in"])
@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 8])
def test_partition_1d_matches_reference(policy, direction, ndev):
    jg, g = build()
    jp = jpt.partition_1d(jg, ndev, policy=policy, direction=direction)
    tp = tpt.partition_1d(g, ndev, policy=policy, direction=direction)
    same_partition(jp, tp)
    # every edge on exactly one shard
    assert (edge_multiset(tp.src.reshape(-1), tp.dst.reshape(-1), tp.w.reshape(-1),
                          tp.sentinel)
            == edge_multiset(jp.src.reshape(-1), jp.dst.reshape(-1), jp.w.reshape(-1),
                             jp.sentinel))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("direction", ["out", "in"])
@pytest.mark.parametrize("grid", [(2, 2), (4, 2), (2, 3)])
def test_partition_2d_matches_reference(policy, direction, grid):
    jg, g = build()
    jp = jpt.partition_2d(jg, *grid, policy=policy, direction=direction)
    tp = tpt.partition_2d(g, *grid, policy=policy, direction=direction)
    same_partition(jp, tp)
    # each shard's targets are owned by its grid column
    owner = tp.reduce_owner.numpy()
    dst = tp.dst.numpy()
    for shard in range(grid[0] * grid[1]):
        real = dst[shard][dst[shard] != tp.sentinel]
        assert np.all(owner[real] == shard % grid[1])


def test_partition_keeps_duplicate_edges_in_csr_order():
    """Without dedup, equal (src, dst) pairs keep their input order (the
    reference's stable lexsort), their weights with them."""
    src = np.array([3, 1, 3, 3, 2, 1], np.int64)
    dst = np.array([4, 2, 4, 4, 0, 2], np.int64)
    w = np.array([5.0, 1.0, 2.0, 7.0, 3.0, 4.0], np.float32)
    jg = jfrom_coo(src, dst, 6, w, block_size=8, build_csc=True, dedup=False)
    g = port_graph(jg)
    for direction in ("out", "in"):
        same_partition(jpt.partition_1d(jg, 2, direction=direction),
                       tpt.partition_1d(g, 2, direction=direction))


def test_partition_in_requires_csc():
    _, g = build(csc=False)
    with pytest.raises(AssertionError):
        tpt.partition_2d(g, 2, 2, direction="in")


def test_churn_model_matches_reference():
    for args in ((1 << 30, 10e-6), (1 << 20, 1e-3), (5e9, 0.0)):
        assert tpl.ChurnModel().breakeven_rounds(*args) == \
            jpl.ChurnModel().breakeven_rounds(*args)
    assert tpl.ChurnModel(ici_bw=1e9, compile_s=0.5).breakeven_rounds(1e9, 0.1) == \
        jpl.ChurnModel(ici_bw=1e9, compile_s=0.5).breakeven_rounds(1e9, 0.1)


@pytest.mark.parametrize("policy", POLICIES)
def test_place_graph_and_position_bytes(policy):
    """``interleaved`` block-permutes the edge arrays (the same edge
    multiset), the others keep them; ``position_bytes`` replicates under
    ``local`` and cuts evenly otherwise."""
    src, dst, n = jgen.rmat(8, 8, seed=1)
    jg = jfrom_coo(src, dst, n, block_size=64)
    g = port_graph(jg)
    mesh = Mesh({"data": 4}, device="cpu")
    gp = tpl.place_graph(g, mesh, ("data",), policy)
    for f in ("col_idx", "src_idx", "edge_w"):
        want = getattr(g, f)
        if policy == "interleaved":
            want = torch.from_numpy(np.array(jpl.interleave_blocks(
                jnp.asarray(want.numpy()), 64, 4)))
        assert torch.equal(getattr(gp, f), want), f
    assert torch.equal(gp.row_ptr, g.row_ptr)
    per = tpl.position_bytes(g, mesh, ("data",), policy)
    total = 12 * g.m_pad
    assert per == ([total] * 4 if policy == "local" else [total // 4] * 4)


def test_partition_property():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=20, deadline=None)
    @given(n=st.integers(4, 80),
           edges=st.lists(st.tuples(st.integers(0, 79), st.integers(0, 79)),
                          min_size=1, max_size=150),
           ndev=st.integers(1, 8),
           policy=st.sampled_from(POLICIES),
           seed=st.integers(0, 2**31 - 1))
    def prop(n, edges, ndev, policy, seed):
        r = np.random.default_rng(seed)
        src = np.array([e[0] for e in edges], np.int64) % n
        dst = np.array([e[1] for e in edges], np.int64) % n
        w = r.uniform(1, 4, len(src)).astype(np.float32)
        jg = jfrom_coo(src, dst, n, w, block_size=16)
        g = port_graph(jg)
        same_partition(jpt.partition_1d(jg, ndev, policy=policy),
                       tpt.partition_1d(g, ndev, policy=policy))
        owner = tpl.vertex_owner(g.n_pad, g.block_size, ndev, policy)
        idx, valid = tpl.owner_layout(owner, ndev)
        assert np.array_equal(np.sort(idx[valid].numpy()), np.arange(g.n_pad))

    prop()
