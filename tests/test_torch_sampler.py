"""The port's neighbour sampler (``graphs/sampler.py``), its batches
(``blocks_to_batch``) and the GNN trainer's seed nodes
(``data.GraphBatchPipeline``) against the JAX package's, bitwise.

``split`` and ``randint`` rebuild jax 0.9's ``jax.random.split`` and
``_randint`` in numpy uint32 arithmetic (threefry-2x32 in the
partitionable layout), so the draws are the reference's for spans that
are and are not powers of 2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.graph import from_coo as j_from_coo  # noqa: E402
from repro.data import GraphBatchPipeline as JPipe  # noqa: E402
from repro.graphs import sampler as JS  # noqa: E402
from repro.models.gnn import common as JC  # noqa: E402
from repro_torch.core.graph import from_coo  # noqa: E402
from repro_torch.data import GraphBatchPipeline  # noqa: E402
from repro_torch.data import pipeline as P  # noqa: E402
from repro_torch.graphs import sampler as TS  # noqa: E402
from repro_torch.models.gnn import common as TC  # noqa: E402


def words(key):
    return tuple(int(k) for k in np.asarray(key))


@pytest.mark.parametrize("seed,num", [(0, 2), (1, 3), (42, 7), (2**32 - 1, 2), (123456789, 16)])
def test_split(seed, num):
    want = [words(k) for k in jax.random.split(jax.random.PRNGKey(seed), num)]
    assert P.split(P.prng_key(seed), num) == want
    # the partitionable layout: key i hashes the counter pair (0, i) whatever num
    assert P.split(P.prng_key(seed)) == want[:2]


RANDINT = [  # seed, shape, lo, hi
    (0, (16,), 0, 8), (1, (5, 7), 0, 1 << 30), (2, (1024,), 0, 232_965),
    (3, (300,), 0, 2_449_029), (4, (64, 15), 0, 1 << 30), (5, (33,), -7, 9),
    (6, (10,), 5, 5), (7, (10,), 9, 3), (8, (257,), -2**31, 2**31 - 1), (9, (100,), 0, 65_537),
    (10, (2, 3, 4), 100, 101), (11, (4096,), 0, 3),
]


@pytest.mark.parametrize("seed,shape,lo,hi", RANDINT)
def test_randint(seed, shape, lo, hi):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi))
    got = P.randint(P.prng_key(seed), shape, lo, hi)
    assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("n,batch,seed,step", [(232_965, 1024, 0, 0), (232_965, 1024, 0, 7),
                                               (2708, 64, 3, 1), (17, 5, 9, 2**31 + 1),
                                               (1 << 20, 33, 2**33 + 1, 4)])
def test_graph_batch_pipeline(n, batch, seed, step):
    want = np.asarray(JPipe(n, batch, seed).batch(step))
    pipe = GraphBatchPipeline(n, batch, seed)
    got = pipe.batch(step)
    assert got.device.type == "cpu" and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    spec, jspec = pipe.specs(), JPipe(n, batch, seed).specs()
    assert spec.device.type == "meta" and tuple(spec.shape) == jspec.shape
    assert spec.dtype == torch.int32 and jspec.dtype == jnp.int32


def small_graph(seed, n=300, m=2_000):
    """A random digraph with hubs and some vertices of out-degree 0."""
    rng = np.random.default_rng(seed)
    src = np.minimum(rng.zipf(1.6, m) - 1, n - 1)
    src[src % 7 == 3] = 0           # leaves some vertices without out-edges
    dst = rng.integers(0, n, m)
    return src, dst, n


GRAPHS = {"zipf": (0, 300, 2_000), "sparse": (1, 64, 40), "dense": (2, 50, 2_000)}
FANOUTS = [(3,), (15, 10), (4, 2, 3)]


@pytest.fixture(scope="module", params=list(GRAPHS))
def graphs(request):
    src, dst, n = small_graph(*GRAPHS[request.param])
    return j_from_coo(src, dst, n), from_coo(src, dst, n, device="cpu")


def blocks_equal(tb, jb):
    assert tb.seeds.dtype == torch.int32 and np.array_equal(tb.seeds.numpy(), np.asarray(jb.seeds))
    assert len(tb.layers) == len(jb.layers)
    for got, want in zip(tb.layers, jb.layers):
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fanouts", FANOUTS, ids=str)
def test_sample_blocks_raw(graphs, fanouts):
    jg, tg = graphs
    assert int((tg.out_deg[: tg.n] == 0).sum()) > 0
    seeds = GraphBatchPipeline(tg.n, 24, 5).batch(3)
    key = jax.random.PRNGKey(11)
    want = JS.sample_blocks(jg, jnp.asarray(seeds.numpy()), key, fanouts)
    got = TS.sample_blocks(tg, seeds, words(key), fanouts)
    blocks_equal(got, want)
    # the reference cell's (2,) uint32 key and numpy seeds are taken too
    raw = TS.sample_blocks_raw(tg.row_ptr, tg.col_idx, tg.out_deg, seeds.numpy(),
                               np.asarray(key), fanouts)
    blocks_equal(raw, want)
    # a vertex of degree 0 samples itself
    deg = tg.out_deg.long()
    first = raw.layers[0].reshape(-1, fanouts[0])
    lonely = deg[raw.seeds.long()] == 0
    assert torch.equal(first[lonely], raw.seeds[lonely, None].expand(-1, fanouts[0]))


@pytest.mark.parametrize("fanouts", FANOUTS[:2], ids=str)
def test_blocks_to_batch(graphs, fanouts):
    jg, tg = graphs
    rng = np.random.default_rng(len(fanouts))
    feats = rng.normal(size=(tg.n_pad, 6)).astype(np.float32)
    labels = rng.integers(0, 5, tg.n_pad).astype(np.int32)
    seeds = GraphBatchPipeline(tg.n, 16, 1).batch(0)
    key = jax.random.PRNGKey(2)
    jblocks = JS.sample_blocks(jg, jnp.asarray(seeds.numpy()), key, fanouts)
    want = JC.blocks_to_batch(jnp.asarray(feats), jnp.asarray(labels), jblocks, fanouts)
    tblocks = TS.sample_blocks(tg, seeds, words(key), fanouts)
    got = TC.blocks_to_batch(torch.from_numpy(feats), torch.from_numpy(labels), tblocks, fanouts)
    assert got.n_graphs == want.n_graphs == 1
    for name in ("features", "positions", "src", "dst", "edge_mask", "graph_id", "node_mask",
                 "labels"):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), name
