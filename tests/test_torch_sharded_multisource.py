"""The port's multi-source traversal on a sharded graph against the JAX
package's: the ndev 1, 2, 4 matrix of ``tests/test_multisource.py``
(``ms_bfs`` / ``ms_sssp``, and ``ms_ppr`` under deterministic add), the
reference on forced host devices in a subprocess
(``test_torch_sharded.REFERENCE``), the port on a CPU mesh under both
substrate names.  Held: lanes bitwise to the reference's and to the
per-source runs (ms_ppr bitwise to the port's unsharded lanes, within
rtol 1e-4 of the reference's: its final normalising sums), every
``RunStats`` field equal but ``substrate``, every round dense, and
``comm_elems = dense_rounds·ndev·(ndev−1)·n_pad·B``."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import from_coo as jfrom_coo  # noqa: E402
from repro_torch.core import multisource as tms  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core.algorithms import bfs as tbfs  # noqa: E402
from repro_torch.core.mesh import Mesh  # noqa: E402
from repro_torch.core.sharded import shard_graph  # noqa: E402
from test_torch_graph import port_graph  # noqa: E402
from test_torch_sharded import run_reference, stats_match  # noqa: E402


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("ms"), dict(parts=["ms"]))


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(11)
    n, m = 120, 700
    jg = jfrom_coo(rng.integers(0, n, m), rng.integers(0, n, m), n,
                   rng.uniform(1, 4, m).astype(np.float32), block_size=16)
    sources = rng.integers(0, n, 6)
    g = port_graph(jg)
    with tops.deterministic_add_scope(True):
        ppr = tms.ms_ppr(g, sources)[0].numpy()
    return g, sources, ppr


def sharded(g, ndev):
    return shard_graph(g, Mesh({"data": ndev}, device="cpu"), ("data",), policy="blocked")


@pytest.mark.parametrize("substrate", ["torch", "cuda"])
@pytest.mark.parametrize("algo", ["ms_bfs", "ms_sssp"])
@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_sharded_lanes_match_reference(ref, graph, ndev, algo, substrate):
    g, sources, _ = graph
    with tops.substrate_scope(substrate):
        lanes, st = getattr(tms, algo)(sharded(g, ndev), sources)
    assert np.array_equal(lanes.numpy(), ref[f"ms/{ndev}/{algo}"])
    stats_match(json.loads(str(ref[f"ms/{ndev}/{algo}/stats"])), st, (ndev, algo))
    assert st.dense_rounds == st.rounds and st.sources == len(sources)
    assert st.comm_elems == st.dense_rounds * ndev * (ndev - 1) * g.n_pad * len(sources)
    if algo == "ms_bfs":
        for i, s in enumerate(sources):
            assert torch.equal(lanes[i], tbfs.bfs_dd_sparse(g, int(s))[0])


@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_sharded_det_ppr_matches_reference(ref, graph, ndev):
    g, sources, ppr = graph
    with tops.deterministic_add_scope(True):
        lanes, st = tms.ms_ppr(sharded(g, ndev), sources)
    assert np.array_equal(lanes.numpy(), ppr)
    np.testing.assert_allclose(lanes.numpy(), ref[f"ms/{ndev}/ms_ppr_det"], rtol=1e-4,
                               atol=1e-10)
    stats_match(json.loads(str(ref[f"ms/{ndev}/ms_ppr_det/stats"])), st, ndev)


def test_sharded_batched_relax_refuses_a_sparse_batch(graph):
    g, sources, _ = graph
    sg = sharded(g, 2)
    mask = torch.zeros(g.n_pad, dtype=torch.bool)
    mask[int(sources[0])] = True
    from repro_torch.core import frontier as tfr
    batch = tops.advance_sparse(sg, tfr.compact(mask, 16, sg.sentinel), 16)
    lanes = torch.zeros((2, g.n_pad))
    with pytest.raises(ValueError, match="single-partition"):
        tops.batched_relax_batch(batch, lanes, torch.zeros_like(lanes, dtype=torch.bool),
                                 lanes)
