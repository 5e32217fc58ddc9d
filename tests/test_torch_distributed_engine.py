"""The port's BSP baseline (``core/partition.py``: ``bsp_bfs``,
``bsp_cc``, the D-Galois analogue) against the JAX package's, as
``tests/test_distributed_engine.py`` runs it: the symmetrized web-crawl
graph at OEC 8 on one axis and CVC (4, 2) on two.  The reference runs in
a subprocess on 8 forced host devices (``test_torch_sharded.REFERENCE``);
the port on a CPU mesh under both substrate names.  Held: labels bitwise
(unreached vertices at FLT_MAX / 4 on both sides) and round counts equal;
bfs against ``tests/oracles.py`` and cc's component partition against the
oracle's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import oracles  # noqa: E402
from repro.core import from_coo as jfrom_coo  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core import partition as tpt  # noqa: E402
from repro_torch.core.mesh import Mesh  # noqa: E402
from test_torch_graph import port_graph  # noqa: E402
from test_torch_sharded import run_reference  # noqa: E402

WEB = [8, 4, 6, 2]
CELLS = {"oec8": (8, None), "cvc42": (8, (4, 2))}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("bsp"), dict(parts=["bsp"], bsp_web=WEB))


@pytest.fixture(scope="module")
def graph():
    src, dst, n = jgen.web_crawl_like(*WEB, seed=1)
    jg = jfrom_coo(src, dst, n, block_size=64, symmetrize=True)
    s, d = np.asarray(jg.src_idx)[: jg.m], np.asarray(jg.col_idx)[: jg.m]
    return port_graph(jg), s, d, n, int(np.argmax(np.bincount(s, minlength=n)))


def partition(g, cell):
    ndev, grid = CELLS[cell]
    if grid:
        mesh = Mesh({"data": grid[0], "model": grid[1]}, device="cpu")
        return tpt.partition_2d(g, *grid), mesh, ("data", "model")
    return tpt.partition_1d(g, ndev), Mesh({"data": ndev}, device="cpu"), ("data",)


@pytest.mark.parametrize("substrate", ["torch", "cuda"])
@pytest.mark.parametrize("cell", list(CELLS))
def test_bsp_bfs_matches_reference(ref, graph, cell, substrate):
    g, s, d, n, source = graph
    pg, mesh, axes = partition(g, cell)
    with tops.substrate_scope(substrate):
        labels, rounds = tpt.bsp_bfs(pg, mesh, axes, source)
    assert np.array_equal(labels.numpy(), ref[f"bsp/{cell}/bfs"])
    assert rounds == int(ref[f"bsp/{cell}/bfs_rounds"]) and rounds > 1
    got = labels.numpy()[:n]
    assert np.array_equal(np.where(got > 1e30, np.inf, got), oracles.bfs(s, d, n, source))


@pytest.mark.parametrize("substrate", ["torch", "cuda"])
@pytest.mark.parametrize("cell", list(CELLS))
def test_bsp_cc_matches_reference(ref, graph, cell, substrate):
    g, s, d, n, _ = graph
    pg, mesh, axes = partition(g, cell)
    with tops.substrate_scope(substrate):
        labels, rounds = tpt.bsp_cc(pg, mesh, axes)
    assert labels.dtype == torch.int32
    assert np.array_equal(labels.numpy(), ref[f"bsp/{cell}/cc"])
    assert rounds == int(ref[f"bsp/{cell}/cc_rounds"])
    _, want = np.unique(oracles.connected_components(s, d, n), return_inverse=True)
    _, got = np.unique(labels.numpy()[:n], return_inverse=True)
    assert np.array_equal(want, got)


def test_bsp_step_refuses_a_mesh_of_another_size(graph):
    g = graph[0]
    pg = tpt.partition_1d(g, 4)
    with pytest.raises(ValueError, match="positions"):
        tpt.make_bsp_step(pg, Mesh({"data": 8}, device="cpu"), ("data",))


def test_chip_smoke_mesh_phase_on_the_cpu(monkeypatch):
    """chip_smoke.py's 9i (``mesh_phase``) rehearsed on the CPU at a small
    size: every check it makes on the card holds here on the plain
    versions (launch counts aside, which the CPU's wrappers never raise)."""
    import importlib.util
    from pathlib import Path

    from repro_torch.core import mesh as tmesh
    from repro_torch.core import multisource as tms
    from repro_torch.core import sharded as tsharded
    from repro_torch.core.algorithms import bc, bfs, cc, kcore, pagerank, sssp
    from repro_torch.core.algorithms import tc as tri
    from repro_torch.core.graph import from_coo
    from repro_torch.graphs import generators as gen
    from repro_torch.kernels import graph_ops as tgk

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(smoke, "cuda_ms", lambda torch, fn, reps=5: (fn(), 0.0)[1])
    monkeypatch.setattr(smoke, "device_ms", lambda torch, fn, reps=5: (fn(), None)[1])
    monkeypatch.setattr(smoke, "print_profile", lambda *a, **k: [])
    # RunStats name the substrate asked for (the CPU's wrappers run plain)
    monkeypatch.setattr(tops, "run_substrate", lambda g, substrate=None: tops._resolve(substrate))
    src, dst, n = gen.web_crawl_like(6, 9, 8, 2, seed=0)
    w = gen.random_weights(len(src), seed=1)
    g = from_coo(src, dst, n, w, build_csc=True, device="cpu")
    gsym = from_coo(src, dst, n, symmetrize=True, build_csc=True, device="cpu")
    source = int(np.argmax(np.bincount(src, minlength=n)))
    ks, kd, kn = gen.kron(9, 16, seed=1)
    kgsym = from_coo(ks, kd, kn, symmetrize=True, build_csc=True, device="cpu")
    refs = {"bfs_dd_sparse": bfs.bfs_dd_sparse(g, source)[0],
            "bfs_dd_sparse(fused=False)": bfs.bfs_dd_sparse(g, source, fused=False)[0],
            "cc_dd_sparse": cc.cc_dd_sparse(gsym)[0],
            "kcore_dd_sparse(k=3)": kcore.kcore_peel(gsym, 3)[0]}
    sources = smoke.ms_sources(np, g, source, smoke.MS_SEED)
    launches = smoke.mesh_phase(
        torch, np, tgk, tops, (bfs, sssp, cc, kcore, bc, pagerank, tri, tms, tmesh, tsharded,
                               tpt),
        g, gsym, kgsym, source, refs, tri.tc_count(kgsym)[0],
        (sources, tms.ms_bfs(g, sources)[0]), expect_launches=False)
    assert set(launches) == {"edge_relax", "advance", "intersect", "edge_relax_lanes"}
