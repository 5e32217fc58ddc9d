"""The plain reference against the program (``repro_torch`` on the CPU)
and against scipy's shortest paths."""

import gb_fixtures  # noqa: F401
import numpy as np
import pytest
import torch

from gbharness import check, gen, main, reference
from gbharness.program import Program, import_program, specs

PROGRAM = import_program(gb_fixtures.ROOT)


def _inputs(kind, seed):
    g = gen.generator(seed, "cpu")
    if kind == "kron":
        src, dst, n = gen.kron(9, 16, 0.57, 0.19, 0.19, True, g, "cpu")
    else:
        src, dst, n = gen.crawl(8, 6, 16, 3, True, 0.57, 0.19, 0.19, g, "cpu")
    return src, dst, gen.weights(src.numel(), 1.0, 8.0, g, "cpu"), n


@pytest.mark.parametrize("kind,mix,symmetrize", [
    ("kron", "traverse_dirop", True),
    ("crawl", "traverse_sparse", False),
    ("kron", "traverse_sparse", True),
])
def test_traversals_match_program(kind, mix, symmetrize):
    src, dst, w, n = _inputs(kind, 21)
    coo = (src.numpy(), dst.numpy(), w.numpy())
    algos = specs(gb_fixtures.traffic(mix))
    prog = Program(PROGRAM, coo, n, symmetrize=symmetrize, algos=algos,
                   tier=None, device="cpu", timings={})
    csr = reference.build_csr(*coo[:2], n, coo[2], symmetrize=symmetrize)
    cand = gen.candidates(src, dst, n, "degree" if symmetrize else "out_degree",
                          "id", symmetrize)
    for s in gen.sources(cand, 0.25, 0, 4):
        for algo, spec in algos.items():
            labels, _ = prog.call(algo, s)
            ans = main.load_file(gb_fixtures.ROOT, "answers", spec["answer"]["kind"])
            ref = ans.reference_answer(csr, s, {})
            assert ans.compare(labels, ref) == 0, (algo, s)
            assert int(torch.isfinite(ref).sum()) > 1


@pytest.mark.parametrize("tier", [None, dict(nshards=4, pool=2)])
def test_pagerank_matches_program(tier):
    src, dst, _, n = _inputs("crawl", 5)
    coo = (src.numpy(), dst.numpy(), None)
    prog = Program(PROGRAM, coo, n, symmetrize=True, algos=specs(gb_fixtures.traffic("ooc_pr")),
                   tier=tier, device="cpu", timings={})
    ranks, stats = prog.call("pr_push", None)
    assert stats.rounds == 20
    csr = reference.build_csr(*coo[:2], n, symmetrize=True, dedup=True)
    ref = reference.pagerank_push(csr, 20, 0.85, 1e-9)
    assert check.max_rel_err(ranks, ref) < 1e-5
    low = reference.pagerank_push(csr, 20, 0.85, 1e-9, dtype=torch.bfloat16)
    assert check.max_rel_err(low, ref) > 1e-3


def test_distances_match_scipy():
    sp = pytest.importorskip("scipy.sparse")
    csgraph = pytest.importorskip("scipy.sparse.csgraph")
    src, dst, w, n = _inputs("crawl", 8)
    csr = reference.build_csr(src, dst, n, w)
    a = sp.csr_matrix((w.double().numpy(), (src.numpy(), dst.numpy())), shape=(n, n))
    for s in (0, 100, 300):
        want = csgraph.dijkstra(a, indices=s)
        got = reference.distances(csr, s, weighted=True).double().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)
        hops = csgraph.shortest_path(a, indices=s, unweighted=True)
        np.testing.assert_array_equal(
            reference.distances(csr, s, weighted=False).double().numpy(), hops)


def test_build_csr_dedup_keeps_the_smallest_weight():
    csr = reference.build_csr([0, 0, 1, 2, 0], [1, 1, 1, 0, 2], 3,
                              [5.0, 2.0, 1.0, 3.0, 4.0], dedup=True)
    assert csr.row_ptr.tolist() == [0, 2, 2, 3]
    assert csr.col.tolist() == [1, 2, 0] and csr.w.tolist() == [2.0, 4.0, 3.0]


def test_bfloat16_control_misses_distances():
    src, dst, w, n = _inputs("kron", 3)
    csr = reference.build_csr(src, dst, n, w, symmetrize=True)
    ref = reference.distances(csr, int(src[0]), weighted=True)
    low = reference.distances(csr, int(src[0]), weighted=True, dtype=torch.bfloat16)
    assert check.mismatched(low, ref) > 0
