"""The generators: deterministic per seed, and their shape statistics
those of their parameters."""

import json

import gb_fixtures
import pytest
import torch

from gbharness import gen


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_kron_deterministic_per_seed():
    one = gen.kron(10, 16, 0.57, 0.19, 0.19, True, gen.generator(2**33 + 5, "cpu"), "cpu")
    two = gen.kron(10, 16, 0.57, 0.19, 0.19, True, gen.generator(2**33 + 5, "cpu"), "cpu")
    other = gen.kron(10, 16, 0.57, 0.19, 0.19, True, gen.generator(6, "cpu"), "cpu")
    assert _same(one[:2], two[:2]) and one[2] == 1024
    assert one[0].shape != other[0].shape or not torch.equal(one[0], other[0])


@pytest.mark.parametrize("permute", [False, True])
def test_kron_pairs_unique_undirected_and_sorted(permute):
    src, dst, n = gen.kron(11, 16, 0.57, 0.19, 0.19, permute, gen.generator(1, "cpu"), "cpu")
    assert bool((src < dst).all()) and int(dst.max()) < n
    key = src * n + dst
    assert bool((key[1:] > key[:-1]).all())
    # duplicates and self-loops take a share of the generated 2^15 edges
    assert 0.6 * n * 16 < src.numel() < n * 16


def test_kron_permutation_scatters_the_hubs():
    n = 1 << 12
    plain = gen.kron(12, 16, 0.57, 0.19, 0.19, False, gen.generator(2, "cpu"), "cpu")
    perm = gen.kron(12, 16, 0.57, 0.19, 0.19, True, gen.generator(2, "cpu"), "cpu")

    def degrees(g):
        return torch.bincount(g[0], minlength=n) + torch.bincount(g[1], minlength=n)
    dp, dq = degrees(plain), degrees(perm)
    # the same multiset of degrees, but the top hundred no longer at low ids
    assert abs(int(dp.sum()) - int(dq.sum())) < 0.01 * int(dp.sum())
    top_plain = torch.topk(dp, 100).indices.float().mean()
    top_perm = torch.topk(dq, 100).indices.float().mean()
    assert top_plain < 0.2 * n and 0.35 * n < top_perm < 0.65 * n


def test_largest_component():
    src = torch.tensor([0, 1, 2, 5, 7, 8])
    dst = torch.tensor([1, 2, 3, 6, 8, 9])
    got = gen.largest_component(src, dst, 10)
    assert torch.nonzero(got).squeeze(1).tolist() == [0, 1, 2, 3]
    cand = gen.candidates(src, dst, 10, "giant", "id", True)
    assert cand.tolist() == [0, 1, 2, 3]
    # a chain numbered backwards still collapses to one label
    src = torch.arange(9, 0, -1)
    assert bool(gen.largest_component(src, src - 1, 10).all())


def test_crawl_config_matches_its_published_degree():
    cfg = json.loads((gb_fixtures.BENCH / "configs" / "crawl8m.json").read_text())
    cs = cfg["community_scale"]
    src, dst, n = gen.crawl(4, cs, cfg["edge_factor"], cfg["inter_links"], cfg["hub_links"],
                            cfg["a"], cfg["b"], cfg["c"], gen.generator(11, "cpu"), "cpu")
    want = cfg["published"]["clueweb12"]["avg_degree"]
    assert abs(src.numel() / n - want) < 0.01 * want
    assert cfg["num_vertices"] == cfg["n_communities"] << cs


@pytest.mark.parametrize("a,b,c", [(0.57, 0.19, 0.19), (0.45, 0.15, 0.15)])
def test_rmat_bit_probabilities(a, b, c):
    src, dst = gen.rmat_edges(1 << 17, 8, a, b, c, gen.generator(3, "cpu"), "cpu")
    for bit in range(8):
        down = ((src >> bit) & 1).float().mean().item()
        right = ((dst >> bit) & 1).float().mean().item()
        assert abs(down - (1 - a - b)) < 0.01
        assert abs(right - (b + (1 - a - b - c))) < 0.01


def test_crawl_communities_chain_and_hubs():
    cs, nc = 7, 16
    src, dst, n = gen.crawl(nc, cs, 8, 3, True, 0.57, 0.19, 0.19,
                            gen.generator(9, "cpu"), "cpu")
    assert n == nc << cs and bool((src != dst).all())
    key = src * n + dst
    assert bool((key[1:] > key[:-1]).all())
    cu, cv = src >> cs, dst >> cs
    across = cu != cv
    assert bool(((cu - cv).abs()[across] == 1).all())
    for ci in range(nc - 1):
        fwd = int(((cu == ci) & (cv == ci + 1)).sum())
        back = int(((cu == ci + 1) & (cv == ci)).sum())
        assert 1 <= fwd <= 4 and fwd == back
        hub = int(((src == ci << cs) & (dst == (ci + 1) << cs)).sum())
        assert hub == 1
    # the communities hold nearly all edges: 8 per vertex, less duplicates
    assert 0.5 * n * 8 < int((~across).sum()) <= n * 8


def test_crawl_without_hub_links_has_none():
    src, dst, _ = gen.crawl(4, 6, 8, 3, False, 0.57, 0.19, 0.19,
                            gen.generator(9, "cpu"), "cpu")
    hub = (src == 64) & (dst == 128)
    assert int(((src >> 6) != (dst >> 6)).sum()) <= 2 * 3 * 3 and int(hub.sum()) <= 1


def test_weights_in_range_and_seeded():
    w = gen.weights(100_000, 1.0, 8.0, gen.generator(4, "cpu"), "cpu")
    assert w.dtype == torch.float32 and float(w.min()) >= 1.0 and float(w.max()) < 8.0
    assert abs(float(w.mean()) - 4.5) < 0.05
    assert torch.equal(w, gen.weights(100_000, 1.0, 8.0, gen.generator(4, "cpu"), "cpu"))


def test_spread_positions_cover_evenly_from_any_start():
    for start in (0.0, 0.37, 0.999):
        pos = gen.spread_positions(start, 0, 200)
        counts = torch.histc(pos, bins=10, min=0.0, max=1.0)
        assert int(counts.min()) >= 18 and int(counts.max()) <= 22


def test_candidates_and_sources():
    src = torch.tensor([0, 0, 2, 5])
    dst = torch.tensor([1, 3, 3, 6])
    und = gen.candidates(src, dst, 8, "degree", "degree", True)
    assert sorted(und.tolist()) == [0, 1, 2, 3, 5, 6] and und.tolist()[-2:] == [0, 3]
    out = gen.candidates(src, dst, 8, "out_degree", "id", False)
    assert out.tolist() == [0, 2, 5]
    got = gen.sources(out, 0.5, -2, 50)
    assert set(got) <= {0, 2, 5} and len(got) == 50
    with pytest.raises(ValueError):
        gen.candidates(src, dst, 8, "out_degree", "id", True)
