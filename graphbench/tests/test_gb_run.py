"""Whole runs of every cell at CPU sizes, past the harness's look for a
card: sound runs come out correct, the bfloat16 control and a broken
timed path come out not correct, and a run prints no result without a
card or with JAX loaded."""

import json
import subprocess
import sys

import gb_fixtures
import pytest
import torch

from gbharness import control, main
from repro_torch.core import operators as ops
from repro_torch.core.algorithms import bfs, pagerank, sssp

CELLS = gb_fixtures.cells()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return gb_fixtures.tiny_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture(autouse=True)
def loaded_before(monkeypatch):
    """The test process is shared with the JAX package's tests: a run is
    held to the modules it loads itself."""
    real = main.loaded_forbidden
    before = set(real())
    monkeypatch.setattr(main, "loaded_forbidden", lambda: sorted(set(real()) - before))
    return real


def _run(root, cell, traced=False, seed=2**31 + 17):
    return main.run_cell(root, cell, seed, 0.3, traced, device="cpu")


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell, traced):
    r = _run(root, cell, traced)
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    group = manifest["per_layer" if traced else "end_to_end"]
    want = {m["name"] for m in group if cell in m.get("workloads", [cell])}
    # device readings are absent on the CPU: their readers return nothing
    got = set(r["metrics"])
    assert got <= want
    if not traced:
        assert got == want and all(m["value"] > 0 or k == "peak_gib"
                                   for k, m in r["metrics"].items())
    else:
        assert "build_s" in got and r["device"]["window_s"] > 0
        assert "breakdown" in r


def test_seed_draws_sources_not_the_graph(root):
    _, _, config, traffic = main.load_cell(root, CELLS[0])
    one = main.make_inputs(root, config, traffic, "cpu")
    two = main.make_inputs(root, config, traffic, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(one[:3], two[:3]))
    src, dst, _, n = one
    plans = [main.make_plan(src, dst, n, config, traffic, seed) for seed in (2**31 + 1, 7)]
    assert [plans[0](k) for k in range(8)] != [plans[1](k) for k in range(8)]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(root, cell):
    got = control.readings(root, cell, 3, 4, device="cpu")
    assert not got["correct"], got


def _unchanged(pos):
    def broken(*args, **kw):
        out = kw["out_init"] if "out_init" in kw else args[pos]
        return out.clone()
    return broken


def _altered(fn):
    def broken(*args, **kw):
        labels, stats = fn(*args, **kw)
        labels = labels.clone()
        hit = torch.nonzero(labels[:-1] < 1e30).squeeze(1)
        labels[hit[0]] += 1.0
        return labels, stats
    return broken


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_broken_timed_path_is_not_correct(root, cell, fault, monkeypatch):
    if fault == "state_unchanged":
        for name, pos in (("push_dense", 3), ("pull_dense", 3), ("relax_edges", 3),
                          ("relax_batch", 2)):
            monkeypatch.setattr(ops, name, _unchanged(pos))
    else:
        for mod, name in ((bfs, "bfs_dirop"), (bfs, "bfs_dd_sparse"), (sssp, "sssp_delta"),
                          (sssp, "sssp_dd_sparse"), (pagerank, "pr_push")):
            monkeypatch.setattr(mod, name, _altered(getattr(mod, name)))
    assert not _run(root, cell)["correct"]


def test_jax_loaded_prints_no_result(root, monkeypatch, loaded_before):
    monkeypatch.setattr(main, "loaded_forbidden", loaded_before)
    monkeypatch.setitem(sys.modules, "jax", sys)
    with pytest.raises(main.RunError) as err:
        _run(root, CELLS[0])
    assert err.value.code != 0 and "jax" in str(err.value)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, str(gb_fixtures.BENCH / "run.py"), "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=gb_fixtures.ROOT, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card_small(root, cell, card):
    r = main.run_cell(root, cell, 12345, 1.0, False, device="cuda")
    assert r["correct"] and r["device"]["platform"] == "gpu"
