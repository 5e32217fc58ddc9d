"""The paper's figure suites in the port (``repro_torch.benchmarks.
{granularity,frameworks,algo_classes}``) against the JAX package's, at
``bench_graphs("small")``, the port on the CPU.

Each suite runs once in each package (the JAX suite's timing helper
records each timed call's result and makes one call; the sharded tc cell
of ``algo_classes`` runs in the JAX suite's own 4-device subprocess, its
timer one call too and with a compilation cache of its own, and in the
port on a 4-position CPU mesh).  Held: the row names equal; the
derived counters equal; every ``RunStats`` field equal but ``substrate``,
``compiles`` (granularity's derived ``compiles`` is compared) and wall
times; the results behind each row bitwise (labels, distances, core
masks, triangle counts), pagerank within ``PERF.md`` §2's rtol 1e-4 /
atol 1e-10 and bc within its rtol 1e-3 / atol 1e-4.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from benchmarks import algo_classes as jalgo  # noqa: E402
from benchmarks import common as jcommon  # noqa: E402
from benchmarks import frameworks as jfw  # noqa: E402
from benchmarks import granularity as jgran  # noqa: E402
from benchmarks.common import bench_graphs as jbench_graphs  # noqa: E402
from repro.core import from_coo as jfrom_coo  # noqa: E402
from repro.core.algorithms import bc as jbc  # noqa: E402
from repro.core.algorithms import kcore as jkcore  # noqa: E402
from repro.core.algorithms import tc as jtc  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch.benchmarks import algo_classes as talgo  # noqa: E402
from repro_torch.benchmarks import common as tcommon  # noqa: E402
from repro_torch.benchmarks import frameworks as tfw  # noqa: E402
from repro_torch.benchmarks import granularity as tgran  # noqa: E402
from repro_torch.core.algorithms import bfs as tbfs  # noqa: E402
from repro_torch.core.algorithms import cc as tcc  # noqa: E402
from repro_torch.core.algorithms import pagerank as tpr  # noqa: E402
from repro_torch.core.algorithms import sssp as tsssp  # noqa: E402
from test_torch_mesh_suites import fast_helpers  # noqa: E402

SUITES = {"granularity": (jgran, tgran), "frameworks": (jfw, tfw),
          "algo_classes": (jalgo, talgo)}
SHARDED = ("fig7/tc/rmat/dev1", "fig7/tc/rmat/dev4")
PR_TOL = dict(rtol=1e-4, atol=1e-10)
BC_TOL = dict(rtol=1e-3, atol=1e-4)


def run_reference(mod, monkeypatch):
    """(rows, each timed call's result in row order) of a JAX suite."""
    outs = []

    def record(fn, *args, warmup=1, iters=3):
        outs.append(np.asarray(fn(*args)))
        return 0.0

    with monkeypatch.context() as mp:
        mp.setattr(mod, "time_call", record)
        rows = mod.run()
    return rows, outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}
    mp = pytest.MonkeyPatch()
    # the sharded tc cell's subprocess times its calls with the same
    # one-call timer (its walls are not compared either)
    mp.setattr(jcommon, "SUBPROC_HELPERS",
               fast_helpers(tmp_path_factory.mktemp("figure_suites")))

    def get(name):
        if name not in cache:
            jmod, tmod = SUITES[name]
            jrows, jouts = run_reference(jmod, mp)
            results = {}
            trows = tmod.run(device="cpu", warmup=0, iters=1, results=results)
            cache[name] = (jrows, jouts, trows, results)
        return cache[name]

    yield get
    mp.undo()


def check_result(name, want, got):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    got = np.asarray(got)
    if "/pr/" in name or "/pagerank/" in name:
        np.testing.assert_allclose(got, want, **PR_TOL, err_msg=name)
    elif "/bc/" in name:
        np.testing.assert_allclose(got, want, **BC_TOL, err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def stats_equal(name, js, ts):
    a, b = dict(js), dict(ts)
    for key in ("substrate", "compiles"):
        a.pop(key, None), b.pop(key, None)
    for d in (a, b):
        for key in [k for k in d if k.startswith("wall_")]:
            d.pop(key)
    assert a == b, name


@pytest.mark.parametrize("suite", list(SUITES))
def test_row_names_match_reference(runs, suite):
    jrows, _, trows, _ = runs(suite)
    assert [r[0] for r in trows] == [r[0] for r in jrows]
    assert len(trows) == len(set(r[0] for r in trows))


@pytest.mark.parametrize("suite", list(SUITES))
def test_row_results_match_reference(runs, suite):
    jrows, jouts, trows, results = runs(suite)
    # the sharded cell's counts come from the JAX subprocess's rows
    names = [r[0] for r in jrows if r[0] not in SHARDED]
    assert len(jouts) == len(names) == len(set(results) - set(SHARDED))
    for name, want in zip(names, jouts):
        check_result(name, want, results[name])


@pytest.mark.parametrize("suite", ["granularity", "algo_classes"])
def test_row_counters_match_reference(runs, suite):
    """The derived counters (granularity's ``compiles`` among them) and
    every RunStats field the JAX row carries."""
    jrows, _, trows, _ = runs(suite)
    jby = {r[0]: r for r in jrows}
    for name, _, derived, stats in trows:
        assert derived == jby[name][2], name
        if jby[name][3] is not None:
            stats_equal(name, jby[name][3], stats)
        assert stats["substrate"] == "torch"
        assert stats["placement"] == ("blocked" if name.endswith("/dev4") else "local")


def test_frameworks_counters_match_reference(runs):
    """The JAX Fig. 8 rows carry no counters: each row's call is made once
    more in the JAX package on the suite's containers."""
    _, _, trows, _ = runs("frameworks")
    src, dst, n = jbench_graphs()["web"]
    w = jgen.random_weights(len(src), seed=3)
    g = jfrom_coo(src, dst, n, w, block_size=512, build_csc=True)
    gsym = jfrom_coo(src, dst, n, block_size=512, symmetrize=True, build_csc=True)
    source = int(np.argmax(np.bincount(src, minlength=n)))
    calls = {}
    for cname, algs in jfw.CLASSES.items():
        calls[f"fig8/bfs/{cname}"] = lambda a=algs: a["bfs"](g, source)
        calls[f"fig8/sssp/{cname}"] = lambda a=algs: a["sssp"](g, source)
        calls[f"fig8/cc/{cname}"] = lambda a=algs: a["cc"](gsym)
        calls[f"fig8/pr/{cname}"] = lambda a=algs: a["pr"](gsym)
    calls["fig8/bc/all"] = lambda: jbc.bc_brandes(g, source)
    calls["fig8/kcore/all"] = lambda: jkcore.kcore_peel(gsym, 3)
    calls["fig8/tc/all"] = lambda: jtc.tc_count(gsym, edge_chunk=8192)
    assert list(calls) == [r[0] for r in trows]
    for name, _, derived, stats in trows:
        out, jst = calls[name]()
        want = jst.as_dict()
        if name == "fig8/tc/all":
            want["count"] = int(out)
        stats_equal(name, want, stats)
        assert derived.endswith(f"rounds={jst.rounds};edges={jst.edges_touched}")


def test_classes_name_ported_functions():
    for cname, algs in jfw.CLASSES.items():
        assert {k: f.__name__ for k, f in algs.items()} == {
            k: f.__name__ for k, f in tfw.CLASSES[cname].items()}


@pytest.mark.parametrize("mod", [tbfs, tsssp, tcc, tpr])
def test_variants_dicts_match_reference(mod):
    from repro.core import algorithms as jalgs

    jmod = getattr(jalgs, mod.__name__.rsplit(".", 1)[1])
    assert {k: f.__name__ for k, f in mod.VARIANTS.items()} == {
        k: f.__name__ for k, f in jmod.VARIANTS.items()}


def test_bench_graphs_match_reference():
    for scale in ("small", "full"):
        want, got = jbench_graphs(scale), tcommon.bench_graphs(scale)
        assert list(want) == list(got)
        for name in want:
            for a, b in zip(want[name], got[name]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_algo_classes_sharded_tc_cell_matches_reference(runs):
    """``fig7/tc/rmat/dev1`` and ``dev4``: the port's rows (one partition,
    then a 4-position mesh) against the JAX suite's 4-device subprocess:
    derived counters, counts and every RunStats field (``comm_elems`` of
    the one partial-count collective among them)."""
    jrows, _, trows, results = runs("algo_classes")
    jby, tby = {r[0]: r for r in jrows}, {r[0]: r for r in trows}
    for name in SHARDED:
        assert tby[name][2] == jby[name][2], name
        stats_equal(name, jby[name][3], tby[name][3])
        assert results[name] == jby[name][3]["count"] > 0
    dev4 = tby["fig7/tc/rmat/dev4"][3]
    assert dev4["ndev"] == 4 and dev4["placement"] == "blocked"
    assert dev4["comm_elems"] == 4 * 3 and results[SHARDED[0]] == results[SHARDED[1]]


def test_suites_refuse_to_run_without_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgran.run()


def test_timed_keeps_the_first_calls_output():
    calls = []

    def fn():
        calls.append(len(calls))
        return len(calls)

    out, us = tcommon.timed(fn, warmup=1, iters=2)
    assert out == 1 and len(calls) == 3 and us >= 0
    out, _ = tcommon.timed(fn, warmup=0, iters=1)
    assert out == 4


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("label", ["web", "rmat"])
@pytest.mark.parametrize("broken", [None, "fig6/bfs/{}/dirop", "fig6/cc/{}/labelprop_sc",
                                    "fig7/kcore/{}/peel"])
def test_chip_smoke_holds_rows_against_their_anchor(runs, label, broken):
    """chip_smoke.py's 9e check: on one graph every bfs, sssp and cc row
    (frameworks' classes, on the web graph, and algo_classes' variants)
    has its anchor row's labels and both k = 4 peels the same vertices;
    a row changed in one vertex fails it."""
    smoke = load_chip_smoke()
    results = dict(runs("frameworks")[3]) if label == "web" else {}
    results.update((k, v) for k, v in runs("algo_classes")[3].items() if f"/{label}/" in k)
    if broken is None:
        held = smoke.suite_cross_check(torch, label, results)
        assert held == 3 * 4 * (label == "web") + 3 * 3 + 1
        return
    name = broken.format(label)
    bad = results[name].clone()
    bad[1] = ~bad[1] if bad.dtype == torch.bool else bad[1] + 1
    results[name] = bad
    with pytest.raises(smoke.SmokeFailure, match=name.split("/")[-1]):
        smoke.suite_cross_check(torch, label, results)
