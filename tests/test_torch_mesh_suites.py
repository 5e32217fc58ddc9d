"""The port's mesh suites (``repro_torch.benchmarks.{scaling,comm_volume,
placement,vs_cluster}``) against the JAX package's, at the JAX suites'
own sizes, the port on a CPU mesh.

The JAX suites run their 8-device subprocesses with a timing helper that
makes one call (``FAST_T``: walls are not compared) and a compilation
cache of their own.  Held: row names
equal, each row's derived counters equal, and every stats field equal but
``substrate`` and the wall fields.  The JAX placement suite stops after its
``local`` row on this jax (its ``place_graph`` puts the (n_pad + 1,)
row_ptr on an uneven 8-way sharding, which this jax refuses): its rows
are held where it makes them, and the port's ``interleaved`` / ``blocked``
rows to the even cut they model.  The port's scaling JSON goes through
``benchmarks/ci_gate.py gate`` unchanged.
"""

import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from benchmarks import ci_gate  # noqa: E402
from benchmarks import comm_volume as jcomm  # noqa: E402
from benchmarks import common as jcommon  # noqa: E402
from benchmarks import placement as jplace  # noqa: E402
from benchmarks import scaling as jscaling  # noqa: E402
from benchmarks import vs_cluster as jvs  # noqa: E402
from repro_torch.benchmarks import comm_volume as tcomm  # noqa: E402
from repro_torch.benchmarks import common as tcommon  # noqa: E402
from repro_torch.benchmarks import placement as tplace  # noqa: E402
from repro_torch.benchmarks import scaling as tscaling  # noqa: E402
from repro_torch.benchmarks import vs_cluster as tvs  # noqa: E402
from test_torch_sharded import compile_cache_env  # noqa: E402

FAST_T = '''
def t(fn, reps=3):
    import jax
    jax.block_until_ready(fn())
    t.samples = [0.0]
    return 0.0

'''
SUITES = {"scaling": (jscaling, tscaling), "comm_volume": (jcomm, tcomm),
          "placement": (jplace, tplace), "vs_cluster": (jvs, tvs)}


def fast_helpers(cache_dir):
    """The JAX suites' subprocess prelude with ``FAST_T`` for its timer and
    a compilation cache of the subprocesses' own in ``cache_dir``."""
    helpers = jcommon.SUBPROC_HELPERS
    env = "".join(f"os.environ[{k!r}] = {v!r}\n"
                  for k, v in compile_cache_env(cache_dir).items())
    return "import os\n" + env + FAST_T + helpers[helpers.index("def emit"):]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(jcommon, "SUBPROC_HELPERS",
               fast_helpers(tmp_path_factory.mktemp("mesh_suites")))

    def get(name):
        if name not in cache:
            jmod, tmod = SUITES[name]
            results = {}
            cache[name] = (jmod.run(), tmod.run(device="cpu", warmup=0, iters=1,
                                                results=results), results)
        return cache[name]

    yield get
    mp.undo()


def plain(stats):
    out = dict(stats)
    out.pop("substrate", None)
    for key in [k for k in out if k.startswith("wall_")]:
        out.pop(key)
    return out


@pytest.mark.parametrize("suite", ["scaling", "comm_volume", "vs_cluster"])
def test_rows_match_reference(runs, suite):
    jrows, trows, _ = runs(suite)
    assert not any(r[0].endswith("/ERROR") for r in jrows), jrows
    assert [r[0] for r in trows] == [r[0] for r in jrows]
    for (name, _, jderived, jstats), (_, _, tderived, tstats) in zip(jrows, trows):
        assert tderived == jderived, name
        assert (jstats is None) == (tstats is None), name
        if jstats is not None:
            assert plain(tstats) == plain(jstats), name


def test_placement_rows_match_reference(runs):
    jrows, trows, results = runs("placement")
    tby = {r[0]: r for r in trows}
    assert [r[0] for r in trows] == ["fig3/bfs_local", "fig3/bfs_interleaved",
                                     "fig3/bfs_blocked", "fig4/migration_breakeven_rounds"]
    for name, _, derived, _ in jrows:
        assert tby[name][2] == derived, name
    g, _ = tscaling.bench_graph("cpu")
    for policy in ("interleaved", "blocked"):
        assert tby[f"fig3/bfs_{policy}"][2] == f"max_dev_bytes={12 * g.m_pad // 8};imbalance=1.00"
    dists = [results[f"fig3/bfs_{p}"] for p in ("local", "interleaved", "blocked")]
    assert all(torch.equal(dists[0], d) for d in dists[1:])


def test_scaling_labels_agree_across_rows(runs):
    """Every bfs row of the scaling suite (engine, per round, BSP, both
    reducers, every mesh size) has the one-partition engine's labels; BSP
    rows at FLT_MAX / 4 where the engine has FLT_MAX (unreached)."""
    _, _, results = runs("scaling")
    want = results["fig10/engine_bfs_dev1"]
    unreached = want == torch.finfo(torch.float32).max
    for name, got in results.items():
        if "/bsp_" in name:
            assert torch.equal(got[~unreached], want[~unreached]), name
            assert bool((got[unreached] == torch.finfo(torch.float32).max / 4).all()), name
        else:
            assert torch.equal(got, want), name


def test_cvc_cuts_modelled_volume_at_eight(runs):
    """The acceptance bar of the 2-D grid at ndev 8: at least 2x fewer
    reduced elements than the full-mesh reduce."""
    _, trows, _ = runs("comm_volume")
    by = {r[0]: r[3] for r in trows}
    assert by["comm/cvc2d_full_dev8"]["comm_elems"] >= 2 * by["comm/cvc2d_cvc_dev8"]["comm_elems"]
    assert by["comm/cvc2d_cvc_dev8"]["full_over_cvc"] >= 2


def test_ci_gate_reads_the_port_scaling_json(runs, tmp_path, monkeypatch, capsys):
    """``benchmarks/ci_gate.py gate`` finds every row it gates in the
    port's ``--emit-json`` document (the bar is lifted: CPU walls of a
    one-device mesh are not what it gates)."""
    _, trows, _ = runs("scaling")
    path = tmp_path / "scaling.json"
    path.write_text(json.dumps(tcommon.rows_as_json("scaling", trows)))
    monkeypatch.setattr("sys.argv", ["ci_gate", "gate", str(path), "--ndev", "1,2,4,8",
                                     "--max-ratio", "1e12"])
    with pytest.raises(SystemExit) as done:
        ci_gate.main()
    assert done.value.code == 0
    assert "MISSING" not in capsys.readouterr().out
