"""The port's sharded path (``core/sharded.py`` on the virtual mesh of
``core/mesh.py``) against the JAX package's on forced host devices.

The reference runs once per module in a subprocess with
``--xla_force_host_platform_device_count=8`` and the jnp substrate
(``REFERENCE``, as ``tests/test_sharded_invariance.py`` does), writing an
npz of labels and ``RunStats`` per cell.  This module holds the 1-D cells
(blocked OEC at ndev 1, 2, 4, 8; ``local`` and ``interleaved`` at 4) and
``test_torch_sharded_grid.py`` the others (``reducer="full"`` at 1 and 8;
CVC grids (2, 2) and (2, 4)), so the two reference runs go side by side.  The port runs each cell in process on a CPU mesh
under both substrate names, the seven algorithms (and bfs per round).

Held: labels bitwise (bc and pagerank under deterministic add bitwise to
the port's unsharded runs, and to the reference's within ``PERF.md`` §2's
rtol: the packages' float ops differ in the last bits); every
``RunStats`` field equal but ``substrate`` (``comm_elems``, ``comm_bytes``,
``reduce_axis_hops``, ``shard_escalations``, ``edges_touched``, ``ndev``,
``placement`` among them); a fused bfs's ``engine.fetch`` count equal to
the reference's ``jax.device_get`` count (one fetch per stretch);
``CrossReducer.reduce`` on seeded accumulators bitwise for each mode x
kind x dtype (bool ``or`` and ``min`` included); the escalating hub cell;
the gated relax's plain version; the comm model's closed form.
"""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import frontier as jfr  # noqa: E402
from repro.core import from_coo as jfrom_coo  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import frontier as tfr  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core.algorithms import bc, bfs, cc, kcore, pagerank, sssp, tc  # noqa: E402
from repro_torch.core.mesh import Mesh  # noqa: E402
from repro_torch.core.sharded import CrossReducer, shard_graph  # noqa: E402
from repro_torch.kernels import graph_ops as tgk  # noqa: E402
from test_torch_graph import port_graph  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

REFERENCE = r'''
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from repro.core import from_coo, shard_graph  # noqa: E402
from repro.core import multisource as ms  # noqa: E402
from repro.core import operators as ops  # noqa: E402
from repro.core import partition as pt  # noqa: E402
from repro.core.algorithms import bc, bfs, cc, kcore, pagerank, sssp, tc  # noqa: E402
from repro.core.partition import _SM_CHECK_KWARG, _shard_map  # noqa: E402
from repro.graphs import generators as gen  # noqa: E402

DEVS = np.array(jax.devices())
_REAL_GET = jax.device_get
FETCHES = {"n": 0}


def _counting_get(x):
    FETCHES["n"] += 1
    return _REAL_GET(x)


jax.device_get = _counting_get


def graphs(spec):
    """The reference test's graphs: a weighted web-crawl-like graph with
    its CSC mirror, its symmetrized twin, and the source of most out-edges."""
    src, dst, n = gen.web_crawl_like(*spec["web"], seed=spec["seed"])
    w = gen.random_weights(len(src), seed=spec["seed"] + 1)
    g = from_coo(src, dst, n, w, block_size=16, build_csc=True)
    gs = from_coo(src, dst, n, block_size=16, symmetrize=True)
    source = int(np.argmax(np.bincount(np.asarray(g.src_idx)[: g.m], minlength=n)))
    return g, gs, source


def mesh_for(ndev, grid):
    if grid:
        return Mesh(DEVS[:ndev].reshape(grid), ("data", "model")), ("data", "model")
    return Mesh(DEVS[:ndev], ("data",)), ("data",)


def fused_fetches(fn):
    before = FETCHES["n"]
    out = fn()
    return out, FETCHES["n"] - before


def run_cell(out, name, g, gs, source, cell):
    ndev, grid, policy, reducer = cell["ndev"], cell["grid"], cell["policy"], cell["reducer"]
    mesh, axes = mesh_for(ndev, grid)
    kw = dict(scheme="cvc", grid=tuple(grid)) if grid else {}
    sg = shard_graph(g, mesh, axes, policy=policy, reducer=reducer, **kw)
    sgs = shard_graph(gs, mesh, axes, policy=policy, reducer=reducer, **kw)
    with ops.substrate_scope("jnp"):
        (runs, n) = fused_fetches(lambda: bfs.bfs_dd_sparse(sg, source))
        res = {"bfs": runs}
        out[f"{name}/fetches"] = np.asarray(n)
        res["bfs_perround"] = bfs.bfs_dd_sparse(sg, source, fused=False)
        res["sssp"] = sssp.sssp_dd_sparse(sg, source)
        res["cc"] = cc.cc_dd_sparse(sgs)
        with ops.deterministic_add_scope(True):
            res["bc"] = bc.bc_brandes(sg, source)
            res["pagerank"] = pagerank.pr_push(sg)
        res["kcore"] = kcore.kcore_dd_sparse(sgs, 2)
        res["tc"] = tc.tc_count(sgs, edge_chunk=256)
    for algo, (labels, st) in res.items():
        out[f"{name}/{algo}"] = np.asarray(labels)
        out[f"{name}/{algo}/stats"] = np.asarray(json.dumps(st.as_dict()))
    return sg


def reduce_cases(out, red_graphs, spec):
    """``CrossReducer.reduce`` of seeded (D, n_pad) accumulators per mode."""
    for mode, sg in red_graphs.items():
        red = sg.red
        for i, (kind, dtype) in enumerate(spec["reduce_cases"]):
            acc = reduce_input(sg.ndev, sg.n_pad, kind, dtype, i)
            fn = _shard_map(lambda a, red=red, kind=kind: red.reduce(a[0], kind),
                            mesh=sg.mesh, in_specs=(P(sg.axes),), out_specs=P(),
                            **{_SM_CHECK_KWARG: False})
            out[f"reduce/{mode}/{kind}/{dtype}"] = np.asarray(
                fn(jnp.asarray(acc)))


def reduce_input(ndev, n_pad, kind, dtype, i):
    """Seeded accumulators: integer-valued (float add sums exactly), bool
    for or/min over bool."""
    rng = np.random.default_rng(100 + i)
    if dtype == "bool":
        return rng.random((ndev, n_pad)) < 0.5
    return rng.integers(-50, 50, (ndev, n_pad)).astype(dtype)


def hub_cell(out):
    """The escalating cell: a hub whose shard dwarfs the median's."""
    hub_src = np.concatenate([np.zeros(64, np.int64), np.arange(1, 64, dtype=np.int64)])
    hub_dst = np.concatenate([np.arange(1, 65, dtype=np.int64),
                              np.arange(2, 65, dtype=np.int64)])
    gh = from_coo(hub_src, hub_dst, 65, block_size=16)
    sgh = shard_graph(gh, Mesh(DEVS, ("data",)), ("data",), policy="blocked")
    with ops.substrate_scope("jnp"):
        (d, st), n = fused_fetches(lambda: bfs.bfs_dd_sparse(sgh, 0))
        dp, stp = bfs.bfs_dd_sparse(sgh, 0, fused=False)
    out["hub/bfs"], out["hub/bfs/stats"] = np.asarray(d), np.asarray(json.dumps(st.as_dict()))
    out["hub/bfs_perround"] = np.asarray(dp)
    out["hub/bfs_perround/stats"] = np.asarray(json.dumps(stp.as_dict()))
    out["hub/fetches"] = np.asarray(n)


def bsp_cells(out, spec):
    """``bsp_bfs`` / ``bsp_cc`` on the distributed test's graph at OEC 8 and
    CVC (4, 2)."""
    src, dst, n = gen.web_crawl_like(*spec["bsp_web"], seed=1)
    g = from_coo(src, dst, n, block_size=64, symmetrize=True)
    source = int(np.argmax(np.bincount(np.asarray(g.src_idx)[: g.m], minlength=n)))
    for name, ndev, grid in (("oec8", 8, None), ("cvc42", 8, (4, 2))):
        mesh, axes = mesh_for(ndev, grid)
        pg = pt.partition_2d(g, *grid) if grid else pt.partition_1d(g, ndev)
        lab, rounds = pt.bsp_bfs(pg, mesh, axes, source)
        out[f"bsp/{name}/bfs"], out[f"bsp/{name}/bfs_rounds"] = np.asarray(lab), np.asarray(rounds)
        lab, rounds = pt.bsp_cc(pg, mesh, axes)
        out[f"bsp/{name}/cc"], out[f"bsp/{name}/cc_rounds"] = np.asarray(lab), np.asarray(rounds)


def multisource_cells(out, spec):
    """``ms_bfs`` / ``ms_sssp`` on a sharded graph at ndev 1, 2, 4."""
    rng = np.random.default_rng(11)
    n, m = 120, 700
    g = from_coo(rng.integers(0, n, m), rng.integers(0, n, m), n,
                 rng.uniform(1, 4, m).astype(np.float32), block_size=16)
    sources = rng.integers(0, n, 6)
    for ndev in (1, 2, 4):
        sg = shard_graph(g, Mesh(DEVS[:ndev], ("data",)), ("data",), policy="blocked")
        with ops.substrate_scope("jnp"):
            for algo, fn in (("ms_bfs", ms.ms_bfs), ("ms_sssp", ms.ms_sssp)):
                lanes, st = fn(sg, sources)
                out[f"ms/{ndev}/{algo}"] = np.asarray(lanes)
                out[f"ms/{ndev}/{algo}/stats"] = np.asarray(json.dumps(st.as_dict()))
            with ops.deterministic_add_scope(True):
                lanes, st = ms.ms_ppr(sg, sources)
            out[f"ms/{ndev}/ms_ppr_det"] = np.asarray(lanes)
            out[f"ms/{ndev}/ms_ppr_det/stats"] = np.asarray(json.dumps(st.as_dict()))


def main(path, spec):
    out = {}
    parts = spec["parts"]
    if "cells" in parts:
        g, gs, source = graphs(spec)
        red_graphs = {}
        for name, cell in spec["cells"].items():
            sg = run_cell(out, name, g, gs, source, cell)
            if name in spec["reduce_modes"]:
                red_graphs[spec["reduce_modes"][name]] = sg
        reduce_cases(out, red_graphs, spec)
    if "hub" in parts:
        hub_cell(out)
    if "bsp" in parts:
        bsp_cells(out, spec)
    if "ms" in parts:
        multisource_cells(out, spec)
    np.savez(path, **out)
    print("SHARDED_REFERENCE_OK")


main(sys.argv[1], json.loads(open(sys.argv[2]).read()))
'''


def compile_cache_env(tmp_dir: Path) -> dict:
    """JAX's persistent compilation cache in ``tmp_dir``, every program
    kept: the reference's runs trace many programs twice under new closures
    (about half of a run's compiles), which the cache, keyed by the lowered
    program, compiles once.  The executables are the same either way."""
    return {"JAX_COMPILATION_CACHE_DIR": str(tmp_dir / "jax_cache"),
            "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0",
            "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES": "0"}


def run_reference(tmp_dir: Path, spec: dict) -> dict:
    """Run ``REFERENCE`` for ``spec`` in a fresh interpreter (with a
    compilation cache of its own); its npz as a dict of arrays."""
    spec_path, out = tmp_dir / "spec.json", tmp_dir / "reference.npz"
    spec_path.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               **compile_cache_env(tmp_dir))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(out), str(spec_path)],
                       capture_output=True, text=True, timeout=900, env=env, cwd=ROOT)
    assert "SHARDED_REFERENCE_OK" in r.stdout, r.stdout + r.stderr[-4000:]
    with np.load(out) as data:
        return {k: data[k] for k in data.files}


def ref_stats(ref, key) -> dict:
    return json.loads(str(ref[key + "/stats"]))


def stats_match(want: dict, st, where):
    got = st.as_dict()
    assert got.pop("substrate") == "torch", where   # CPU tensors: the plain versions
    want = dict(want)
    want.pop("substrate")
    assert got == want, where


def mesh_for(ndev, grid):
    if grid:
        return Mesh({"data": grid[0], "model": grid[1]}, device="cpu"), ("data", "model")
    return Mesh({"data": ndev}, device="cpu"), ("data",)


CELLS = {
    "oec1": dict(ndev=1, grid=None, policy="blocked", reducer="cvc"),
    "oec2": dict(ndev=2, grid=None, policy="blocked", reducer="cvc"),
    "oec4": dict(ndev=4, grid=None, policy="blocked", reducer="cvc"),
    "oec8": dict(ndev=8, grid=None, policy="blocked", reducer="cvc"),
    "local4": dict(ndev=4, grid=None, policy="local", reducer="cvc"),
    "interleaved4": dict(ndev=4, grid=None, policy="interleaved", reducer="cvc"),
    "full1": dict(ndev=1, grid=None, policy="blocked", reducer="full"),
    "full8": dict(ndev=8, grid=None, policy="blocked", reducer="full"),
    "cvc22": dict(ndev=4, grid=[2, 2], policy="blocked", reducer="cvc"),
    "cvc24": dict(ndev=8, grid=[2, 4], policy="blocked", reducer="cvc"),
}
# this module runs the 1-D cells; test_torch_sharded_grid.py the others
OEC_CELLS = ("oec1", "oec2", "oec4", "oec8", "local4", "interleaved4")
GRID_CELLS = ("full1", "full8", "cvc22", "cvc24")
REDUCE_MODES = {"oec8": "owner1d", "full8": "full", "cvc24": "cvc2d"}
REDUCE_CASES = [("min", "float32"), ("max", "float32"), ("add", "float32"),
                ("min", "int32"), ("max", "int32"), ("add", "int32"),
                ("or", "bool"), ("min", "bool")]


def spec(cells, parts):
    """The reference run for ``cells`` (and the reducer cases of those
    that name a mode)."""
    return dict(parts=list(parts), web=[6, 3, 5, 2], seed=11,
                cells={c: CELLS[c] for c in cells},
                reduce_modes={c: m for c, m in REDUCE_MODES.items() if c in cells},
                reduce_cases=REDUCE_CASES)


SPEC = spec(OEC_CELLS, ["cells", "hub"])
# PERF.md §2's limits for the float sums' last bits across packages
TOL = {"pagerank": dict(rtol=1e-4, atol=1e-10), "bc": dict(rtol=1e-3, atol=1e-4)}
ALGOS = ("bfs", "bfs_perround", "sssp", "cc", "bc", "pagerank", "kcore", "tc")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("sharded"), SPEC)


@pytest.fixture(scope="module")
def port_graphs():
    src, dst, n = jgen.web_crawl_like(6, 3, 5, 2, seed=11)
    w = jgen.random_weights(len(src), seed=12)
    jg = jfrom_coo(src, dst, n, w, block_size=16, build_csc=True)
    jgs = jfrom_coo(src, dst, n, block_size=16, symmetrize=True)
    source = int(np.argmax(np.bincount(np.asarray(jg.src_idx)[: jg.m], minlength=n)))
    return port_graph(jg), port_graph(jgs), source


@pytest.fixture(scope="module")
def port_det(port_graphs):
    """bc and pagerank under deterministic add on the unsharded graph: the
    sharded runs are bitwise to these (the packages' float ops round
    alike only up to the final normalising sums: PR_TOL / BC_TOL)."""
    g, _, source = port_graphs
    with tops.deterministic_add_scope(True):
        return {"bc": bc.bc_brandes(g, source)[0].numpy(),
                "pagerank": pagerank.pr_push(g)[0].numpy()}


def shard_cell(g, cell, **kw):
    mesh, axes = mesh_for(cell["ndev"], cell["grid"])
    extra = dict(scheme="cvc", grid=tuple(cell["grid"])) if cell["grid"] else {}
    return shard_graph(g, mesh, axes, policy=cell["policy"], reducer=cell["reducer"],
                       **extra, **kw)


def run_port(sg, sgs, source):
    res = {}
    before = teng.fetch.calls
    res["bfs"] = bfs.bfs_dd_sparse(sg, source)
    fetches = teng.fetch.calls - before
    res["bfs_perround"] = bfs.bfs_dd_sparse(sg, source, fused=False)
    res["sssp"] = sssp.sssp_dd_sparse(sg, source)
    res["cc"] = cc.cc_dd_sparse(sgs)
    with tops.deterministic_add_scope(True):
        res["bc"] = bc.bc_brandes(sg, source)
        res["pagerank"] = pagerank.pr_push(sg)
    res["kcore"] = kcore.kcore_dd_sparse(sgs, 2)
    res["tc"] = tc.tc_count(sgs, edge_chunk=256)
    return res, fetches


def check_cell(ref, port_graphs, port_det, cell, substrate):
    g, gs, source = port_graphs
    spec = CELLS[cell]
    sg, sgs = shard_cell(g, spec), shard_cell(gs, spec)
    with tops.substrate_scope(substrate):
        res, fetches = run_port(sg, sgs, source)
    for algo in ALGOS:
        labels, st = res[algo]
        want = ref[f"{cell}/{algo}"]
        got = np.asarray(labels) if algo == "tc" else labels.numpy()
        assert got.dtype == want.dtype, (cell, algo)
        if algo in port_det:
            assert np.array_equal(got, port_det[algo]), (cell, algo)
            np.testing.assert_allclose(got, want, **TOL[algo], err_msg=f"{cell} {algo}")
        else:
            assert np.array_equal(got, want), (cell, algo)
        stats_match(ref_stats(ref, f"{cell}/{algo}"), st, (cell, algo))
        assert st.ndev == spec["ndev"] and st.placement == spec["policy"]
    assert res["bfs"][1].sparse_rounds > 0 and res["sssp"][1].sparse_rounds > 0
    # one fetch per stretch: the reference's device_get count
    assert fetches == int(ref[f"{cell}/fetches"]), cell
    if spec["ndev"] == 1:
        assert res["bfs"][1].comm_elems == 0


def check_reducer(ref, port_graphs, cell, case):
    g, _, _ = port_graphs
    sg = shard_cell(g, CELLS[cell])
    assert sg.red.mode == REDUCE_MODES[cell]
    kind, dtype = case
    rng = np.random.default_rng(100 + REDUCE_CASES.index(case))
    if dtype == "bool":
        acc = rng.random((sg.ndev, sg.n_pad)) < 0.5
    else:
        acc = rng.integers(-50, 50, (sg.ndev, sg.n_pad)).astype(dtype)
    got = sg.red.reduce(torch.from_numpy(acc), kind).numpy()
    want = ref[f"reduce/{REDUCE_MODES[cell]}/{kind}/{dtype}"]
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("substrate", ["torch", "cuda"])
@pytest.mark.parametrize("cell", OEC_CELLS)
def test_cell_matches_reference(ref, port_graphs, port_det, cell, substrate):
    check_cell(ref, port_graphs, port_det, cell, substrate)


def test_cvc_reducers_cut_modelled_volume(port_graphs):
    """The communication-avoiding reducers against the full-mesh one on
    the same bfs: labels bitwise, and on the (2, 4) grid at least 2x fewer
    reduced elements (the reference's acceptance bar at ndev 8)."""
    g, _, source = port_graphs
    runs = {}
    for cell in ("cvc24", "oec8"):
        for reducer in ("cvc", "full"):
            runs[cell, reducer] = bfs.bfs_dd_sparse(
                shard_cell(g, dict(CELLS[cell], reducer=reducer)), source)
    for cell in ("cvc24", "oec8"):
        (lc, sc), (lf, sf) = runs[cell, "cvc"], runs[cell, "full"]
        assert torch.equal(lc, lf)
        assert sc.comm_elems < sf.comm_elems and sc.comm_bytes < sf.comm_bytes
    sc, sf = runs["cvc24", "cvc"][1], runs["cvc24", "full"][1]
    assert sc.comm_elems * 2 <= sf.comm_elems
    assert sc.reduce_axis_hops < sf.reduce_axis_hops


@pytest.mark.parametrize("case", REDUCE_CASES, ids=lambda c: "-".join(c))
def test_owner1d_reducer_matches_reference(ref, port_graphs, case):
    check_reducer(ref, port_graphs, "oec8", case)


def test_hub_cell_escalates_and_fused_equals_per_round(ref):
    hub_src = np.concatenate([np.zeros(64, np.int64), np.arange(1, 64, dtype=np.int64)])
    hub_dst = np.concatenate([np.arange(1, 65, dtype=np.int64),
                              np.arange(2, 65, dtype=np.int64)])
    gh = port_graph(jfrom_coo(hub_src, hub_dst, 65, block_size=16))
    sgh = shard_graph(gh, Mesh({"data": 8}, device="cpu"), ("data",), policy="blocked")
    before = teng.fetch.calls
    d, st = bfs.bfs_dd_sparse(sgh, 0)
    fetches = teng.fetch.calls - before
    dp, stp = bfs.bfs_dd_sparse(sgh, 0, fused=False)
    assert np.array_equal(d.numpy(), ref["hub/bfs"])
    assert np.array_equal(dp.numpy(), ref["hub/bfs_perround"])
    stats_match(ref_stats(ref, "hub/bfs"), st, "fused")
    stats_match(ref_stats(ref, "hub/bfs_perround"), stp, "per round")
    assert st.shard_escalations > 0 and st.shard_escalations == stp.shard_escalations
    assert fetches == int(ref["hub/fetches"])


@pytest.mark.parametrize("vertex_mask", [True, False])
@pytest.mark.parametrize("kind", ["min", "add", "or"])
def test_gated_relax_plain_version(vertex_mask, kind):
    """``edge_relax(gate=)`` on CPU tensors: gate 1 is the ungated relax,
    gate 0 returns ``out_init`` (bitwise, including its -0.0 and +inf)."""
    rng = np.random.default_rng(5)
    n_pad, m = 64, 300
    src = torch.from_numpy(rng.integers(0, n_pad - 1, m).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, n_pad - 1, m).astype(np.int32))
    w = torch.from_numpy(rng.uniform(1, 4, m).astype(np.float32))
    mask = torch.from_numpy(rng.random(n_pad if vertex_mask else m) < 0.5)
    if kind == "or":
        sv = torch.from_numpy(rng.random(n_pad) < 0.5)
        init = torch.zeros(n_pad, dtype=torch.bool)
    else:
        sv = torch.from_numpy(rng.uniform(0, 9, n_pad).astype(np.float32))
        init = torch.from_numpy(rng.uniform(0, 9, n_pad).astype(np.float32))
        init[0], init[1] = -0.0, float("inf")
    kw = dict(kind=kind, use_weight=kind != "or", vertex_mask=vertex_mask)
    plain = tgk.edge_relax(src, dst, w, mask, sv, init, **kw)
    on = tgk.edge_relax(src, dst, w, mask, sv, init, gate=torch.ones((), dtype=torch.int32), **kw)
    off = tgk.edge_relax(src, dst, w, mask, sv, init, gate=torch.zeros((), dtype=torch.int32), **kw)
    assert torch.equal(on.view(torch.uint8) if on.dtype == torch.bool else on.view(torch.int32),
                       plain.view(torch.uint8) if plain.dtype == torch.bool else plain.view(torch.int32))
    bits = (lambda t: t.view(torch.uint8)) if kind == "or" else (lambda t: t.view(torch.int32))
    assert torch.equal(bits(off), bits(init))
    assert not torch.equal(bits(plain), bits(init))


def test_comm_model_closed_form():
    """Every collective over a K-group with payload L costs K·(K−1)·L
    element-hops (the reference's ``test_comm_model_analytics``)."""
    n_pad = 128
    assert CrossReducer("full", ("data",), 8, 1).comm_per_relax(n_pad) == (
        8 * 7 * 128, 4 * 8 * 7 * 128, 1)
    assert CrossReducer("full", ("data", "model"), 4, 2).comm_per_relax(n_pad)[2] == 2
    cvc = CrossReducer("cvc2d", ("data", "model"), 4, 2,
                       own_idx=torch.zeros((2, 64), dtype=torch.int32),
                       own_valid=torch.zeros((2, 64), dtype=torch.bool))
    e, _, h = cvc.comm_per_relax(n_pad)
    assert e == 2 * 4 * 3 * 64 + 4 * 2 * 1 * 64 and h == 1
    own = CrossReducer("owner1d", ("data",), 8, 1,
                       own_idx=torch.zeros((8, 16), dtype=torch.int32),
                       own_valid=torch.zeros((8, 16), dtype=torch.bool))
    e, _, h = own.comm_per_relax(n_pad)
    assert e == 2 * 8 * 7 * 16 and h == 1
    assert CrossReducer("full", ("data",), 1, 1).comm_per_relax(n_pad) == (0, 0, 0)


@pytest.mark.parametrize("reducer", ["cvc", "full"])
@pytest.mark.parametrize("cell", ["cvc22", "oec8"])
def test_widened_bool_min_stays_a_min(port_graphs, cell, reducer):
    """A bool ``min`` push is an AND across shards in every reducer mode."""
    g, _, _ = port_graphs
    rng = np.random.default_rng(7)
    sv = torch.from_numpy(rng.random(g.n_pad) < 0.5)
    act = torch.from_numpy(rng.random(g.n_pad) < 0.7)
    act[g.sentinel] = False
    init = torch.ones(g.n_pad, dtype=torch.bool)
    with tops.substrate_scope("torch"):
        want = tops.push_dense(g, sv, act, init, kind="min", use_weight=False)
        sg = shard_cell(g, dict(CELLS[cell], reducer=reducer))
        got = tops.push_dense(sg, sv, act, init, kind="min", use_weight=False)
    assert torch.equal(want, got)


def test_flat_views_cover_all_edges():
    src, dst, n = jgen.erdos(50, 300, seed=9)
    g = port_graph(jfrom_coo(src, dst, n, block_size=16))
    sg = shard_graph(g, Mesh({"data": 4}, device="cpu"), ("data",), policy="interleaved")
    real = sorted(zip(g.src_idx[: g.m].tolist(), g.col_idx[: g.m].tolist()))
    keep = sg.src_idx != sg.sentinel
    got = sorted(zip(sg.src_idx[keep].tolist(), sg.col_idx[keep].tolist()))
    assert got == real and int(keep.sum()) == g.m


@pytest.mark.parametrize("capacity", [16, 64])
def test_compact_local_matches_reference(port_graphs, capacity):
    g, _, _ = port_graphs
    sg = shard_cell(g, CELLS["oec4"])
    mask = torch.from_numpy(np.random.default_rng(capacity).random(g.n_pad) < 0.3)
    idx, count = tfr.compact_local(mask, sg.shard_deg, capacity, sg.sentinel)
    for d in range(sg.ndev):
        jidx, jcount = jfr.compact_local(jnp.asarray(mask.numpy()),
                                         jnp.asarray(sg.shard_deg[d].numpy()), capacity,
                                         sg.sentinel)
        assert np.array_equal(idx[d].numpy(), np.asarray(jidx))
        assert int(count[d]) == int(jcount)


@pytest.mark.parametrize("cell", ["oec4", "cvc24", "oec1"])
def test_round_scalars_sharded_branch(port_graphs, cell):
    """The upper median of the per-shard masses, the largest local count."""
    g, _, _ = port_graphs
    sg = shard_cell(g, CELLS[cell])
    mask = torch.from_numpy(np.random.default_rng(3).random(g.n_pad) < 0.2)
    mask[g.sentinel] = False
    like = types.SimpleNamespace(shard_deg=jnp.asarray(sg.shard_deg.numpy()),
                                 ndev=sg.ndev, budget_edge_mass=lambda m: jnp.sum(
                                     jnp.where(m, jnp.asarray(g.out_deg.numpy()), 0)))
    want = [int(x) for x in jfr.round_scalars(like, jnp.asarray(mask.numpy()))]
    assert tfr.round_scalars(sg, mask).tolist() == want


def test_mesh_over_distinct_devices_raises():
    with pytest.raises(NotImplementedError, match="item 23"):
        Mesh({"data": 2}, devices=["cuda:0", "cuda:1"])
    assert Mesh({"data": 2}, devices=["cpu", "cpu"]).device.type == "cpu"
