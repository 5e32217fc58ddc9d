"""The port's graph query server (``repro_torch.launch.graph_serve``) and its
serving suite against the JAX package's.

Every case runs the same requests through the port's ``GraphServer`` and
the reference's: each request must come back with the reference's outcome
(done, reject reason, slot, rounds ridden, enqueue tick) and labels
bitwise equal (ppr: allclose, rtol 1e-5 / atol 1e-7, the reference
test's), and bitwise equal to its source's sequential run.  The chaos
cases follow ``tests/test_chaos.py``'s serving-tier drills.  The suite's
rows are held to the JAX suite's counters and to ``ci_gate serve``.
"""

import argparse
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import from_coo as jfrom_coo  # noqa: E402
from repro.distributed.fault import StragglerMonitor as JStragglerMonitor  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.launch import graph_serve as jgs  # noqa: E402
from repro_torch.benchmarks import serving as tserving  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.algorithms import bfs as tbfs  # noqa: E402
from repro_torch.core.algorithms import pagerank as tpr  # noqa: E402
from repro_torch.core.algorithms import sssp as tsssp  # noqa: E402
from repro_torch.distributed.fault import StragglerMonitor  # noqa: E402
from repro_torch.launch import graph_serve as tgs  # noqa: E402
from test_torch_graph import port_graph  # noqa: E402

SEQ = {"bfs": tbfs.bfs_dd_sparse, "sssp": tsssp.sssp_dd_sparse}
FIELDS = ("done", "reject_reason", "slot", "rounds", "enqueue_tick")


def _rmat_graph(weighted=False):
    src, dst, n = jgen.rmat(7, 8, seed=3)
    w = jgen.random_weights(len(src), seed=4) if weighted else None
    jg = jfrom_coo(src, dst, n, w, block_size=64)
    return jg, port_graph(jg), n


def _serve_graph(seed=1, n=256, m=2048):
    """test_chaos.py's serving graph, in both packages."""
    rng = np.random.default_rng(seed)
    jg = jfrom_coo(rng.integers(0, n, m), rng.integers(0, n, m), n, build_csc=True)
    return jg, port_graph(jg)


def both(jg, tg, specs, server_kw=None, serve_kw=None, straggler=None):
    """Serve ``specs`` (QueryRequest kwargs) on both packages' servers;
    returns (port server, port requests, JAX server, JAX requests) after
    checking each request's outcome against the reference's."""
    server_kw = server_kw or {}
    out = []
    for mod, g, mon in ((tgs, tg, StragglerMonitor), (jgs, jg, JStragglerMonitor)):
        kw = dict(server_kw)
        if straggler is not None:
            kw["straggler"] = mon(**straggler)
        srv = mod.GraphServer(g, **kw)
        reqs = [mod.QueryRequest(**s) for s in specs]
        srv.serve(reqs, **(serve_kw or {}))
        out += [srv, reqs]
    tsrv, treqs, jsrv, jreqs = out
    ppr = server_kw.get("algo") == "ppr"
    for a, b in zip(treqs, jreqs):
        for f in FIELDS:
            assert getattr(a, f) == getattr(b, f), (a.rid, f)
        assert (a.labels is None) == (b.labels is None), a.rid
        if a.labels is None:
            continue
        assert a.labels.dtype == np.asarray(b.labels).dtype
        if ppr:
            np.testing.assert_allclose(a.labels, np.asarray(b.labels),
                                       rtol=1e-5, atol=1e-7)
        else:
            np.testing.assert_array_equal(a.labels, np.asarray(b.labels))
    for k in ("deadline_evictions", "overload_sheds", "remesh_signals", "tick_no"):
        assert getattr(tsrv, k) == getattr(jsrv, k), k
    for k in ("rounds", "edges_touched", "sparse_rounds", "dense_rounds",
              "compiles", "sources"):
        assert getattr(tsrv.eng.stats, k) == getattr(jsrv.eng.stats, k), k
    return tsrv, treqs, jsrv, jreqs


def test_graph_server_batched_equals_sequential():
    """More requests than slots + ragged arrivals: every served row bitwise
    the request's isolated per-source run (and the reference server's),
    freed slots backfilling mid-flight."""
    jg, tg, n = _rmat_graph(weighted=True)
    rng = np.random.default_rng(4)
    srcs = [int(s) for s in rng.integers(0, n, 10)]
    specs = [dict(rid=i, source=s, arrive_round=(0 if i < 5 else 2 + i))
             for i, s in enumerate(srcs)]
    server, out, _, _ = both(jg, tg, specs, dict(algo="sssp", max_batch=3))
    assert all(r.done for r in out)
    for r in out:
        ref, _ = SEQ["sssp"](tg, r.source)
        assert np.array_equal(r.labels, ref.numpy()), r.rid
        assert r.rounds > 0 and r.t_done >= r.t_enqueue
    slots_used = {r.slot for r in out}
    assert len(out) > server.max_batch >= len(slots_used)
    assert server.eng.stats.sources <= server.max_batch


def test_graph_server_one_fetch_per_tick():
    """A serving tick makes exactly one ``engine.fetch``: the union ladder
    scalars and every lane's alive flag in one transfer."""
    _, tg, n = _rmat_graph()
    server = tgs.GraphServer(tg, algo="bfs", max_batch=4)
    before = teng.fetch.calls
    server.serve([tgs.QueryRequest(rid=i, source=i, arrive_round=i)
                  for i in range(6)])
    assert teng.fetch.calls - before == server.tick_no


def test_graph_server_ppr_and_validation():
    jg, tg, n = _rmat_graph()
    specs = [dict(rid=i, source=s) for i, s in enumerate([2, 9, 33, 77])]
    _, out, _, _ = both(jg, tg, specs, dict(algo="ppr", max_batch=2))
    for r in out:
        ref, _ = tpr.ppr_push(tg, r.source)
        np.testing.assert_allclose(r.labels, ref.numpy(), rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError):
        tgs.GraphServer(tg, algo="bfs", max_batch=2).admit(
            tgs.QueryRequest(rid=0, source=n))
    with pytest.raises(ValueError):
        tgs.GraphServer(tg, algo="nope")


# ---------------------------------------------------------------------------
# Graceful degradation (tests/test_chaos.py's serving-tier drills)
# ---------------------------------------------------------------------------


def test_deadline_eviction_frees_slot_for_backfill():
    jg, tg = _serve_graph()
    specs = [dict(rid=0, source=0, deadline_ticks=1), dict(rid=1, source=1),
             dict(rid=2, source=2, arrive_round=1)]
    srv, out, _, _ = both(jg, tg, specs, dict(algo="bfs", max_batch=2))
    evicted, survivor, backfill = out
    assert evicted.done and evicted.reject_reason == "deadline"
    assert evicted.labels is None
    assert survivor.reject_reason is None and survivor.labels is not None
    assert backfill.reject_reason is None and backfill.labels is not None
    for r in (survivor, backfill):
        assert np.array_equal(r.labels, SEQ["bfs"](tg, r.source)[0].numpy())
    assert srv.deadline_evictions == 1
    assert not srv.slots[0] and not srv.slots[1]


def test_eviction_backfills_within_one_tick():
    _, tg = _serve_graph()
    srv = tgs.GraphServer(tg, algo="bfs", max_batch=1)
    stuck = tgs.QueryRequest(rid=0, source=0, deadline_ticks=2)
    nxt = tgs.QueryRequest(rid=1, source=1)
    ready = [stuck, nxt]
    srv.tick(ready)               # tick 0: stuck admitted, nxt queued
    assert stuck.slot == 0 and nxt.slot == -1
    srv.tick(ready)               # tick 1: still within deadline
    assert not stuck.done
    srv.tick(ready)               # tick 2: evict AND admit nxt, same tick
    assert stuck.done and stuck.reject_reason == "deadline"
    assert nxt.slot == 0 and srv.slots[0] is nxt
    # nxt's row was written into the slot in place: its source at 0
    assert float(srv.labels[0, 1]) == 0.0


@pytest.mark.parametrize("substrate", ["torch", "cuda"])
def test_slot_evicted_and_refilled_mid_run_serves_its_own_run(substrate):
    """A sssp lane evicted by its deadline mid-run and its slot refilled
    the same tick by a waiting request: the refill's labels bitwise its
    per-source run (and the reference server's), though the slot's rows in
    both of the steps' label buffers held the evicted run's labels; the
    eviction resets both buffers' rows (``eng.reset_lane``)."""
    from repro_torch.core import operators as tops
    jg, tg, n = _rmat_graph(weighted=True)
    rounds = {s: SEQ["sssp"](tg, s)[1].rounds for s in range(n)}
    long_ = [s for s in range(n) if rounds[s] >= 6]
    s0, s1, s2 = long_[0], long_[1], long_[2]
    specs = [dict(rid=0, source=s0, deadline_ticks=3), dict(rid=1, source=s1),
             dict(rid=2, source=s2, arrive_round=1)]
    with tops.substrate_scope(substrate):
        srv, out, _, _ = both(jg, tg, specs, dict(algo="sssp", max_batch=2))
    evicted, survivor, refill = out
    assert evicted.reject_reason == "deadline" and evicted.labels is None
    assert refill.slot == evicted.slot and refill.rounds > 0
    for r in (survivor, refill):
        assert np.array_equal(r.labels, SEQ["sssp"](tg, r.source)[0].numpy()), r.rid
    # an eviction resets the lane's rows in both label buffers
    srv = tgs.GraphServer(tg, algo="sssp", max_batch=2)
    srv.admit(tgs.QueryRequest(rid=0, source=s0))
    srv.admit(tgs.QueryRequest(rid=1, source=s1))
    for _ in range(3):
        srv.tick([])
    spare = srv.steps._spare[0]
    assert bool((srv.labels[1] < srv.inf).any()) and bool((spare[1] < srv.inf).any())
    srv.eng.reset_lane(srv.labels, srv.fmat, 1)
    for buf in (srv.labels, spare):
        assert bool((buf[1] == srv.inf).all())
    assert not bool(srv.fmat[1].any())


def test_ppr_eviction_does_not_resurrect_the_lane():
    jg, tg = _serve_graph()
    specs = [dict(rid=0, source=0, deadline_ticks=1), dict(rid=1, source=1)]
    srv, out, _, _ = both(jg, tg, specs, dict(algo="ppr", max_batch=2))
    assert out[0].reject_reason == "deadline"
    assert out[1].labels is not None
    assert not srv.tick([])


def test_bounded_ready_queue_sheds_overload_newest_first():
    jg, tg = _serve_graph()
    specs = [dict(rid=i, source=i) for i in range(5)]
    srv, out, _, _ = both(jg, tg, specs, dict(algo="bfs", max_batch=1, max_ready=1))
    assert all(r.done for r in out)
    shed = [r.rid for r in out if r.reject_reason == "overload"]
    served = [r.rid for r in out if r.reject_reason is None]
    assert srv.overload_sheds == len(shed) > 0
    assert 0 in served
    assert max(served) < min(shed)


def test_queued_deadline_expiry_sheds_without_service():
    jg, tg = _serve_graph()
    specs = [dict(rid=0, source=0), dict(rid=1, source=1, deadline_ticks=1)]
    _, out, _, _ = both(jg, tg, specs, dict(algo="bfs", max_batch=1))
    assert out[0].labels is not None
    assert out[1].reject_reason == "deadline" and out[1].rounds == 0


def test_direct_admit_bypassing_tick_still_starts_deadline_clock():
    _, tg = _serve_graph()
    srv = tgs.GraphServer(tg, algo="bfs", max_batch=1)
    req = tgs.QueryRequest(rid=0, source=0, deadline_ticks=1)
    assert srv.admit(req)
    assert req.enqueue_tick == 0
    for _ in range(8):
        if not srv.tick([]):
            break
    assert req.done and req.reject_reason == "deadline"
    assert req.labels is None
    assert srv.deadline_evictions == 1


def test_straggler_monitor_hooks_tick_wall_time():
    _, tg = _serve_graph()
    srv = tgs.GraphServer(tg, algo="bfs", max_batch=2,
                          straggler=StragglerMonitor(threshold=0.0, patience=1))
    srv.serve([tgs.QueryRequest(rid=i, source=i) for i in range(6)])
    assert srv.remesh_signals > 0


def test_serve_stuck_raises_typed_error_naming_requests():
    _, tg = _serve_graph()
    srv = tgs.GraphServer(tg, algo="bfs", max_batch=1)
    with pytest.raises(tgs.ServeStuckError, match=r"rid 7 \(slot 0\)"):
        srv.serve([tgs.QueryRequest(rid=7, source=3)], max_ticks=1)
    srv = tgs.GraphServer(tg, algo="bfs", max_batch=1)
    with pytest.raises(tgs.ServeStuckError, match=r"rid 9 \(queued\)"):
        srv.serve([tgs.QueryRequest(rid=8, source=3),
                   tgs.QueryRequest(rid=9, source=4)], max_ticks=1)


def test_no_deadline_requests_run_to_completion_unchanged():
    jg, tg = _serve_graph()
    specs = [dict(rid=i, source=i) for i in range(8)]
    _, out_a, _, _ = both(jg, tg, specs, dict(algo="bfs", max_batch=4))
    b, out_b, _, _ = both(jg, tg, specs, dict(algo="bfs", max_batch=4, max_ready=100),
                          straggler=dict())
    for ra, rb in zip(out_a, out_b):
        assert np.array_equal(ra.labels, rb.labels)
    assert b.deadline_evictions == 0 and b.overload_sheds == 0


# ---------------------------------------------------------------------------
# The serving suite and the entry point
# ---------------------------------------------------------------------------


def test_serving_rows_match_jax_suite_and_pass_ci_gate(tmp_path, monkeypatch):
    """The port's ``benchmarks/serving.py`` rows (one timed call each) carry
    the JAX suite's counters on its graph and sources, pass ``ci_gate
    serve``'s rules, and the lanes equal the per-source runs."""
    import benchmarks.serving as jserving
    from benchmarks import ci_gate
    from repro_torch.benchmarks.common import rows_as_json

    monkeypatch.setattr(jserving, "time_call", lambda fn, *a, **k: (fn(*a), 0.0)[1])
    want = {name: stats for name, _, _, stats in jserving.run()}
    results = {}
    rows = tserving.run(warmup=0, iters=1, device="cpu", results=results)
    assert [r[0] for r in rows] == list(want)
    keys = ("rounds", "edges_touched", "sparse_rounds", "dense_rounds", "compiles",
            "overflow_escalations", "sources", "edges_per_source", "bitwise_equal",
            "requests", "max_batch")
    for name, _, _, stats in rows:
        for k in keys:
            assert stats.get(k) == want[name].get(k), (name, k)
        assert stats["substrate"] == "torch"
    for algo in ("bfs", "sssp"):
        assert torch.equal(results[f"serving/seq_{algo}"],
                           results[f"serving/batched_{algo}_b8"])
    _, sources = tserving.containers("cpu")
    seq = results["serving/seq_bfs"]
    for r in results["serving/server_bfs"]:
        assert np.array_equal(r.labels, seq[sources.index(r.source)].numpy()), r.rid
    path = tmp_path / "BENCH_serving.json"
    path.write_text(json.dumps(rows_as_json("serving", rows)))
    args = argparse.Namespace(bench=str(path), max_frac=0.5, min_qps=5.0,
                              algos="bfs,sssp")
    assert ci_gate.cmd_serve(args) == 0


def test_graph_serve_main_runs_on_the_cpu(capsys):
    tgs.main(["--device", "cpu", "--requests", "6", "--algo", "sssp"])
    out = capsys.readouterr().out
    assert "GRAPH_SERVE_OK" in out and out.count("req ") == 6
