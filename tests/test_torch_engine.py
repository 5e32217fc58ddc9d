"""The port's frontier helpers and round engines against the JAX package.

``compact`` must reproduce ``jnp.nonzero(size=capacity)``'s slot order and
count; the ladder helpers and band predicates must make the reference's
decisions; and ``SparseLadderEngine`` — fused stretches and per-round
dispatch — must give the reference's labels and every ``RunStats``
counter, and the same as each other.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core import frontier as jfr  # noqa: E402
from repro.core import operators as jops  # noqa: E402
from repro.core.algorithms import bfs as jbfs  # noqa: E402
from repro.core.algorithms import cc as jcc  # noqa: E402
from repro.core.algorithms import sssp as jsssp  # noqa: E402
from repro.core.graph import from_coo as jfrom_coo  # noqa: E402
from repro.graphs import generators as gen  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import frontier as tfr  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core.algorithms import bfs as tbfs  # noqa: E402
from repro_torch.core.algorithms import cc as tcc  # noqa: E402
from repro_torch.core.algorithms import sssp as tsssp  # noqa: E402
from test_torch_graph import GRAPHS, port_graph  # noqa: E402


def stats_equal(js, ts):
    a, b = js.as_dict(), ts.as_dict()
    assert a.pop("substrate") in jops.SUBSTRATES
    assert b.pop("substrate") in tops.SUBSTRATES
    assert a == b


@pytest.mark.parametrize("density", [0.0, 0.05, 0.3, 1.0])
@pytest.mark.parametrize("capacity", [64, 256, 1024])
def test_compact_matches_nonzero(capacity, density):
    rng = np.random.default_rng(int(density * 100) + capacity)
    n_pad = 512
    mask = rng.random(n_pad) < density
    jf = jfr.compact(jnp.asarray(mask), capacity, n_pad - 1)
    tf = tfr.compact(torch.from_numpy(mask), capacity, n_pad - 1)
    np.testing.assert_array_equal(np.asarray(jf.idx), tf.idx.numpy())
    assert tf.idx.dtype == torch.int32 and tf.count.dtype == torch.int32
    assert int(jf.count) == int(tf.count)
    assert bool(jf.overflowed()) == bool(tf.overflowed())
    np.testing.assert_array_equal(np.asarray(jf.valid_slots()),
                                  tf.valid_slots().numpy())


def test_ladder_helpers():
    for n_pad, block, base in ((512, 64, 4), (4096, 64, 4), (70_000, 512, 4),
                               (3000, 64, 2)):
        lad = tfr.ladder_capacities(n_pad, block, base)
        assert lad == jfr.ladder_capacities(n_pad, block, base)
        for count in (0, 1, block - 1, block, block + 1, n_pad // 3, n_pad,
                      n_pad + 5):
            assert tfr.pick_capacity(count, lad) == jfr.pick_capacity(count, lad)
        for rung in lad:
            assert tfr.ladder_below(rung, lad) == jfr.ladder_below(rung, lad)


def test_round_scalars_and_bands():
    src, dst, n = GRAPHS["web_like"]()
    jg = jfrom_coo(src, dst, n, block_size=64)
    tg = port_graph(jg)
    rng = np.random.default_rng(4)
    lad = tfr.ladder_capacities(tg.m_pad, tg.block_size)
    cutoff = lad[-1] // 2
    for density in (0.0, 0.01, 0.1, 0.5):
        mask = rng.random(jg.n_pad) < density
        js = [int(x) for x in jfr.round_scalars(jg, jnp.asarray(mask))]
        ts = tfr.round_scalars(tg, torch.from_numpy(mask))
        assert js == ts.tolist()
        assert bool(jfr.dense_band(js, cutoff)) == bool(tfr.dense_band(ts, cutoff))
        for budget in lad:
            lo = tfr.ladder_below(budget, lad)
            for cap in (64, 256, jg.n_pad):
                args = (cap, cap // 4, budget, lo, cutoff)
                assert bool(jfr.sparse_band(js, *args)) == bool(
                    tfr.sparse_band(ts, *args))


def test_run_dense_contract():
    rounds, state = teng.run_dense(lambda s: s + 1, 0, lambda s: s < 5, 100)
    assert (rounds, state) == (5, 5)
    assert teng.run_host(lambda s: s + 1, 0, lambda s: s < 5, 3) == (3, 3)


def test_runstats_fields_match():
    jf = {f.name: f.default for f in dataclasses.fields(jeng.RunStats)}
    tf = {f.name: f.default for f in dataclasses.fields(teng.RunStats)}
    assert list(jf) == list(tf)
    jf.pop("substrate"), tf.pop("substrate")
    assert jf == tf


ENGINE_CASES = {
    "bfs": (jbfs._sparse_step, jbfs._dense_step, tbfs._sparse_step,
            tbfs._dense_step),
    "sssp": (jsssp._sssp_sparse_step, jsssp._sssp_dense_step,
             tsssp._sssp_sparse_step, tsssp._sssp_dense_step),
    "cc": (jcc._cc_sparse_step, jcc._cc_dense_step, tcc._cc_sparse_step,
           tcc._cc_dense_step),
}


def engine_graph(gname, sym):
    if gname == "chain":
        src, dst, n = gen.web_crawl_like(24, 4, 6, 2, seed=3)
    else:
        src, dst, n = GRAPHS[gname]()
    w = np.random.default_rng(1).uniform(1, 8, len(src)).astype(np.float32)
    jg = jfrom_coo(src, dst, n, None if sym else w, block_size=64,
                   symmetrize=sym)
    return jg, port_graph(jg)


@pytest.mark.parametrize("gname", ["chain", "hub_leaves", "erdos"])
@pytest.mark.parametrize("algo", list(ENGINE_CASES))
def test_sparse_ladder_engine_matches_jax(algo, gname):
    jsp, jdn, tsp, tdn = ENGINE_CASES[algo]
    jg, tg = engine_graph(gname, sym=algo == "cc")
    if algo == "cc":
        jlab0 = jnp.arange(jg.n_pad, dtype=jnp.int32)
        jmask0 = jg.valid_vertex_mask()
        tlab0 = torch.arange(tg.n_pad, dtype=torch.int32)
        tmask0 = tg.valid_vertex_mask()
    else:
        inf = np.finfo(np.float32).max
        d0 = np.full(jg.n_pad, inf, np.float32)
        d0[0] = 0.0
        m0 = np.zeros(jg.n_pad, bool)
        m0[0] = True
        jlab0, jmask0 = jnp.asarray(d0), jnp.asarray(m0)
        tlab0, tmask0 = torch.from_numpy(d0), torch.from_numpy(m0)
    results = {}
    for fused in (True, False):
        je = jeng.SparseLadderEngine(jg, jsp, jdn, fused=fused)
        jlab, _ = je.run(jlab0, jmask0)
        te = teng.SparseLadderEngine(tg, tsp, tdn, fused=fused)
        tlab, _ = te.run(tlab0.clone(), tmask0.clone())
        np.testing.assert_array_equal(np.asarray(jlab), tlab.numpy())
        stats_equal(je.stats, te.stats)
        assert te.stats.substrate == "torch"   # CPU tensors: no kernel ran
        results[fused] = (tlab, te.stats)
    assert torch.equal(results[True][0], results[False][0])
    a, b = results[True][1].as_dict(), results[False][1].as_dict()
    a.pop("compiles"), b.pop("compiles")   # stretch keys vs rung steps
    assert a == b
    assert results[True][1].rounds > 0


def test_engine_max_rounds_cuts_both_regimes():
    jg, tg = engine_graph("chain", sym=False)
    d0 = np.full(jg.n_pad, np.finfo(np.float32).max, np.float32)
    d0[0] = 0.0
    m0 = np.zeros(jg.n_pad, bool)
    m0[0] = True
    for fused in (True, False):
        je = jeng.SparseLadderEngine(jg, jbfs._sparse_step, jbfs._dense_step,
                                     fused=fused)
        jlab, _ = je.run(jnp.asarray(d0), jnp.asarray(m0), max_rounds=3)
        te = teng.SparseLadderEngine(tg, tbfs._sparse_step, tbfs._dense_step,
                                     fused=fused)
        tlab, _ = te.run(torch.from_numpy(d0.copy()), torch.from_numpy(m0.copy()),
                         max_rounds=3)
        assert te.stats.rounds == 3
        np.testing.assert_array_equal(np.asarray(jlab), tlab.numpy())
        stats_equal(je.stats, te.stats)


def test_sparse_round_and_small_ops_match():
    jg, tg = engine_graph("erdos", sym=False)
    rng = np.random.default_rng(2)
    mask = rng.random(jg.n_pad) < 0.1
    mask[jg.sentinel] = False
    dist = rng.uniform(0, 50, jg.n_pad).astype(np.float32)
    jout, jesc = jops.sparse_round(jg, jnp.asarray(dist), jnp.asarray(mask),
                                   jnp.asarray(dist), capacity=256, budget=1024)
    tout, tesc = tops.sparse_round(tg, torch.from_numpy(dist),
                                   torch.from_numpy(mask),
                                   torch.from_numpy(dist), capacity=256,
                                   budget=1024)
    np.testing.assert_array_equal(np.asarray(jout), tout.numpy())
    assert int(jesc) == int(tesc) == 0
    np.testing.assert_array_equal(
        np.asarray(jops.updated_mask(jnp.asarray(dist), jout)),
        tops.updated_mask(torch.from_numpy(dist), tout).numpy())
    for fe, ue, fc, cur in ((100.0, 900.0, 3.0, False), (10.0, 900.0, 3.0, False),
                            (10.0, 900.0, 1.0, True), (10.0, 900.0, 50.0, True)):
        j = jops.direction_choice(jg, jnp.float32(fe), jnp.float32(ue),
                                  jnp.float32(fc), jnp.bool_(cur))
        t = tops.direction_choice(tg, torch.tensor(fe), torch.tensor(ue),
                                  torch.tensor(fc), torch.tensor(cur))
        assert bool(j) == bool(t)


def test_substrate_selection_api():
    assert tops.get_substrate() == "cuda"
    with tops.substrate_scope("torch"):
        assert tops.get_substrate() == "torch"
    assert tops.get_substrate() == "cuda"
    with pytest.raises(ValueError):
        tops.set_substrate("pallas")
    with tops.deterministic_add_scope(True):
        assert tops.get_deterministic_add()
    assert not tops.get_deterministic_add()
    for name in ("batched_push_dense", "batched_relax_batch", "intersect_batch"):
        with pytest.raises(NotImplementedError):
            getattr(tops, name)()
