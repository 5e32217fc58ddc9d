"""The port's multi-source batched traversal against the JAX package, case by
case after ``tests/test_multisource.py``.

The contract (core/multisource.py): B lanes share ONE edge sweep per round,
and every lane's labels are bitwise equal to the per-source ``*_dd_sparse``
run, on either substrate; ``RunStats`` counters equal the JAX engine's.
On the CPU the ``"cuda"`` substrate's wrappers take the plain versions, so
the kernel's own design is checked here by a model of it
(``lanes_kernel_model``: the lane words, the set bits, the per-lane clamp,
the in-place reseed and the changed bits; the in-place cases are in
``test_torch_lanes_design.py``) held to the plain version; on the card
``chip_smoke.py`` holds the kernel.

Tolerances: bitwise for min/max/or, int32 and deterministic add; plain
float add allclose (rtol 1e-6 on the refs, the scatter-add order is the
backend's); PPR lanes against per-source runs rtol 1e-5 / atol 1e-7 (the
reference test's).
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

try:  # the property layer needs hypothesis; everything else runs without
    from hypothesis import given, settings, strategies as st
    HAVE_HYP = True
except ImportError:
    HAVE_HYP = False

from repro.core import from_coo as jfrom_coo  # noqa: E402
from repro.core import frontier as jfr  # noqa: E402
from repro.core import multisource as jms  # noqa: E402
from repro.core import operators as jops  # noqa: E402
from repro.core import tier_graph as jtier_graph  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro.kernels.graph_ops import ref as jref  # noqa: E402
from repro_torch.core import frontier as tfr  # noqa: E402
from repro_torch.core import multisource as tms  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core import tier_graph  # noqa: E402
from repro_torch.core.algorithms import bfs as tbfs  # noqa: E402
from repro_torch.core.algorithms import pagerank as tpr  # noqa: E402
from repro_torch.core.algorithms import sssp as tsssp  # noqa: E402
from repro_torch.kernels import graph_ops as tgk  # noqa: E402
from repro_torch.kernels.graph_ops import ref as tref  # noqa: E402
from test_torch_graph import port_graph  # noqa: E402

COUNTERS = ("rounds", "edges_touched", "sparse_rounds", "dense_rounds",
            "compiles", "overflow_escalations", "sources")
SUB = {"torch": "jnp", "cuda": "pallas"}


def _graph(n, edges, seed):
    """The reference test's random weighted graph (block 16), in both
    packages."""
    r = np.random.default_rng(seed)
    src = np.array([e[0] for e in edges], np.int64) if edges else np.array([0])
    dst = np.array([e[1] for e in edges], np.int64) if edges else np.array([1 % n])
    w = r.uniform(1, 4, len(src)).astype(np.float32)
    jg = jfrom_coo(src % n, dst % n, n, w, block_size=16)
    return jg, port_graph(jg)


def _rmat_graph(scale=7, ef=8, seed=3, weighted=False, block=64):
    src, dst, n = jgen.rmat(scale, ef, seed=seed)
    w = jgen.random_weights(len(src), seed=seed + 1) if weighted else None
    jg = jfrom_coo(src, dst, n, w, block_size=block)
    return jg, port_graph(jg), n


def T(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def counters(stats):
    return {k: getattr(stats, k) for k in COUNTERS}


# ---------------------------------------------------------------------------
# The batched plain versions against the reference's, and the kernel's design
# ---------------------------------------------------------------------------

# (kind, dtype, weighted)
REF_CASES = [("min", "f32", True), ("max", "f32", True), ("add", "f32", True),
             ("min", "i32", False), ("max", "i32", False), ("add", "i32", False),
             ("or", "bool", False)]


def lane_data(rng, b, n_pad, kind, dtype, inf=0.0):
    """numpy (src_val, active, out_init) lane matrices with negatives and
    signed zeros (f32), a share ``inf`` of +inf / -inf seeds beyond the
    neutral (min / max), and the sentinel column inactive."""
    active = rng.random((b, n_pad)) < 0.4
    active[:, -1] = False
    if dtype == "bool":
        return rng.random((b, n_pad)) < 0.5, active, rng.random((b, n_pad)) < 0.2
    if dtype == "i32":
        sv = rng.integers(-1000, 1000, (b, n_pad)).astype(np.int32)
        return sv, active, rng.integers(-1000, 1000, (b, n_pad)).astype(np.int32)
    sv = (rng.normal(size=(b, n_pad)) * 4).astype(np.float32)
    sv[rng.random((b, n_pad)) < 0.05] = -0.0
    init = (rng.normal(size=(b, n_pad)) * 4).astype(np.float32)
    init[rng.random((b, n_pad)) < 0.05] = 0.0
    if inf:
        init[rng.random((b, n_pad)) < inf] = np.inf if kind == "min" else -np.inf
    return sv, active, init


def _same(a, b, add_f32=False):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype
    if add_f32:
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-5)
    else:
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("case", ["push", "relax"])
@pytest.mark.parametrize("kind,dtype,weighted", REF_CASES)
def test_batched_refs_match_reference(case, kind, dtype, weighted):
    """``batched_push_ref`` / ``batched_relax_ref`` against the reference's
    and, row by row, against the port's single-lane push_ref / relax_ref."""
    jg, tg, _ = _rmat_graph(weighted=True)
    rng = np.random.default_rng(7)
    sv, active, init = lane_data(rng, 5, jg.n_pad, kind, dtype,
                                 inf=0.2 if kind in ("min", "max") else 0.0)
    add_f32 = kind == "add" and dtype == "f32"
    args = (jg.src_idx, jg.col_idx, jg.edge_w)
    targs = (tg.src_idx, tg.col_idx, tg.edge_w)
    if case == "push":
        want = jref.batched_push_ref(*args, jnp.asarray(sv), jnp.asarray(active),
                                     jnp.asarray(init), kind, weighted)
        got = tref.batched_push_ref(*targs, T(sv), T(active), T(init), kind, weighted)
        rows = [tref.push_ref(*targs, T(sv[b]), T(active[b]), T(init[b]), kind, weighted)
                for b in range(len(sv))]
    else:
        valid = rng.random(jg.m_pad) < 0.7
        want = jref.batched_relax_ref(*args, jnp.asarray(valid), jnp.asarray(sv),
                                      jnp.asarray(active), jnp.asarray(init), kind,
                                      weighted)
        got = tref.batched_relax_ref(*targs, T(valid), T(sv), T(active), T(init),
                                     kind, weighted)
        rows = [tref.relax_ref(*targs, T(valid & active[b][np.asarray(jg.src_idx)]),
                               T(sv[b]), T(init[b]), kind, weighted)
                for b in range(len(sv))]
    _same(want, got, add_f32)
    _same(torch.stack(rows), got, add_f32)


def lane_words(active):
    """The (n_pad,) int32 lane words of a (B <= 32, n_pad) bool frontier:
    bit b of word v is ``active[b, v]`` (the MS-BFS bit field that the
    ``edge_relax_lanes`` kernel builds on the card while it seeds ``out``)."""
    b = active.shape[0]
    if b > 32:
        raise ValueError(f"a lane word holds 32 lanes, not {b}")
    bit = torch.ones(b, dtype=torch.int32, device=active.device) << torch.arange(
        b, dtype=torch.int32, device=active.device)
    # distinct powers of two: every partial sum is exact in int32
    return (active.to(torch.int32) * bit[:, None]).sum(0, dtype=torch.int32)


def _key(x):
    """The ordered key of an f32 (the kernel's atomics' order, -0.0 < +0.0)."""
    b = int(np.float32(x).view(np.int32))
    return b if b >= 0 else b ^ 0x7FFFFFFF


def _atomics(vals, flat, msgs, kind, changed, n_pad, rng):
    """The kernel's atomics on a flat numpy copy of out, one message at a
    time in a shuffled order: a min/max/or message that moves its entry
    sets the changed bit when the value before compares unequal to it (the
    value the atomic returns), never in the sentinel column; add sums."""
    if kind == "add":
        np.add.at(vals, flat, msgs)
        return
    f32 = vals.dtype == np.float32
    for k in rng.permutation(len(flat)):
        i, msg = int(flat[k]), msgs[k]
        cur = vals[i]
        a, c = (_key(msg), _key(cur)) if f32 else (int(msg), int(cur))
        if a < c if kind == "min" else a > c:
            vals[i] = msg
            if changed is not None and msg != cur and i % n_pad != n_pad - 1:
                changed[i] = True


def lanes_kernel_model(src, dst, w, active, src_val, out_init, valid=None,
                       kind="min", use_weight=True, *, out=None, at=None,
                       changed=None, beyond=None, seed=0):
    """``edge_relax_lanes`` step for step, per group of 32 lanes:

    1. prep: out of place (``out`` None) a copy of ``out_init``; in place
       ``out`` reseeded from ``src_val`` — at the ``at`` columns and the
       sentinel column, or everywhere without ``at``.  The lane words
       (``lane_words``) packed at ``at`` only, every other word all ones
       (a slot that read one would send in every lane), or everywhere.
       The clamp word: from a full seed, each lane with a seed beyond the
       neutral; else the caller's ``beyond`` lanes.
    2. the relax: word = words[src] (0 for an invalid slot); its set bits
       send their messages, and each clamped lane in which the slot is
       masked sends the neutral (the plain version's masked slots clamp a
       seed beyond it; an active slot sends its own message, even +inf);
    3. ``_atomics`` in a shuffled order (``seed``), the changed bits from
       what each atomic returns.

    Slots and lanes that send nothing are skipped, which is what the
    kernel saves against the plain version.  Returns the new labels; the
    changed bits go into ``changed`` (an all-False (B, n_pad) bool)."""
    rng = np.random.default_rng(seed)
    wide = kind == "or" and src_val.dtype == torch.bool
    if out is None:
        res = out_init.clone()
        seed_full = True
    else:
        res = out.clone()
        seed_full = at is None
        cols = (torch.arange(res.shape[1]) if at is None
                else torch.cat([at.long(), torch.tensor([res.shape[1] - 1])]))
        res[:, cols] = src_val[:, cols]
    if wide:
        res, src_val = res.to(torch.uint8), src_val.to(torch.uint8)
    b_all, n_pad = res.shape
    f32_clamp = res.dtype == torch.float32 and kind in ("min", "max")
    neutral = tref.neutral_for(kind, res.dtype)
    flat_out = res.numpy().reshape(-1).copy()
    flat_changed = None if changed is None else np.zeros(b_all * n_pad, bool)
    for lo in range(0, b_all, 32):
        hi = min(lo + 32, b_all)
        bits = torch.arange(hi - lo, dtype=torch.int64)[:, None]
        words = lane_words(active[lo:hi]).long() & 0xFFFFFFFF
        if at is not None:
            packed = torch.full_like(words, 0xFFFFFFFF)
            packed[at.long()] = words[at.long()]
            packed[-1] = words[-1]
            words = packed
        clamp = torch.zeros(hi - lo, dtype=torch.bool)
        if f32_clamp:
            if seed_full:
                clamp = tref.lanes_beyond(torch.from_numpy(
                    flat_out[lo * n_pad:hi * n_pad].reshape(hi - lo, n_pad)), kind)
            elif beyond is not None:
                clamp = beyond[lo:hi]
        word = words[src.long()]
        if valid is not None:
            word = torch.where(valid, word, 0)
        sets = (word[None, :] >> bits) & 1 == 1                  # (k, m)
        # 2. the relax: the set lanes' messages, the clamped lanes' neutral
        # from the slots masked in them
        msg = tref.edge_message(src_val[lo:hi][:, src.long()], w, kind, use_weight)
        msg = torch.where(sets, msg.to(res.dtype), neutral)
        sets = sets | clamp[:, None]
        d = dst.long()
        flat = ((torch.arange(lo, hi)[:, None] * n_pad + d[None, :])[sets]).numpy()
        _atomics(flat_out, flat, msg[sets].numpy(), kind, flat_changed, n_pad, rng)
    res = torch.from_numpy(flat_out.reshape(b_all, n_pad))
    if changed is not None:
        changed |= torch.from_numpy(flat_changed.reshape(b_all, n_pad))
    return res.to(torch.bool) if wide else res


@pytest.mark.parametrize("case", ["push", "relax"])
@pytest.mark.parametrize("b", [3, 40])
@pytest.mark.parametrize("kind,dtype,weighted", REF_CASES)
def test_lanes_kernel_model_matches_plain(case, b, kind, dtype, weighted):
    """The kernel's decomposition (skipped lanes and slots, the per-lane
    clamp, groups of 32) gives the plain version's rows: bitwise, f32 add
    allclose.  B = 40 takes two groups; f32 min/max seeds include values
    beyond the neutral in some lanes only."""
    jg, tg, _ = _rmat_graph(weighted=True)
    rng = np.random.default_rng(b)
    sv, active, init = lane_data(rng, b, jg.n_pad, kind, dtype)
    if dtype == "f32" and kind in ("min", "max"):
        far = np.inf if kind == "min" else -np.inf
        init[1, rng.random(jg.n_pad) < 0.3] = far      # lane 1 clamps, others not
    valid = T(rng.random(jg.m_pad) < 0.6) if case == "relax" else None
    sv, active, init = T(sv), T(active), T(init)
    targs = (tg.src_idx, tg.col_idx, tg.edge_w)
    got = lanes_kernel_model(*targs, active, sv, init, valid, kind, weighted)
    if valid is None:
        want = tref.batched_push_ref(*targs, sv, active, init, kind, weighted)
    else:
        want = tref.batched_relax_ref(*targs, valid, sv, active, init, kind, weighted)
    _same(want, got, kind == "add" and dtype == "f32")


def test_lane_words_pack_one_bit_per_lane():
    """Bit b of word v is active[b, v], up to 32 lanes (bit 31 the sign
    bit); more lanes than a word holds are refused."""
    rng = np.random.default_rng(0)
    for b in (1, 7, 32):
        act = rng.random((b, 300)) < 0.5
        words = lane_words(T(act))
        assert words.dtype == torch.int32 and words.shape == (300,)
        unpacked = (words.numpy().view(np.uint32)[None, :]
                    >> np.arange(b, dtype=np.uint32)[:, None]) & 1
        np.testing.assert_array_equal(unpacked.astype(bool), act)
    assert int(lane_words(T(np.ones((32, 1), bool)))[0]) == -1
    with pytest.raises(ValueError):
        lane_words(T(np.ones((33, 4), bool)))


@pytest.mark.parametrize("det", [False, True])
@pytest.mark.parametrize("substrate", ["torch", "cuda"])
@pytest.mark.parametrize("kind", ["min", "add"])
def test_batched_operators_match_reference(kind, substrate, det):
    """``batched_push_dense`` and ``batched_relax_batch`` against the
    reference's operators on one graph and lane data: min bitwise, add
    allclose, and bitwise under deterministic add (the fixed-order tree,
    lane by lane)."""
    jg, tg, _ = _rmat_graph(weighted=True)
    rng = np.random.default_rng(11)
    sv, active, init = lane_data(rng, 4, jg.n_pad, kind, "f32")
    union = active.any(0)
    cap = jg.n_pad
    with jops.substrate_scope(SUB[substrate]), jops.deterministic_add_scope(det):
        jf = jfr.compact(jnp.asarray(union), cap, jg.sentinel)
        jbatch = jops.advance_sparse(jg, jf, jg.m_pad)
        want_push = jops.batched_push_dense(jg, jnp.asarray(sv), jnp.asarray(active),
                                            jnp.asarray(init), kind)
        want_relax = jops.batched_relax_batch(jbatch, jnp.asarray(sv),
                                              jnp.asarray(active), jnp.asarray(init), kind)
    with tops.substrate_scope(substrate), tops.deterministic_add_scope(det):
        tf = tfr.compact(T(union), cap, tg.sentinel)
        tbatch = tops.advance_sparse(tg, tf, tg.m_pad)
        got_push = tops.batched_push_dense(tg, T(sv), T(active), T(init), kind)
        got_relax = tops.batched_relax_batch(tbatch, T(sv), T(active), T(init), kind)
    loose = kind == "add" and not det
    _same(want_push, got_push, loose)
    _same(want_relax, got_relax, loose)


# ---------------------------------------------------------------------------
# Frontier helpers
# ---------------------------------------------------------------------------


def test_batched_frontier_helpers():
    """``batched_from_sources`` one-hot rows (the sentinel column cleared
    even for a sentinel source) and ``batched_round_scalars``, against the
    reference's functions and numpy."""
    jg, tg, _ = _rmat_graph()
    src = np.array([0, 5, jg.n_pad - 1])
    fmat = tfr.batched_from_sources(T(src), tg.n_pad)
    want = np.asarray(jfr.batched_from_sources(jnp.asarray(src), jg.n_pad))
    np.testing.assert_array_equal(fmat.numpy(), want)
    assert fmat.dtype == torch.bool and int(fmat.sum()) == 2
    rng = np.random.default_rng(3)
    fm = rng.random((4, tg.n_pad)) < 0.2
    fm[:, tg.sentinel] = False
    fm[2] = False  # one dead lane
    got = tfr.batched_round_scalars(tg, T(fm))
    want = jfr.batched_round_scalars(jg, jnp.asarray(fm))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    total, ucount, umass, alive = got
    union = fm.any(axis=0)
    assert total.dtype == ucount.dtype == umass.dtype == torch.int32
    assert int(total) == int(fm.sum()) and int(ucount) == int(union.sum())
    assert int(umass) == int(np.where(union, tg.out_deg.numpy(), 0).sum())
    np.testing.assert_array_equal(alive.numpy(), fm.any(axis=1))


# ---------------------------------------------------------------------------
# Batched ≡ per-source, bitwise, and RunStats equal to the JAX engine's
# ---------------------------------------------------------------------------


def _check_batched_equals_per_source(tg, n, src_seed, b, substrate, jg=None):
    sources = np.random.default_rng(src_seed).integers(0, n, b)
    with tops.substrate_scope(substrate):
        dmat, stats = tms.ms_bfs(tg, sources)
        smat, sstats = tms.ms_sssp(tg, sources)
        for i, s in enumerate(sources):
            db, _ = tbfs.bfs_dd_sparse(tg, int(s))
            ds, _ = tsssp.sssp_dd_sparse(tg, int(s))
            assert dmat[i].dtype == db.dtype
            assert torch.equal(dmat[i], db), (i, int(s))
            assert torch.equal(smat[i], ds), (i, int(s))
    assert stats.sources == b
    assert stats.sparse_rounds + stats.dense_rounds == stats.rounds
    assert stats.substrate == "torch"   # CPU tensors: the plain versions ran
    if jg is not None:
        with jops.substrate_scope(SUB[substrate]):
            jd, jst = jms.ms_bfs(jg, sources)
            js, jsst = jms.ms_sssp(jg, sources)
        np.testing.assert_array_equal(dmat.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(smat.numpy(), np.asarray(js))
        assert counters(stats) == counters(jst)
        assert counters(sstats) == counters(jsst)


@pytest.mark.parametrize("substrate", ["torch", "cuda"])
@pytest.mark.parametrize("seed,b", [(0, 1), (1, 4), (2, 8)])
def test_batched_distances_bitwise_seeded(substrate, seed, b):
    """The reference test's seeded cells: random directed weighted graphs,
    batch widths 1/4/8; lanes bitwise to the port's per-source runs and to
    the reference's ``ms_*`` lanes, counters equal to its engine's."""
    rng = np.random.default_rng(seed)
    n, m = int(rng.integers(20, 90)), int(rng.integers(60, 400))
    edges = [(int(a), int(c)) for a, c in
             zip(rng.integers(0, n, m), rng.integers(0, n, m))]
    jg, tg = _graph(n, edges, seed + 100)
    _check_batched_equals_per_source(tg, n, seed + 7, b, substrate, jg)


if HAVE_HYP:
    graph_strategy = st.builds(
        lambda n, edges, seed: (_graph(n, edges, seed)[1], n),
        n=st.integers(4, 60),
        edges=st.lists(st.tuples(st.integers(0, 59), st.integers(0, 59)),
                       min_size=1, max_size=200),
        seed=st.integers(0, 2**31 - 1),
    )

    @settings(max_examples=10, deadline=None)
    @given(gn=graph_strategy, src_seed=st.integers(0, 2**31 - 1),
           b=st.integers(1, 5), substrate=st.sampled_from(["torch", "cuda"]))
    def test_batched_distances_bitwise_equal_per_source(gn, src_seed, b, substrate):
        """Property: ANY graph × source multiset (duplicates allowed) ×
        batch width × substrate."""
        tg, n = gn
        _check_batched_equals_per_source(tg, n, src_seed, b, substrate)


@pytest.mark.parametrize("substrate", ["torch", "cuda"])
def test_two_buffer_rounds_reseed_only_the_union(substrate, monkeypatch):
    """``ms_sssp``'s rounds through ``DistSteps``, one at a time: after each
    round the spare label buffer equals the returned labels but exactly at
    the returned frontier (the changed lanes) and the sentinel column, the
    spare frontier is all False; every sparse round relaxes in place from
    the other buffer (``src_val`` never ``out``) reseeded at its compacted
    union, never in full.  Lanes and counters equal the reference's
    ``ms_sssp`` and the per-source runs."""
    jg, tg, n = _rmat_graph(scale=8, ef=6, seed=5, weighted=True)
    sources = np.random.default_rng(2).integers(0, n, 6)
    calls = []
    real = tops.batched_relax_batch_

    def spy(batch, src_val, active, out, *a, **k):
        assert out is not src_val and k["reseed"] and k["at"] is not None
        union = torch.nonzero(active.any(0)).flatten().to(torch.int32)
        assert set(union.tolist()) <= set(k["at"].tolist())
        calls.append(int(k["at"].shape[0]))
        return real(batch, src_val, active, out, *a, **k)
    monkeypatch.setattr(tops, "batched_relax_batch_", spy)
    src = torch.as_tensor(sources)
    dist = torch.full((len(sources), tg.n_pad), tms.SSSP_INF)
    dist.scatter_(1, src.view(-1, 1), 0.0)
    fmat = tfr.batched_from_sources(src, tg.n_pad)
    steps = tms.DistSteps(tms.SSSP_INF)
    eng = tms.MultiSourceEngine(tg, steps.sparse, steps.dense, steps.reset)
    with tops.substrate_scope(substrate):
        while True:
            total, ucount, umass, _ = eng.fetch(fmat)
            if total == 0:
                break
            dist, fmat = eng.round_once(dist, fmat, ucount, umass)
            spare, spare_f = steps._spare
            assert spare is not dist and not bool(spare_f.any())
            differ = spare != dist
            differ[:, -1] = False
            assert torch.equal(differ, fmat)
    assert eng.stats.sparse_rounds == len(calls) > 0 and eng.stats.dense_rounds > 0
    jd, jst = jms.ms_sssp(jg, sources)
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jd))
    eng.stats.sources = len(sources)
    assert counters(eng.stats) == counters(jst)
    for i, s in enumerate(sources):
        assert torch.equal(dist[i], tsssp.sssp_dd_sparse(tg, int(s))[0])


@pytest.mark.parametrize("substrate", ["torch", "cuda"])
def test_unreached_past_flt_max_clamps_as_the_reference(substrate):
    """``ms_distances`` from ``inf = +inf``, past FLT_MAX: the plain
    version's masked slots clamp an unreached +inf to FLT_MAX at every dst
    they name, and the two-buffer steps hand the kernel the lanes that may
    hold such a seed (``beyond``): lanes bitwise and counters equal to the
    reference's run from the same ``inf``."""
    jg, tg, n = _rmat_graph(scale=7, ef=8, seed=3, weighted=True)
    sources = [1, 17, 42]
    with tops.substrate_scope(substrate):
        dist, st = tms.ms_distances(tg, sources, float("inf"))
    jd, jst = jms.ms_distances(jg, sources, jnp.float32(np.inf))
    np.testing.assert_array_equal(dist.numpy().view(np.int32),
                                  np.asarray(jd).view(np.int32))
    assert counters(st) == counters(jst)
    assert bool((dist == tms.FLT_MAX).any())    # the clamp happened
    assert tms.DistSteps(float("inf")).clamp and not tms.DistSteps(tms.BFS_INF).clamp


def test_batched_ppr_matches_per_source():
    """PPR lanes: bitwise to the port's ``ppr_push`` under deterministic add
    (counters equal to the reference's ``ms_ppr``, ranks within 1e-6 of
    them: the final normalisation sums in another order), allclose
    under the default scatter-add; duplicate sources give equal lanes."""
    jg, tg, _ = _rmat_graph()
    sources = [1, 17, 42, 1, 100]  # duplicate lane on purpose
    with tops.deterministic_add_scope(True):
        ranks, stats = tms.ms_ppr(tg, sources)
        for i, s in enumerate(sources):
            ref, _ = tpr.ppr_push(tg, s)
            assert torch.equal(ranks[i], ref), i
    with jops.deterministic_add_scope(True):
        jranks, jstats = jms.ms_ppr(jg, sources)
    np.testing.assert_allclose(ranks.numpy(), np.asarray(jranks), rtol=1e-6, atol=1e-9)
    assert counters(stats) == counters(jstats)
    assert stats.sources == len(sources)
    ranks, _ = tms.ms_ppr(tg, sources)
    for i, s in enumerate(sources):
        ref, _ = tpr.ppr_push(tg, s)
        np.testing.assert_allclose(ranks[i].numpy(), ref.numpy(), rtol=1e-5, atol=1e-7)
    assert torch.equal(ranks[0], ranks[3])


# ---------------------------------------------------------------------------
# Amortization ledger, and what the batched path refuses
# ---------------------------------------------------------------------------


def test_batched_amortization_halves_per_source_edge_cost():
    """At B = 8 on rmat(10, 12) the batched run charges each union sweep
    once, so edges_touched / sources is at most HALF the per-source cost
    (the serving suite's ratio, on the accounting itself); the counters
    equal the reference engine's."""
    jg, tg, n = _rmat_graph(scale=10, ef=12, seed=7, weighted=True, block=128)
    sources = np.random.default_rng(0).integers(0, n, 8)
    dmat, stb = tms.ms_bfs(tg, sources)
    seq_edges = sum(tbfs.bfs_dd_sparse(tg, int(s))[1].edges_touched for s in sources)
    assert stb.sources == 8
    assert 2 * stb.edges_touched / stb.sources <= seq_edges / len(sources), \
        (stb.edges_touched, seq_edges)
    _, jst = jms.ms_bfs(jg, sources)
    assert counters(stb) == counters(jst)


def test_tiered_and_sharded_graphs_refuse_batches():
    """A tiered graph is refused, as in the reference (serving batches run
    on resident graphs); a sharded graph takes them (the dense sweep on
    its mesh: each lane the Graph's); a container that is none of these is
    refused."""
    from repro_torch.core.mesh import Mesh
    from repro_torch.core.sharded import shard_graph

    jg, tg, _ = _rmat_graph()
    fmat = tfr.batched_from_sources(T(np.array([1, 2])), tg.n_pad)
    lab = torch.zeros((2, tg.n_pad))
    with pytest.raises(NotImplementedError):
        jms.ms_bfs(jtier_graph(jg, nshards=4, resident_shards=2), [1, 2])
    tt = tier_graph(tg, nshards=4, resident_shards=2)
    with pytest.raises(NotImplementedError):
        tms.ms_bfs(tt, [1, 2])
    with pytest.raises(NotImplementedError, match="resident"):
        tops.batched_push_dense(tt, lab, fmat, lab)
    sg = shard_graph(tg, Mesh({"data": 2}, device="cpu"))
    assert torch.equal(tops.batched_push_dense(sg, lab, fmat, lab + 9),
                       tops.batched_push_dense(tg, lab, fmat, lab + 9))
    fake = types.SimpleNamespace(is_tiered=False)
    with pytest.raises(TypeError, match="ShardedGraph"):
        tops.batched_push_dense(fake, lab, fmat, lab)


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("case,clamp,want", [
    # src 6 slots (24) + the frontier at 4 sources x 2 lanes (8) + dst and w
    # at the 4 slots some lane sends from (16 + 16) + src_val at 3 (lane,
    # source) pairs (12) + out_init and out (128); 6 messages
    ("push", False, (204, 6, 4, 3)),
    # a clamped lane sends from all 6 slots: dst 24, 6 more messages
    ("push", True, (212, 12, 6, 3)),
    # 4 valid slots' src (16) + the 1-B valid mask (6) + the frontier at
    # their 4 sources (8) + dst and w at 2 sending slots (8 + 8) + src_val
    # at 3 pairs (12) + 128; 3 messages
    ("batch", False, (186, 3, 2, 3)),
    # in place, dst [1, 2, 2, 5, 6, 6]: no copy; out read and written at
    # the 5 (lane, dst) pairs a message reaches (40) in place of the 128,
    # and 3 changed bytes: 24 + 8 + 16 + 16 + 12 + 40 + 3
    ("push in place", False, (119, 6, 4, 3)),
    # in place, reseeded in full: src_val read (64) and out written (64)
    # once in full, as the copy out of place, and the 3 changed bytes:
    # 24 + 8 + 16 + 16 + 64 + 64 + 3
    ("push in place, reseeded", False, (195, 6, 4, 3)),
    # in place, reseeded at the union [0, 3] and the sentinel column 7:
    # src_val at 2 lanes x 3 columns (24); out written there and at the 3
    # message pairs, read at those 3 (36 + 12): 46 + 24 + 48
    ("batch in place", False, (118, 3, 2, 3)),
])
def test_chip_smoke_lane_bound_charges_only_what_is_read(case, clamp, want):
    """chip_smoke.py's bound for ``edge_relax_lanes`` charges src_val at
    the (lane, source) pairs that send and, under a slot mask, the
    frontier only at the valid slots' sources; in place, out only where
    messages and the reseed reach it (a reseed in full: src_val and out
    once in full), and the changed bytes it sets: counted by hand."""
    smoke = _chip_smoke()
    src = T(np.array([0, 0, 1, 2, 3, 3], np.int32))
    dst = T(np.array([1, 2, 2, 5, 6, 6], np.int32))
    active = np.zeros((2, 8), bool)
    active[0, 0] = active[1, [0, 3]] = True
    active = T(active)
    init = torch.zeros((2, 8))
    if clamp:
        init[1, 7] = float("inf")
    valid = T(np.array([1, 0, 1, 1, 1, 0], bool)) if case.startswith("batch") else None
    keep = active[:, src.long()] if valid is None else valid & active[:, src.long()]
    kw = {}
    if case.startswith("push in place"):
        changed = torch.zeros((2, 8), dtype=torch.bool)
        changed[0, 1] = changed[1, [1, 6]] = True
        kw = dict(dst=dst.long(), changed=changed, reseed=case.endswith("reseeded"))
    elif case == "batch in place":
        kw = dict(dst=dst.long(), at=T(np.array([0, 3], np.int32)))
    work = smoke.lanes_work(torch, src.long(), valid, keep, init, "min", True, **kw)
    assert (work["bytes"], work["messages"], work["slots_sending"],
            work["gathered"]) == want
    assert work["clamped_lanes"] == int(clamp)
    assert smoke.distinct_sources(torch, src.long(), 8) == 4


PPR_STATS = dict(rounds=10, sparse_rounds=9, dense_rounds=1, edges_touched=500,
                 compiles=4, overflow_escalations=0, sources=8, substrate="cuda")


@pytest.mark.parametrize("change,ok", [
    ({}, True),
    ({"rounds": 11, "sparse_rounds": 10, "edges_touched": 600}, True),
    ({"sparse_rounds": 8, "dense_rounds": 2, "edges_touched": 600}, True),
    ({"rounds": 12, "sparse_rounds": 11}, False),
    ({"rounds": 11, "sparse_rounds": 10, "edges_touched": 601}, False),
    ({"rounds": 11, "sparse_rounds": 10, "compiles": 5}, False),
    ({"overflow_escalations": 1}, False),
    ({"sources": 7}, False),
])
def test_chip_smoke_ppr_stats_keep_every_counter_but_one_round(change, ok):
    """chip_smoke.py 9h's ppr check across substrates: rounds within one
    and edges_touched within one sweep (100 here); compiles, escalations
    and sources equal.  Without a sweep every counter must be equal."""
    smoke = _chip_smoke()
    other = dict(PPR_STATS, substrate="torch", **change)
    if ok:
        smoke.stats_equal("ppr", PPR_STATS, other, sweep=100)
    else:
        with pytest.raises(smoke.SmokeFailure):
            smoke.stats_equal("ppr", PPR_STATS, other, sweep=100)
    if change:
        with pytest.raises(smoke.SmokeFailure):
            smoke.stats_equal("ppr", PPR_STATS, other)
