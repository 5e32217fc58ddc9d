"""The port's relaxation operators and their plain versions against the JAX
package's, for every reduction kind.

The same graphs and vertex data (numpy, from a seed) go through
``repro.core.operators`` under both of its substrates — ``"jnp"`` and
``"pallas"`` (interpret mode on the CPU) — and through the port, whose
kernel wrappers take the plain version for CPU tensors.

Tolerances: bitwise for min/max/or, int32 and deterministic add; plain
float add allclose with rtol 1e-6 (the summation order of a scatter-add
is the backend's; the test data there is not integer-valued).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import frontier as jfr  # noqa: E402
from repro.core import operators as jops  # noqa: E402
from repro.core.graph import from_coo as jfrom_coo  # noqa: E402
from repro.kernels import graph_ops as jgk  # noqa: E402
from repro.kernels.graph_ops import ref as jref  # noqa: E402
from repro_torch.core import frontier as tfr  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.kernels import graph_ops as tgk  # noqa: E402
from test_torch_graph import GRAPHS, port_graph  # noqa: E402

KINDS = ["min", "max", "add", "or"]
JAX_SUBSTRATES = ["jnp", "pallas"]


def build(name, block=64):
    src, dst, n = GRAPHS[name]()
    w = np.random.default_rng(5).integers(1, 5, len(src)).astype(np.float32)
    jg = jfrom_coo(src, dst, n, w, block_size=block, build_csc=True)
    return jg, port_graph(jg)


def vertex_data(n_pad, sentinel, kind, seed=0, integer=True):
    """numpy (src_val, active, out_init); integer-valued floats unless asked
    otherwise, bool for 'or'."""
    rng = np.random.default_rng(seed)
    active = rng.random(n_pad) < 0.5
    active[sentinel] = False
    if kind == "or":
        return rng.random(n_pad) < 0.5, active, np.zeros(n_pad, bool)
    sv = rng.normal(size=n_pad) * 3
    sv = (np.rint(sv) if integer else sv).astype(np.float32)
    fill = {"min": np.finfo(np.float32).max, "max": np.finfo(np.float32).min,
            "add": 0.0}[kind]
    return sv, active, np.full(n_pad, fill, np.float32)


def T(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def J(*xs):
    return [jnp.asarray(x) for x in xs]


def assert_same(a, b, what="", add=False):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    if add:
        # atol covers sums that cancel to near zero (|terms| <= ~40)
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-5, err_msg=what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_push_matches_jax(gname, kind, reverse):
    jg, tg = build(gname)
    data = vertex_data(jg.n_pad, jg.sentinel, kind, integer=False)
    use_w = kind != "or"
    got = {sub: tops.push_dense(tg, *T(*data), kind=kind, use_weight=use_w,
                                substrate=sub, reverse=reverse)
           for sub in tops.SUBSTRATES}
    assert torch.equal(got["torch"], got["cuda"])
    for sub in JAX_SUBSTRATES:
        want = jops.push_dense(jg, *J(*data), kind=kind, use_weight=use_w,
                               substrate=sub, reverse=reverse)
        assert_same(want, got["cuda"], f"push/{gname}/{kind}/{sub}",
                    add=kind == "add")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_pull_matches_jax(gname, kind):
    jg, tg = build(gname)
    data = vertex_data(jg.n_pad, jg.sentinel, kind, seed=1, integer=False)
    use_w = kind != "or"
    got = {sub: tops.pull_dense(tg, *T(*data), kind=kind, use_weight=use_w,
                                substrate=sub)
           for sub in tops.SUBSTRATES}
    for sub in JAX_SUBSTRATES:
        want = jops.pull_dense(jg, *J(*data), kind=kind, use_weight=use_w,
                               substrate=sub)
        for tsub, out in got.items():
            assert_same(want, out, f"pull/{gname}/{kind}/{sub}/{tsub}",
                        add=kind == "add")


@pytest.mark.parametrize("kind", ["min", "max"])
def test_int32_push_and_pull_bitwise(kind):
    jg, tg = build("web_like")
    rng = np.random.default_rng(7)
    sv = rng.integers(-1000, 1000, jg.n_pad).astype(np.int32)
    active = rng.random(jg.n_pad) < 0.6
    active[jg.sentinel] = False
    init = np.full(jg.n_pad, np.iinfo(np.int32).max if kind == "min"
                   else np.iinfo(np.int32).min, np.int32)
    for sub in JAX_SUBSTRATES:
        want = jops.push_dense(jg, *J(sv, active, init), kind=kind,
                               use_weight=False, substrate=sub)
        assert_same(want, tops.push_dense(tg, *T(sv, active, init), kind=kind,
                                          use_weight=False), f"push/{sub}")
        want = jops.pull_dense(jg, *J(sv, active, sv), kind=kind,
                               use_weight=False, substrate=sub)
        assert_same(want, tops.pull_dense(tg, *T(sv, active, sv), kind=kind,
                                          use_weight=False), f"pull/{sub}")


@pytest.mark.parametrize("frontier", ["some", "empty", "overflow"])
@pytest.mark.parametrize("gname", list(GRAPHS))
def test_advance_and_relax_match_jax(gname, frontier):
    jg, tg = build(gname)
    rng = np.random.default_rng(3)
    if frontier == "empty":
        mask = np.zeros(jg.n_pad, bool)
    elif frontier == "overflow":
        mask = np.arange(jg.n_pad) < jg.n   # count >> capacity below
    else:
        mask = rng.random(jg.n_pad) < 0.3
    cap = jg.block_size
    jf = jfr.compact(jnp.asarray(mask), cap, jg.sentinel)
    tf = tfr.compact(torch.from_numpy(mask), cap, tg.sentinel)
    assert_same(jf.idx, tf.idx, "compact idx")
    assert int(jf.count) == int(tf.count)
    assert bool(tf.overflowed()) == (frontier == "overflow")
    data = vertex_data(jg.n_pad, jg.sentinel, "min", seed=2, integer=False)
    for budget in (jg.block_size, 4 * jg.block_size):
        tb = tops.advance_sparse(tg, tf, budget)
        assert tb.total.dtype == torch.int32 and tb.total.shape == ()
        for sub in JAX_SUBSTRATES:
            jb = jops.advance_sparse(jg, jf, budget, substrate=sub)
            for fld in ("src", "dst", "w", "valid", "total"):
                assert_same(getattr(jb, fld), getattr(tb, fld),
                            f"advance/{frontier}/{budget}/{sub}/{fld}")
            want = jops.relax_batch(jb, jnp.asarray(data[0]),
                                    jnp.asarray(data[2]), kind="min",
                                    substrate=sub)
            got = tops.relax_batch(tb, *T(data[0], data[2]), kind="min")
            assert_same(want, got, f"relax/{frontier}/{budget}/{sub}")
        # the budget caps the emitted slots; total is the true mass
        assert int(tb.valid.sum()) == min(int(tb.total), budget)
        if frontier == "empty":
            assert int(tb.total) == 0


@pytest.mark.parametrize("kind", KINDS)
def test_relax_batch_and_relax_edges_all_kinds(kind):
    jg, tg = build("erdos")
    rng = np.random.default_rng(11)
    mask = rng.random(jg.n_pad) < 0.25
    jf = jfr.compact(jnp.asarray(mask), 4 * jg.block_size, jg.sentinel)
    tf = tfr.compact(torch.from_numpy(mask), 4 * jg.block_size, tg.sentinel)
    sv, _, init = vertex_data(jg.n_pad, jg.sentinel, kind, seed=4, integer=False)
    edge_mask = rng.random(jg.m_pad) < 0.5
    use_w = kind != "or"
    tb = tops.advance_sparse(tg, tf, 8 * jg.block_size)
    for sub in JAX_SUBSTRATES:
        jb = jops.advance_sparse(jg, jf, 8 * jg.block_size, substrate=sub)
        want = jops.relax_batch(jb, *J(sv, init), kind=kind, use_weight=use_w,
                                substrate=sub)
        got = tops.relax_batch(tb, *T(sv, init), kind=kind, use_weight=use_w)
        assert_same(want, got, f"relax_batch/{sub}", add=kind == "add")
        want = jops.relax_edges(jg, *J(sv, edge_mask, init), kind=kind,
                                use_weight=use_w, substrate=sub)
        got = tops.relax_edges(tg, *T(sv, edge_mask, init), kind=kind,
                               use_weight=use_w)
        assert_same(want, got, f"relax_edges/{sub}", add=kind == "add")


@pytest.mark.parametrize("op", ["push", "pull", "relax_edges", "relax_batch"])
def test_deterministic_add_bitwise(op):
    """Under deterministic add both packages run the same fixed-order tree:
    float sums are bitwise equal even on non-integer data."""
    jg, tg = build("web_like")
    sv, active, init = vertex_data(jg.n_pad, jg.sentinel, "add", seed=6,
                                   integer=False)
    edge_mask = np.random.default_rng(8).random(jg.m_pad) < 0.6
    cap = 4 * jg.block_size
    with jops.deterministic_add_scope(True), tops.deterministic_add_scope(True):
        for sub in JAX_SUBSTRATES:
            if op == "push":
                want = jops.push_dense(jg, *J(sv, active, init), kind="add",
                                       substrate=sub)
                got = tops.push_dense(tg, *T(sv, active, init), kind="add")
            elif op == "pull":
                want = jops.pull_dense(jg, *J(sv, active, init), kind="add",
                                       substrate=sub)
                got = tops.pull_dense(tg, *T(sv, active, init), kind="add")
            elif op == "relax_edges":
                want = jops.relax_edges(jg, *J(sv, edge_mask, init),
                                        kind="add", substrate=sub)
                got = tops.relax_edges(tg, *T(sv, edge_mask, init), kind="add")
            else:
                jf = jfr.compact(jnp.asarray(active), cap, jg.sentinel)
                tf = tfr.compact(torch.from_numpy(active), cap, tg.sentinel)
                want = jops.relax_batch(
                    jops.advance_sparse(jg, jf, 8 * jg.block_size, substrate=sub),
                    *J(sv, init), kind="add", substrate=sub)
                got = tops.relax_batch(tops.advance_sparse(tg, tf, 8 * jg.block_size),
                                       *T(sv, init), kind="add")
            assert_same(want, got, f"det/{op}/{sub}")


def test_det_scatter_add_bitwise():
    rng = np.random.default_rng(9)
    for m, n in ((1, 4), (37, 5), (1000, 64), (4096, 300)):
        dst = rng.integers(0, n, m).astype(np.int32)
        msg = (rng.normal(size=m) * 10.0 ** rng.integers(-3, 4, m)).astype(np.float32)
        out = rng.normal(size=n).astype(np.float32)
        want = jgk.det_scatter_add(*J(dst, msg, out))
        got = tgk.det_scatter_add(*T(dst, msg, out))
        assert_same(want, got, f"det_scatter_add/{m}")


def test_scatter_reduce_signed_zero_and_kinds():
    """Float min/max follow XLA's order for signed zeros (-0.0 < +0.0)
    whatever order duplicates arrive in."""
    dst = np.array([0, 0, 1, 1, 2, 2, 3, 3, 3], np.int32)
    msg = np.array([-0.0, 0.0, 0.0, -0.0, -1.5, 2.0, 0.0, 0.0, -0.0], np.float32)
    out = np.array([0.0, -0.0, 7.0, -7.0], np.float32)
    for kind in ("min", "max", "add"):
        want = jgk.scatter_reduce(*J(dst, msg, out), kind)
        got = tgk.scatter_reduce(*T(dst, msg, out), kind)
        assert_same(want, got, kind)
        np.testing.assert_array_equal(np.signbit(np.asarray(want)),
                                      np.signbit(got.numpy()), err_msg=kind)
    bmsg = np.array([1, 0, 0, 0, 1, 1, 0, 0, 0], bool)
    bout = np.zeros(4, bool)
    assert_same(jgk.scatter_reduce(*J(dst, bmsg, bout), "or"),
                tgk.scatter_reduce(*T(dst, bmsg, bout), "or"), "or")


def test_neutral_and_message():
    for kind in ("min", "max", "add", "or"):
        for dt_j, dt_t in ((jnp.float32, torch.float32), (jnp.int32, torch.int32),
                           (jnp.uint8, torch.uint8), (jnp.bool_, torch.bool)):
            if kind in ("min", "max") and dt_j == jnp.uint8:
                continue
            a = np.asarray(jgk.neutral_for(kind, dt_j))
            b = tgk.neutral_for(kind, dt_t).numpy()
            assert a.dtype == b.dtype and a == b, (kind, dt_j)
    v, w = np.float32([1.5, -2.0]), np.float32([2.0, 3.0])
    for kind in ("min", "max", "add"):
        for use_w in (False, True):
            assert_same(jref.edge_message(*J(v, w), kind, use_w),
                        tgk.edge_message(*T(v, w), kind, use_w))


def test_sorted_lower_bound_and_intersect():
    rng = np.random.default_rng(12)
    rows = np.sort(rng.integers(0, 50, (30, 9)), axis=1).astype(np.int32)
    vals = rng.integers(-2, 53, (30, 9)).astype(np.int32)
    assert_same(jgk.sorted_lower_bound(*J(rows, vals)),
                tgk.sorted_lower_bound(*T(rows, vals)))
    adj = np.sort(rng.integers(0, 40, (40, 6)), axis=1).astype(np.int32)
    adj[-1] = 39
    src = rng.integers(0, 40, 64).astype(np.int32)
    dst = rng.integers(0, 40, 64).astype(np.int32)
    assert int(jgk.intersect_ref(*J(adj, src, dst), 39)) == int(
        tgk.intersect_ref(*T(adj, src, dst), 39))


def test_cpu_wrappers_take_plain_version_and_launch_nothing():
    jg, tg = build("hub_leaves")
    tgk.reset_launches()
    sv, active, init = T(*vertex_data(jg.n_pad, jg.sentinel, "min"))
    out = tgk.edge_relax(tg.src_idx, tg.col_idx, tg.edge_w, active, sv, init)
    assert torch.equal(out, tgk.push_ref(tg.src_idx, tg.col_idx, tg.edge_w,
                                         sv, active, init))
    f = tfr.compact(active, tg.n_pad, tg.sentinel)
    got = tgk.advance_frontier(f.idx, f.count, tg.out_deg, tg.row_ptr,
                               tg.col_idx, tg.edge_w, budget=256,
                               sentinel=tg.sentinel, m_pad=tg.m_pad)
    want = tgk.advance_ref(f.idx, f.count, tg.out_deg, tg.row_ptr, tg.col_idx,
                           tg.edge_w, 256, tg.sentinel, tg.m_pad)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert tgk.launch_counts() == {"edge_relax": 0, "advance": 0}


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a CUDA
    device is refused, never relaxed by the plain version."""
    m = torch.empty(64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tgk.edge_relax(m, m, m.float(), m.bool(), m.float(), m.float())
    with pytest.raises(ValueError):
        tgk.advance_frontier(m, m[0], m, m, m, m.float(), budget=64,
                             sentinel=63, m_pad=64)
