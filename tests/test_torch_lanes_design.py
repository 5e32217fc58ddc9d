"""The multi-source relax in place on the CPU: the in-place entry point's plain
version against the JAX package's vmapped relax and its changed mask, and the
kernel's decomposition by route (``lanes_kernel_model``: the per-lane clamp,
the reseed in full or over the union, the changed bits from the atomics)
against the plain version.

On the CPU the wrappers take the plain version; the kernel itself is held to
it on the card by ``chip_smoke.py`` (9h a).  Tolerances: bitwise for
min/max/or, int32 and the changed masks; f32 add allclose (rtol 1e-6, atol
1e-5: the sums run in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import from_coo as jfrom_coo  # noqa: E402
from repro.core import frontier as jfr  # noqa: E402
from repro.core import operators as jops  # noqa: E402
from repro.graphs import generators as jgen  # noqa: E402
from repro_torch.core import frontier as tfr  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.kernels import graph_ops as tgk  # noqa: E402
from repro_torch.kernels.graph_ops import ref as tref  # noqa: E402
from test_torch_graph import port_graph  # noqa: E402
from test_torch_multisource import (REF_CASES, T, _same, lane_data,  # noqa: E402
                                    lanes_kernel_model)


def _rmat_graph():
    """rmat(7, 8) with random weights and its CSC mirror, in both packages."""
    src, dst, n = jgen.rmat(7, 8, seed=3)
    w = jgen.random_weights(len(src), seed=4)
    jg = jfrom_coo(src, dst, n, w, block_size=64, build_csc=True)
    return jg, port_graph(jg)


def _spare(sv, active):
    """Last round's label buffer: ``sv`` but at the frontier and in the
    sentinel column, where it holds other values (+0.0 where sv has -0.0)."""
    if sv.dtype == bool:
        other = ~sv
    elif sv.dtype == np.int32:
        other = sv + 7
    else:
        other = np.abs(sv) + 1
    stale = np.where(active, other, sv)
    stale[:, -1] = other[:, -1]
    return stale


def _union(tg, active):
    return tfr.compact(T(active.any(0)), tg.n_pad, tg.sentinel)


# ---------------------------------------------------------------------------
# The in-place route's plain version against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["push", "relax"])
@pytest.mark.parametrize("b", [3, 40])
@pytest.mark.parametrize("kind,dtype,weighted", REF_CASES)
def test_in_place_plain_matches_reference_relax_and_mask(case, b, kind, dtype, weighted):
    """``edge_relax_lanes_`` on the CPU (the plain version) relaxing into
    last round's buffer — reseeded in full for a push, at the union's
    columns for a batch — gives the JAX package's vmapped relax (its
    "pallas" substrate) of the seeds ``src_val``, and its changed mask is
    ``batched_updated_mask`` of the two (min, max, or; a sum has none)."""
    jg, tg = _rmat_graph()
    rng = np.random.default_rng(b + 3)
    sv, active, _ = lane_data(rng, b, jg.n_pad, kind, dtype,
                              inf=0.2 if kind in ("min", "max") else 0.0)
    moves = kind != "add"
    with jops.substrate_scope("pallas"):
        if case == "push":
            want = jops.batched_push_dense(jg, jnp.asarray(sv), jnp.asarray(active),
                                           jnp.asarray(sv), kind, weighted)
        else:
            jf = jfr.compact(jnp.asarray(active.any(0)), jg.n_pad, jg.sentinel)
            jbatch = jops.advance_sparse(jg, jf, jg.m_pad)
            want = jops.batched_relax_batch(jbatch, jnp.asarray(sv), jnp.asarray(active),
                                            jnp.asarray(sv), kind, weighted)
        want_mask = jops.batched_updated_mask(jnp.asarray(sv), want)
    out = T(_spare(sv, active))
    changed = torch.zeros(out.shape, dtype=torch.bool) if moves else None
    if case == "push":
        got = tgk.edge_relax_lanes_(tg.src_idx, tg.col_idx, tg.edge_w, T(active), T(sv), out,
                                    kind=kind, use_weight=weighted, reseed=True,
                                    changed=changed)
    else:
        f = _union(tg, active)
        batch = tops.advance_sparse(tg, f, tg.m_pad)
        got = tgk.edge_relax_lanes_(batch.src, batch.dst, batch.w, T(active), T(sv), out,
                                    valid=batch.valid, kind=kind, use_weight=weighted,
                                    at=f.idx, reseed=True, changed=changed)
    assert got.data_ptr() == out.data_ptr()     # in place
    _same(want, out, kind == "add" and dtype == "f32")
    if moves:
        np.testing.assert_array_equal(changed.numpy(), np.asarray(want_mask))


# ---------------------------------------------------------------------------
# The kernel's decomposition by route
# ---------------------------------------------------------------------------

# REF_CASES and f32 min unweighted, whose messages are the labels themselves:
# -0.0 reaching a +0.0 seed moves its key but not its value
MODEL_CASES = REF_CASES + [("min", "f32", False)]


def signed_zero_data(rng, b, n_pad, kind, dtype):
    """``lane_data`` with +0.0 seeds and -0.0 labels a tenth of the time
    each (f32), and +inf / -inf seeds in lane 1 (min / max)."""
    sv, active, init = lane_data(rng, b, n_pad, kind, dtype)
    if dtype == "f32":
        sv[rng.random(sv.shape) < 0.1] = -0.0
        init[rng.random(init.shape) < 0.1] = 0.0
        if kind in ("min", "max"):
            far = np.inf if kind == "min" else -np.inf
            init[1, rng.random(n_pad) < 0.3] = far
            sv[1, rng.random(n_pad) < 0.3] = far
    return sv, active, init


@pytest.mark.parametrize("route", ["push", "push in place", "batch in place"])
@pytest.mark.parametrize("b", [3, 40])
@pytest.mark.parametrize("kind,dtype,weighted", MODEL_CASES)
def test_lanes_kernel_model_routes_match_plain(route, b, kind, dtype, weighted):
    """The push (out of place, and in place reseeded in full) and the
    in-place batch reseeded at its union (the clamp lanes from the caller's
    ``beyond``), each with the clamped lanes' neutral from masked slots and
    the changed bits from the atomics in a shuffled order, give the plain
    version's labels — bitwise, f32 add allclose — and
    ``batched_updated_mask``'s changed lanes, with ±0.0 seeds and labels
    and +inf seeds in lane 1."""
    jg, tg = _rmat_graph()
    rng = np.random.default_rng(100 * b + len(route))
    sv, active, init = signed_zero_data(rng, b, jg.n_pad, kind, dtype)
    sv, active, init = T(sv), T(active), T(init)
    moves = kind != "add"
    changed = torch.zeros(init.shape, dtype=torch.bool) if moves else None
    csr = (tg.src_idx, tg.col_idx, tg.edge_w)
    if route == "push":
        seeds = init
        got = lanes_kernel_model(*csr, active, sv, init, None, kind, weighted,
                                 changed=changed)
        want = tref.batched_push_ref(*csr, sv, active, seeds, kind, weighted)
    elif route == "push in place":
        seeds = sv
        spare = T(_spare(sv.numpy(), active.numpy()))
        got = lanes_kernel_model(*csr, active, sv, None, None, kind, weighted, out=spare,
                                 changed=changed)
        want = tref.batched_push_ref(*csr, sv, active, seeds, kind, weighted)
    else:
        seeds = sv
        spare = T(_spare(sv.numpy(), active.numpy()))
        f = _union(tg, active.numpy())
        batch = tops.advance_sparse(tg, f, tg.m_pad)
        got = lanes_kernel_model(batch.src, batch.dst, batch.w, active, sv, None, batch.valid,
                                 kind, weighted, out=spare, at=f.idx,
                                 changed=changed, beyond=tref.lanes_beyond(sv, kind))
        want = tref.batched_relax_ref(batch.src, batch.dst, batch.w, batch.valid, sv, active,
                                      seeds, kind, weighted)
    _same(want, got, kind == "add" and dtype == "f32")
    if moves:
        assert torch.equal(changed, tops.batched_updated_mask(seeds, want))


@pytest.mark.parametrize("order", [0, 1, 2])
def test_changed_bit_is_the_float_compare_not_the_key_order(order):
    """One entry, +0.0, reached by -0.0 and then by -1.0, or by -0.0 alone:
    whatever the order of the atomics, the changed bit is ``new != old``
    as floats — set by the step to -1.0, never by +0.0 to -0.0."""
    rng = np.random.default_rng(order)
    for msgs, want in (([-0.0, -1.0], True), ([-0.0], False), ([-0.0, -0.0, 0.0], False)):
        vals = np.array([0.0, 0.0], np.float32)
        changed = np.zeros(2, bool)
        from test_torch_multisource import _atomics
        _atomics(vals, np.zeros(len(msgs), np.int64), np.array(msgs, np.float32), "min",
                 changed, 2, rng)
        assert changed[0] == want and changed[0] == (vals[0] != 0.0)
        assert np.signbit(vals[0])


# ---------------------------------------------------------------------------
# The wrapper's contract and the operators' routes
# ---------------------------------------------------------------------------


def test_in_place_wrapper_refuses_what_the_kernel_cannot_do():
    """src_val aliasing out (a chaotic relax), a changed mask for a sum, a
    vertex list for a push: refused on the CPU as on the card."""
    jg, tg = _rmat_graph()
    lanes = torch.zeros((2, tg.n_pad), dtype=torch.bool)
    vals = torch.zeros((2, tg.n_pad))
    args = (tg.src_idx, tg.col_idx, tg.edge_w, lanes)
    with pytest.raises(ValueError, match="alias"):
        tgk.edge_relax_lanes_(*args, vals, vals)
    with pytest.raises(ValueError, match="alias"):
        tgk.edge_relax_lanes_(*args, vals[:, 1:], vals[:, :-1])
    with pytest.raises(ValueError, match="sum"):
        tgk.edge_relax_lanes_(*args, vals, vals.clone(), kind="add",
                              changed=torch.zeros_like(lanes))
    with pytest.raises(ValueError, match="push"):
        tgk.edge_relax_lanes_(*args, vals, vals.clone(), at=torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("has_csc", [True, False])
def test_batched_push_takes_the_csr_with_or_without_a_mirror(has_csc, monkeypatch):
    """On the cuda substrate the batched push, in and out of place, hands
    the kernel the CSR whether or not the graph has a CSC mirror (a route
    over the mirror was measured slower); it gives the torch substrate's
    result and ``batched_updated_mask``'s changed lanes."""
    src, dst, n = jgen.rmat(7, 8, seed=3)
    jg = jfrom_coo(src, dst, n, jgen.random_weights(len(src), seed=4), block_size=64,
                   build_csc=has_csc)
    tg = port_graph(jg)
    seen = []
    for name in ("edge_relax_lanes", "edge_relax_lanes_"):
        real = getattr(tgk, name)

        def spy(*a, _real=real, **k):
            seen.append(a[1] is tg.col_idx)
            return _real(*a, **k)
        monkeypatch.setattr(tgk, name, spy)
    rng = np.random.default_rng(5)
    sv, active, init = (T(x) for x in lane_data(rng, 4, tg.n_pad, "min", "f32"))
    want = tops.batched_push_dense(tg, sv, active, init, substrate="torch")
    got = tops.batched_push_dense(tg, sv, active, init, substrate="cuda")
    out = init.clone()
    changed = torch.zeros_like(active)
    tops.batched_push_dense_(tg, sv, active, out, substrate="cuda", changed=changed)
    assert seen == [True] * 2
    assert torch.equal(got, want) and torch.equal(out, want)
    assert torch.equal(changed, tops.batched_updated_mask(init, want))


def test_lanes_launches_count_in_both_reset_functions():
    """Both lanes wrappers count in ``edge_relax_lanes.launches``, which the
    kernels' reset functions set to 0, and the out-of-place wrapper's
    result equals the in-place one's seeded from a copy."""
    from repro_torch import kernels as tk
    for reset in (tgk.reset_launches, tk.reset_launches):
        tgk.edge_relax_lanes.launches = 3
        reset()
        assert tgk.edge_relax_lanes.launches == 0
        assert tk.launch_counts()["edge_relax_lanes"] == 0
    jg, tg = _rmat_graph()
    rng = np.random.default_rng(9)
    sv, active, init = (T(x) for x in lane_data(rng, 3, tg.n_pad, "min", "f32", inf=0.2))
    args = (tg.src_idx, tg.col_idx, tg.edge_w, active, sv)
    out = init.clone()
    assert torch.equal(tgk.edge_relax_lanes(*args, init), tgk.edge_relax_lanes_(*args, out))
