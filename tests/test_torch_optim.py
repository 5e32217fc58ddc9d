"""The port's ``optim`` (schedules, AdamW, int8 gradient compression)
against the JAX package's ``repro.optim``.

Inputs are numpy from a seed, fed to both.  Tolerances: schedules rtol
1e-6 (XLA's and torch's f32 ``cos`` and ``pow`` may sit an ulp apart);
AdamW rtol 1e-6 on parameters and moments, plus an atol of 1e-6 x the
leaf's largest magnitude, ``step`` equal (the update's arithmetic is the
reference's term for term; only the global norm's sum order differs, and
over several steps the moments' signed sums cancel, so that an ulp of
the clip scale is a larger share of a small element); compression
bitwise (codes, scales, residuals).  The
reference's own substrate tests (``tests/test_substrates.py``) run here
against the port too.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as JO  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402

SCHED_RTOL = 1e-6
ADAM_RTOL = 1e-6


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

SCHEDULES = [(100, 10_000, 3e-4, 0.0), (10, 110, 1.0, 0.1), (1, 5, 0.5, 0.0),
             (0, 50, 2e-3, 1e-5)]


@pytest.mark.parametrize("warmup,total,peak,floor", SCHEDULES)
def test_schedules_match_reference(warmup, total, peak, floor):
    for step in [0, 1, 2, warmup - 1, warmup, warmup + 1, (warmup + total) // 2,
                 total - 1, total, total + 7]:
        want_w = float(JO.linear_warmup(step, max(warmup, 1), peak))
        want_c = float(JO.cosine_schedule(step, warmup, total, peak, floor))
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got_w = TO.linear_warmup(s, max(warmup, 1), peak)
            got_c = TO.cosine_schedule(s, warmup, total, peak, floor)
            assert got_w.dtype == got_c.dtype == torch.float32
            np.testing.assert_allclose(float(got_w), want_w, rtol=SCHED_RTOL)
            np.testing.assert_allclose(float(got_c), want_c, rtol=SCHED_RTOL, atol=1e-12)


def test_schedules():
    """``tests/test_substrates.py::test_schedules`` against the port."""
    assert float(TO.linear_warmup(0, 10, 1.0)) == pytest.approx(0.1)
    assert float(TO.cosine_schedule(10, 10, 110, 1.0)) == pytest.approx(1.0)
    assert float(TO.cosine_schedule(110, 10, 110, 1.0, floor=0.1)) == pytest.approx(0.1)
    mid = float(TO.cosine_schedule(60, 10, 110, 1.0))
    assert 0.4 < mid < 0.6


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _tree(seed, dtype=np.float32, scale=1.0):
    r = np.random.default_rng(seed)
    return {"a": (r.normal(size=(3, 5)) * scale).astype(dtype),
            "b": {"c": (r.normal(size=(7,)) * scale).astype(dtype),
                  "d": (r.normal(size=(2, 3, 4)) * scale).astype(dtype)},
            "e": (r.normal(size=()) * scale).astype(dtype)}


def _to_jax(tree, dtype=None):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype or a.dtype), tree)


def _to_torch(tree, dtype=None):
    return {k: _to_torch(v, dtype) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)).to(dtype or torch.float32)
            for k, v in tree.items()}


def _assert_tree_close(got, want, rtol):
    """Each leaf within rtol, plus rtol x the leaf's largest magnitude."""
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for p in path:
            g = g[p.key]
        w = np.asarray(jnp.asarray(w, jnp.float32))
        np.testing.assert_allclose(_np(g), w, rtol=rtol, atol=rtol * float(np.abs(w).max()),
                                   err_msg=str(path))


ADAM_CASES = {
    "plain": dict(lr=1e-2),
    "clipped": dict(lr=3e-3, clip_norm=1e-2),
    "no_clip": dict(lr=5e-2, clip_norm=None),
    "decay": dict(lr=1e-2, weight_decay=0.5, b1=0.8, b2=0.99, eps=1e-6),
}


@pytest.mark.parametrize("case", list(ADAM_CASES))
def test_adamw_update_matches_reference(case):
    kw = dict(ADAM_CASES[case])
    lr = kw.pop("lr")
    p_np = _tree(1)
    jp, tp = _to_jax(p_np), _to_torch(p_np)
    js, ts = JO.adamw_init(jp), TO.adamw_init(tp)
    for step in range(3):
        g_np = _tree(10 + step, scale=0.5 + step)
        jp, js = JO.adamw_update(_to_jax(g_np), js, jp, lr, **kw)
        tp, ts = TO.adamw_update(_to_torch(g_np), ts, tp, lr, **kw)
        assert ts.step.dtype == torch.int32 and int(ts.step) == int(js.step) == step + 1
        _assert_tree_close(tp, jp, ADAM_RTOL)
        _assert_tree_close(ts.mu, js.mu, ADAM_RTOL)
        _assert_tree_close(ts.nu, js.nu, ADAM_RTOL)


def test_adamw_bf16_params_and_tensor_lr():
    """bf16 parameters and grads, f32 moments, the schedule's 0-d lr: the
    bf16 results equal the reference's (each rounds the same f32 value)."""
    p_np = _tree(2)
    jp, tp = _to_jax(p_np, jnp.bfloat16), _to_torch(p_np, torch.bfloat16)
    js, ts = JO.adamw_init(jp), TO.adamw_init(tp)
    for step in range(3):
        g_np = _tree(20 + step)
        jlr = JO.cosine_schedule(js.step, 2, 10, 0.5)
        tlr = TO.cosine_schedule(ts.step, 2, 10, 0.5)
        jp, js = JO.adamw_update(_to_jax(g_np, jnp.bfloat16), js, jp, jlr)
        tp, ts = TO.adamw_update(_to_torch(g_np, torch.bfloat16), ts, tp, tlr)
        assert all(t.dtype == torch.bfloat16 for t in (tp["a"], tp["b"]["c"], tp["e"]))
        assert ts.mu["a"].dtype == ts.nu["b"]["d"].dtype == torch.float32
        _assert_tree_close(tp, jp, 0.0)
        _assert_tree_close(ts.mu, js.mu, ADAM_RTOL)
        _assert_tree_close(ts.nu, js.nu, ADAM_RTOL)


def test_adamw_in_place_and_chunks(monkeypatch):
    """The update writes the parameters and moments in place; chunking a
    leaf along its leading dim changes no value (clip off: the global
    norm's sum order is the one thing chunks reorder)."""
    p_np, g_np = _tree(3), _tree(4)
    whole = TO.adamw_update(_to_torch(g_np), TO.adamw_init(_to_torch(p_np)),
                            _to_torch(p_np), 1e-2, clip_norm=None)
    monkeypatch.setattr(TA, "CHUNK", 4)
    params = _to_torch(p_np)
    state = TO.adamw_init(params)
    a, mu = params["a"], state.mu["a"]
    new_p, new_s = TO.adamw_update(_to_torch(g_np), state, params, 1e-2, clip_norm=None)
    assert new_p["a"] is a and new_s.mu["a"] is mu
    assert len(TA._chunks(params["b"]["d"])) == 2 and len(TA._chunks(params["a"])) == 3
    for got, want in ((new_p, whole[0]), (new_s.mu, whole[1].mu), (new_s.nu, whole[1].nu)):
        for k in ("a", "e"):
            assert torch.equal(got[k], want[k])
        for k in ("c", "d"):
            assert torch.equal(got["b"][k], want["b"][k])


def test_global_norm_matches_reference(monkeypatch):
    g_np = _tree(5, scale=3.0)
    want = float(JA.global_norm(_to_jax(g_np)))
    np.testing.assert_allclose(float(TO.global_norm(_to_torch(g_np))), want, rtol=ADAM_RTOL)
    monkeypatch.setattr(TA, "CHUNK", 4)
    np.testing.assert_allclose(float(TO.global_norm(_to_torch(g_np))), want, rtol=ADAM_RTOL)


def test_adamw_state_from_numpy_carries_reference_state():
    p_np = _tree(6)
    jp = _to_jax(p_np)
    js = JO.adamw_init(jp)
    for step in range(2):
        jp, js = JO.adamw_update(_to_jax(_tree(30 + step)), js, jp, 1e-2)
    host_s = jax.device_get(js)
    ts = TO.adamw_state_from_numpy(host_s, device="cpu")
    assert isinstance(ts, TO.AdamWState) and ts.step.dtype == torch.int32
    assert int(ts.step) == 2 and ts.step.dim() == 0
    tp = TO.adamw_state_from_numpy(dataclasses.replace(host_s, mu=jax.device_get(jp)),
                                   device="cpu").mu
    g_np = _tree(40)
    jp, js = JO.adamw_update(_to_jax(g_np), js, jp, 1e-2)
    tp, ts = TO.adamw_update(_to_torch(g_np), ts, tp, 1e-2)
    assert int(ts.step) == 3
    _assert_tree_close(tp, jp, ADAM_RTOL)
    _assert_tree_close(ts.nu, js.nu, ADAM_RTOL)


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    opt = TO.adamw_init(params)
    for _ in range(300):
        w = params["w"].detach().requires_grad_()
        torch.sum((w - 1.0) ** 2).backward()
        params, opt = TO.adamw_update({"w": w.grad}, opt, params, 0.1, weight_decay=0.0)
    np.testing.assert_allclose(params["w"].numpy(), 1.0, atol=1e-2)
    assert int(opt.step) == 300


def test_adamw_weight_decay_shrinks():
    params = {"w": torch.ones((4,)) * 10}
    opt = TO.adamw_init(params)
    zero_g = {"w": torch.zeros((4,))}
    for _ in range(50):
        params, opt = TO.adamw_update(zero_g, opt, params, 1e-2, weight_decay=0.5)
    assert float(params["w"].max()) < 10.0


def test_grad_clip():
    params = {"w": torch.zeros((3,))}
    opt = TO.adamw_init(params)
    huge = {"w": torch.full((3,), 1e9)}
    p2, _ = TO.adamw_update(huge, opt, params, 1.0, clip_norm=1.0, weight_decay=0.0)
    assert torch.isfinite(p2["w"]).all()


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

COMPRESS_SIZES = [1, 7, 255, 256, 257, 1000, 4096]


@pytest.mark.parametrize("n", COMPRESS_SIZES)
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_compress_int8_bitwise(n, scale):
    r = np.random.default_rng(n)
    x = (r.normal(size=n) * scale).astype(np.float32)
    if n >= 512:
        x[256:512] = 0.0              # an all-zero block: scale 0, the 1e-12 floor
    jc, js = JO.compress_int8(jnp.asarray(x))
    tc, ts = TO.compress_int8(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    y = TO.decompress_int8(tc, ts, (n,))
    np.testing.assert_array_equal(
        y.numpy().view(np.uint32),
        np.asarray(JO.decompress_int8(jc, js, (n,))).view(np.uint32))


@pytest.mark.parametrize("shape", [(64,), (3, 100), (2, 5, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressed_gradient_bitwise(shape, dtype):
    """Error feedback over 6 steps: dequantised grads and residuals bitwise."""
    r = np.random.default_rng(sum(shape))
    jerr = jnp.zeros(shape, jnp.float32)
    terr = torch.zeros(shape, dtype=torch.float32)
    for _ in range(6):
        g = r.normal(size=shape).astype(np.float32)
        jq, jerr = JO.compressed_gradient(jnp.asarray(g, dtype), jerr)
        tq, terr = TO.compressed_gradient(torch.from_numpy(g).to(getattr(torch, dtype)), terr)
        assert tq.dtype == getattr(torch, dtype) and terr.dtype == torch.float32
        np.testing.assert_array_equal(_np(tq), np.asarray(jnp.asarray(jq, jnp.float32)))
        np.testing.assert_array_equal(terr.numpy().view(np.uint32),
                                      np.asarray(jerr).view(np.uint32))


def test_compression_init_matches_reference():
    p_np = _tree(7)
    js = JO.compression_init(_to_jax(p_np, jnp.bfloat16))
    ts = TO.compression_init(_to_torch(p_np, torch.bfloat16))
    assert isinstance(ts, TO.CompressionState)
    assert ts.error["b"]["d"].dtype == torch.float32
    _assert_tree_close(ts.error, js.error, 0.0)


@pytest.mark.parametrize("seed", range(6))
def test_int8_roundtrip_bounded_error(seed):
    """``test_substrates.py::test_int8_roundtrip_bounded_error`` on the port."""
    r = np.random.default_rng(seed)
    n = int(r.integers(1, 1000))
    x = torch.from_numpy((r.normal(size=n) * 10 ** r.uniform(-3, 3)).astype(np.float32))
    codes, s = TO.compress_int8(x)
    y = TO.decompress_int8(codes, s, x.shape)
    assert float((x - y).abs().max()) <= float(x.abs().max()) / 127.0 + 1e-6


def test_error_feedback_accumulates():
    r = np.random.default_rng(0)
    g_true = [torch.from_numpy(r.normal(size=64).astype(np.float32)) for _ in range(50)]
    err = torch.zeros(64)
    sent = torch.zeros(64)
    for g in g_true:
        q, err = TO.compressed_gradient(g, err)
        sent = sent + q
    np.testing.assert_allclose((sent + err).numpy(), sum(g_true).numpy(), rtol=1e-4, atol=1e-4)
