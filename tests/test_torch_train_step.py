"""The port's training step (``transformer.loss_fn``, ``value_and_grad``,
``make_train_step``) against the JAX package's, with the reference's
weights carried across and tokens made with numpy from a seed.

Cases: the five architectures' SMOKE configs (f32, remat on) and the
trainer test's MoE config (``tests/test_train_loop.py``, remat off).
Tolerances: the loss rtol 1e-5; each gradient leaf rtol 1e-4, atol 1e-6
(sums in other orders through two layers); after one AdamW step the
parameters within rtol 1e-5 plus 2·lr (a near-zero gradient's sign may
differ, and AdamW then moves that weight by ±lr).  ``remat`` changes no
value: on the CPU the step with it equals the step without, bitwise.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import (deepseek_moe_16b, glm4_9b, h2o_danube3_4b,  # noqa: E402
                           qwen3_moe_235b, stablelm_3b)
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PARAM_RTOL = 1e-5
BF16_TOL = 2e-2

TRAINER_CFG = JT.LMConfig(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                          d_ff=64, vocab_size=64, dtype="float32", remat=False,
                          moe=JL.MoEConfig(n_experts=4, top_k=2, d_expert=32))
CONFIGS = {"h2o_danube3_4b": h2o_danube3_4b.SMOKE, "stablelm_3b": stablelm_3b.SMOKE,
           "glm4_9b": glm4_9b.SMOKE, "deepseek_moe_16b": deepseek_moe_16b.SMOKE,
           "qwen3_moe_235b": qwen3_moe_235b.SMOKE, "trainer_moe": TRAINER_CFG}


def port_cfg(jcfg, **changes):
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    if d["moe"] is not None:
        d["moe"] = TL.MoEConfig(**dataclasses.asdict(d["moe"]))
    return dataclasses.replace(TT.LMConfig(**d), **changes)


def batches(vocab, seed=0, b=2, s=16):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])})


def carried(jcfg, seed=0):
    jp = JT.init(jax.random.PRNGKey(seed), jcfg)
    return jp, TT.params_from_numpy(jax.device_get(jp), device="cpu")


def paired(jtree, ttree):
    """(path, reference leaf as numpy f32, port leaf as numpy f32) pairs."""
    for path, a in jax.tree_util.tree_flatten_with_path(jax.device_get(jtree))[0]:
        t = ttree
        for p in path:
            t = t[p.key]
        yield path, np.asarray(jnp.asarray(a, jnp.float32)), t.detach().float().numpy()


def tree_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request):
    """(name, JAX config, port config, JAX params, port params, batches,
    the reference's (loss, metrics) and grads)."""
    jcfg = CONFIGS[request.param]
    jp, tp = carried(jcfg)
    jb, tb = batches(jcfg.vocab_size)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(p, jcfg, b), has_aux=True))
    (loss, metrics), grads = grad_fn(jp, jb)
    return request.param, jcfg, port_cfg(jcfg), jp, tp, jb, tb, (loss, metrics), grads


def test_loss_and_grads_match_reference(case):
    name, jcfg, tcfg, jp, tp, jb, tb, (jloss, jmet), jgrads = case
    (loss, metrics), grads = TT.value_and_grad(tp, tcfg, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["nll"]), float(jmet["nll"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["aux"]), float(jmet["aux"]),
                               rtol=LOSS_RTOL, atol=1e-9)
    plain_loss, _ = TT.loss_fn(tp, tcfg, tb)
    assert float(plain_loss) == float(loss)
    n = 0
    for path, want, got in paired(jgrads, grads):
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=str(path))
        n += 1
    assert n == len(jax.tree.leaves(jgrads))


def test_remat_changes_no_value(case):
    name, jcfg, tcfg, jp, tp, jb, tb, *_ = case
    (l_on, m_on), g_on = TT.value_and_grad(tp, dataclasses.replace(tcfg, remat=True), tb)
    (l_off, m_off), g_off = TT.value_and_grad(tp, dataclasses.replace(tcfg, remat=False), tb)
    assert torch.equal(l_on, l_off) and torch.equal(m_on["aux"], m_off["aux"])
    assert tree_equal(g_on, g_off)


def test_value_and_grad_leaves_params_alone(case):
    """The gradient tree mirrors the parameters (shapes, dtypes); the
    parameters keep their values and carry no ``.grad``."""
    name, jcfg, tcfg, jp, tp, jb, tb, *_ = case
    before = TT.tree_map(torch.clone, tp)
    _, grads = TT.value_and_grad(tp, tcfg, tb)
    assert tree_equal(tp, before)

    def check(p, g):
        assert g.shape == p.shape and g.dtype == p.dtype
        assert p.grad is None and not p.requires_grad
    TT.tree_map(check, tp, grads)


def saved_bytes(params, cfg, batch):
    """Bytes autograd saves for the backward pass of ``loss_fn``."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    work = TT.tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        TT.loss_fn(work, cfg, batch)
    return total[0]


@pytest.mark.parametrize("name", ["h2o_danube3_4b", "deepseek_moe_16b"])
def test_remat_keeps_only_weight_products(name):
    """With remat the forward pass keeps each layer's input and its GEMMs'
    outputs: far less than without (the attention scores dominate)."""
    jcfg = CONFIGS[name]
    _, tp = carried(jcfg)
    _, tb = batches(jcfg.vocab_size, s=64)
    on = saved_bytes(tp, port_cfg(jcfg, remat=True), tb)
    off = saved_bytes(tp, port_cfg(jcfg, remat=False), tb)
    assert 0 < on < off / 2, (on, off)


@pytest.mark.parametrize("name", ["h2o_danube3_4b", "deepseek_moe_16b", "trainer_moe"])
def test_train_step_matches_reference(name):
    jcfg = CONFIGS[name]
    jp, tp = carried(jcfg, seed=1)
    jb, tb = batches(jcfg.vocab_size, seed=1)
    lr_peak = 3e-2          # large enough that the step moves every weight
    jp2, js, jm = jax.jit(JT.make_train_step(jcfg, lr_peak=lr_peak, total_steps=20))(
        jp, j_adamw_init(jp), jb)
    opt = adamw_init(tp)
    tp2, ts, tm = TT.make_train_step(port_cfg(jcfg), lr_peak=lr_peak, total_steps=20)(
        tp, opt, tb)
    assert tp2 is tp and int(ts.step) == int(js.step) == 1
    for k in ("loss", "nll", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL, err_msg=k)
    lr = float(jm["lr"])
    for path, want, got in paired(jp2, tp2):
        np.testing.assert_allclose(got, want, rtol=PARAM_RTOL, atol=2 * lr, err_msg=str(path))
    for path, want, got in paired(js.mu, ts.mu):
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=str(path))


def test_bf16_loss_and_grad_dtypes():
    """danube's SMOKE shape in bf16: the loss within the bf16 tolerance of
    the reference's, every gradient in its parameter's dtype."""
    jcfg = dataclasses.replace(h2o_danube3_4b.SMOKE, dtype="bfloat16")
    jp, tp = carried(jcfg)
    jb, tb = batches(jcfg.vocab_size)
    want = float(jax.jit(lambda p, b: JT.loss_fn(p, jcfg, b)[0])(jp, jb))
    (loss, _), grads = TT.value_and_grad(tp, port_cfg(jcfg), tb)
    np.testing.assert_allclose(float(loss), want, rtol=BF16_TOL)
    assert grads["layers"]["mlp"]["wo"].dtype == torch.bfloat16
    assert grads["embed"].dtype == torch.bfloat16
    assert all(bool(torch.isfinite(g.float()).all()) for g in
               (grads["embed"], grads["unembed"], grads["layers"]["attn"]["wq"]))
