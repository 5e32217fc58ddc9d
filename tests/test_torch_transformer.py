"""The port's ``models/transformer.py`` and ``configs/`` against the JAX
package's: the five architectures' FULL and SMOKE configs field by field,
``init``'s tree and shapes (``jax.eval_shape`` of the reference's) and the
parameter counts, ``forward`` (logits and aux) with carried weights at the
five SMOKE configs, ``make_decode`` step by step with per-slot positions
and a slot mask, and ``init_cache``.

Weights are the reference's ``init`` carried across with
``params_from_numpy``; tokens are numpy from a seed.  Tolerances: the
reference's f32 2e-5 on layers, here 1e-4 on the logits of two layers and
an unembedding (the sums run in other orders and the error grows through
each layer's residual); bf16 2e-2 (``tests/test_torch_layers.py``'s) of
the logits' scale (their largest magnitude): a one-ulp rounding apart in
the residual stream of the first layer reaches every logit after it.
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import (deepseek_moe_16b, glm4_9b, h2o_danube3_4b,  # noqa: E402
                           qwen3_moe_235b, stablelm_3b)
from repro.models import transformer as JT  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = {"h2o_danube3_4b": h2o_danube3_4b, "stablelm_3b": stablelm_3b,
         "glm4_9b": glm4_9b, "deepseek_moe_16b": deepseek_moe_16b,
         "qwen3_moe_235b": qwen3_moe_235b}
LOGIT_TOL = 1e-4
BF16_TOL = 2e-2


def port_cfg(jcfg, **changes):
    """A JAX LMConfig converted field for field."""
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    if d["moe"] is not None:
        d["moe"] = TL.MoEConfig(**dataclasses.asdict(d["moe"]))
    return dataclasses.replace(TT.LMConfig(**d), **changes)


def port_module(arch):
    return importlib.import_module(f"repro_torch.configs.{arch}")


def carried(jcfg, seed=0):
    """(JAX params, the port's copy on the CPU)."""
    jp = JT.init(jax.random.PRNGKey(seed), jcfg)
    return jp, TT.params_from_numpy(jax.device_get(jp), device="cpu")


@pytest.mark.parametrize("which", ["FULL", "SMOKE"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_configs_equal_the_reference(arch, which):
    j, t = getattr(ARCHS[arch], which), getattr(port_module(arch), which)
    assert type(t) is TT.LMConfig
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t == port_cfg(j)
    assert (t.head_dim, t.param_count, t.active_param_count) == (
        j.head_dim, j.param_count, j.active_param_count)
    assert dataclasses.asdict(t.attn) == dataclasses.asdict(j.attn)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).replace("torch.", "")


@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_tree_matches_eval_shape(arch, tie):
    jcfg = dataclasses.replace(ARCHS[arch].SMOKE, tie_embeddings=tie)
    want = _shapes(jax.eval_shape(lambda k: JT.init(k, jcfg), jax.random.PRNGKey(0)))
    cfg = port_cfg(jcfg)
    p = TT.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert _shapes(p) == want
    assert ("unembed" in p) == (not tie)
    assert cfg.param_count == jcfg.param_count
    # the norms start at one and the layers differ from each other
    assert bool((p["layers"]["attn_norm"] == 1).all())
    wq = p["layers"]["attn"]["wq"]
    assert not torch.equal(wq[0], wq[1])


@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_matches_jax(arch):
    jcfg = ARCHS[arch].SMOKE
    jp, tp = carried(jcfg)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    want, want_aux = JT.forward(jp, jcfg, jnp.asarray(toks))
    got, aux = TT.forward(tp, port_cfg(jcfg), torch.from_numpy(toks))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5, atol=1e-7)
    if jcfg.moe:
        assert float(aux) > 0
    np.testing.assert_allclose(
        TT.make_prefill(port_cfg(jcfg))(tp, torch.from_numpy(toks)).numpy(), got.numpy())


def test_forward_matches_jax_bf16():
    jcfg = dataclasses.replace(h2o_danube3_4b.SMOKE, dtype="bfloat16")
    jp, tp = carried(jcfg)
    assert tp["embed"].dtype == torch.bfloat16
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    want, _ = JT.forward(jp, jcfg, jnp.asarray(toks))
    got, _ = TT.forward(tp, port_cfg(jcfg), torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want)
    assert err.max() <= BF16_TOL * np.abs(want).max(), (err.max(), np.abs(want).max())


# per step: (pos per slot, slot mask); slots park, restart and pass the
# danube SMOKE window (8)
STEPS = [([0, 0, 0], [True, True, False]), ([1, 1, 0], [True, True, True]),
         ([2, 2, 1], [True, False, True]), ([3, 2, 2], [True, True, True]),
         ([4, 3, 3], [True, True, False]), ([5, 4, 3], [True, True, True]),
         ([6, 5, 4], [True, True, True]), ([7, 6, 5], [True, True, True]),
         ([8, 7, 6], [True, True, True]), ([9, 8, 7], [True, True, True]),
         ([10, 9, 8], [True, False, True]), ([11, 9, 9], [True, True, True])]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_make_decode_per_slot_matches_jax(arch):
    jcfg = ARCHS[arch].SMOKE
    jp, tp = carried(jcfg, seed=2)
    cfg = port_cfg(jcfg)
    B, S_max = 3, 16
    jcache = JT.init_cache(jcfg, B, S_max)
    tcache = TT.init_cache(cfg, B, S_max, device="cpu")
    jdec, tdec = jax.jit(JT.make_decode(jcfg)), TT.make_decode(cfg)
    rng = np.random.default_rng(3)
    for pos, mask in STEPS:
        toks = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
        pos, mask = np.asarray(pos, np.int32), np.asarray(mask)
        want, jcache = jdec(jp, jcache, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(mask))
        got, tcache = tdec(tp, tcache, torch.from_numpy(toks), torch.from_numpy(pos),
                           torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        # the same cells written: the masked steps left theirs untouched
        assert np.array_equal(tcache[key].numpy() != 0, np.asarray(jcache[key]) != 0)


@pytest.mark.parametrize("dtype", [None, "float32"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_cache_matches_jax(arch, dtype):
    jcfg = ARCHS[arch].SMOKE if dtype else dataclasses.replace(ARCHS[arch].SMOKE,
                                                              dtype="bfloat16")
    want = JT.init_cache(jcfg, 3, 20, dtype=dtype and jnp.float32)
    got = TT.init_cache(port_cfg(jcfg), 3, 20, dtype=dtype, device="cpu")
    assert _shapes(got) == _shapes(jax.eval_shape(lambda: want))
    assert all(not bool(t.any()) for t in got.values())
