"""The port's attention layer (``repro_torch.models.layers``) against the
JAX package's ``models/layers.py``.

The JAX parameters (``attn_init`` from a PRNG key) cross to the port with
``params_from_numpy``; the input and positions are numpy from a seed.  The
configs are the SMOKE widths of h2o-danube-3-4b (GQA, sliding window) and
stablelm-3b (MHA, causal), each under ``use_pallas`` (the flash kernel:
interpret mode in JAX, the plain version in the port), the plain softmax,
the lean softmax and qk-norm.

Tolerances: the reference's f32 2e-5 (the sums run in other orders); for
the bf16 cases 2e-2 (the reference's bf16 tolerance: the einsums and
softmax round to bf16 at the same places in both, each rounding may land
one ulp apart).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import h2o_danube3_4b, stablelm_3b  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
CONFIGS = {"danube": h2o_danube3_4b.SMOKE, "stablelm": stablelm_3b.SMOKE}
VARIANTS = {
    "pallas": (dict(), True),
    "plain": (dict(), False),
    "lean": (dict(lean_softmax=True), False),
    "qk_norm": (dict(qk_norm=True), False),
    "qk_norm+pallas": (dict(qk_norm=True), True),
}


def _configs(name, variant):
    jcfg = dataclasses.replace(CONFIGS[name].attn, **VARIANTS[variant][0])
    fields = {f.name for f in dataclasses.fields(TL.AttnConfig)}
    tcfg = TL.AttnConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                            if k in fields})
    return jcfg, tcfg


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _both(name, variant, dtype, B=2, S=24, seed=0):
    """(jax output, port output) of attention on the same params and input."""
    jcfg, tcfg = _configs(name, variant)
    use_pallas = VARIANTS[variant][1]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jp = JL.attn_init(jax.random.PRNGKey(seed), jcfg, jdt)
    if jcfg.qk_norm:   # non-trivial norm weights
        rng = np.random.default_rng(seed + 1)
        jp = dict(jp, q_norm=jnp.asarray(1 + 0.1 * rng.normal(size=jcfg.d_head), jdt),
                  k_norm=jnp.asarray(1 + 0.1 * rng.normal(size=jcfg.d_head), jdt))
    tp = TL.params_from_numpy(jax.device_get(jp), device="cpu")
    x = np.random.default_rng(seed).normal(size=(B, S, jcfg.d_model))
    pos = np.arange(S, dtype=np.int32)
    want = JL.attention(jp, jcfg, jnp.asarray(x, jdt), jnp.asarray(pos),
                        use_pallas=use_pallas)
    got = TL.attention(tp, tcfg, torch.from_numpy(x).to(tp["wq"].dtype),
                       torch.from_numpy(pos), use_pallas=use_pallas)
    return want, got


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_attention_matches_jax_f32(name, variant):
    want, got = _both(name, variant, "float32")
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL["float32"],
                               rtol=TOL["float32"])


@pytest.mark.parametrize("variant", ["pallas", "plain", "lean"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_attention_matches_jax_bf16(name, variant):
    want, got = _both(name, variant, "bfloat16", S=40)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL["bfloat16"],
                               rtol=TOL["bfloat16"])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_flash_path_equals_plain_path(name):
    """Within the port: the flash kernel's branch and the plain softmax give
    the same layer output (f32, over a sequence longer than one 128 block)."""
    jcfg, tcfg = _configs(name, "plain")
    p = TL.attn_init(torch.Generator().manual_seed(5), tcfg, torch.float32, device="cpu")
    x = torch.randn((1, 150, tcfg.d_model), generator=torch.Generator().manual_seed(6))
    pos = torch.arange(150)
    a = TL.attention(p, tcfg, x, pos, use_pallas=True)
    b = TL.attention(p, tcfg, x, pos, use_pallas=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL["float32"],
                               rtol=TOL["float32"])


def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 10, 3, 16)).astype(np.float32)
    w = (1 + 0.1 * rng.normal(size=16)).astype(np.float32)
    np.testing.assert_allclose(TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
                               np.asarray(JL.rmsnorm(jnp.asarray(x), jnp.asarray(w))),
                               atol=1e-6, rtol=1e-6)
    for pos in (np.arange(10), np.stack([np.arange(10), np.arange(5, 15)])):
        jc, js = JL.rope_tables(jnp.asarray(pos), 16, 1e4)
        tc_, ts = TL.rope_tables(torch.from_numpy(pos), 16, 1e4)
        np.testing.assert_allclose(tc_.numpy(), np.asarray(jc), atol=1e-6)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
        np.testing.assert_allclose(
            TL.apply_rope(torch.from_numpy(x), tc_, ts).numpy(),
            np.asarray(JL.apply_rope(jnp.asarray(x), jc, js)), atol=1e-5)


@pytest.mark.parametrize("window,offset", [(None, 0), (3, 0), (4, 5)])
def test_masks_and_kv_expansion_match_jax(window, offset):
    assert np.array_equal(TL._causal_mask(6, 11, window, offset).numpy(),
                          np.asarray(JL._causal_mask(6, 11, window, offset)))
    k = np.random.default_rng(8).normal(size=(2, 5, 2, 4)).astype(np.float32)
    assert np.array_equal(TL._expand_kv(torch.from_numpy(k), 6).numpy(),
                          np.asarray(JL._expand_kv(jnp.asarray(k), 6)))


def test_attn_init_and_params_from_numpy():
    _, tcfg = _configs("danube", "qk_norm")
    p = TL.attn_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16,
                     device="cpu")
    hd, kvd = tcfg.n_heads * tcfg.d_head, tcfg.n_kv_heads * tcfg.d_head
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "wq": (64, hd), "wk": (64, kvd), "wv": (64, kvd), "wo": (hd, 64),
        "q_norm": (16,), "k_norm": (16,)}
    assert all(v.dtype == torch.bfloat16 for v in p.values())
    jp = jax.device_get(JL.attn_init(jax.random.PRNGKey(1), _configs("danube", "plain")[0],
                                     jnp.bfloat16))
    tp = TL.params_from_numpy(jp, device="cpu")
    for name, a in jp.items():
        assert tp[name].dtype == torch.bfloat16
        assert np.array_equal(tp[name].view(torch.int16).numpy(), a.view(np.int16))


def test_layer_initialisers_need_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, tcfg = _configs("danube", "plain")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.dense_init(gen, (4, 4), torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.attn_init(gen, tcfg, torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.params_from_numpy({"wq": np.zeros((2, 2), np.float32)})
    assert TL.dense_init(gen, (4, 4), torch.float32, device="cpu").device.type == "cpu"
