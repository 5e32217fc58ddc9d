"""The decode half of the port's ``models/layers.py`` against the JAX
package's: ``attention_decode`` (shared and per-slot positions, the slot
mask, GQA and MHA, the window, qk-norm, a shared position past the cache's
end and per-slot positions outside it), ``swiglu`` and ``moe_block`` (the
deepseek-moe SMOKE block with shared experts, the qwen3-moe one without,
capacity overflow, tied router scores), aux loss included.

The JAX parameters cross with ``params_from_numpy``; inputs are numpy from
a seed.  Tolerances are ``tests/test_torch_layers.py``'s: f32 2e-5, bf16
2e-2 (the sums run in other orders, each bf16 rounding may land one ulp
apart; the MoE combine adds in bf16 in both, in the same order).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import deepseek_moe_16b, h2o_danube3_4b, qwen3_moe_235b, stablelm_3b  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ATTN = {"danube": h2o_danube3_4b.SMOKE.attn,            # GQA 4/2, window 8
        "stablelm": stablelm_3b.SMOKE.attn,             # MHA 4/4, causal
        "danube+qk_norm": dataclasses.replace(h2o_danube3_4b.SMOKE.attn, qk_norm=True)}
S_MAX = 16
B = 3
# (name, pos, slot_mask): a shared position inside the window, one past
# the window (8), one past S_max - 1 (the reference clamps the write to
# S_max - 1 and masks by the unclamped position); per-slot positions with
# and without a mask, and with one slot at or past S_max (writes nothing)
POSITIONS = {
    "shared": (5, None),
    "shared_windowed": (12, None),
    "shared_clamped": (S_MAX + 3, None),
    "per_slot": ([0, 9, 15], None),
    "per_slot_masked": ([3, 11, 7], [True, False, True]),
    "per_slot_past_end": ([S_MAX, 4, S_MAX + 2], [True, True, False]),
}


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x.astype(jnp.float32) if hasattr(x, "astype") else x, np.float32)


def _port_cfg(jcfg):
    return TL.AttnConfig(**dataclasses.asdict(jcfg))


def _close(got, want, dtype):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(POSITIONS))
@pytest.mark.parametrize("name", list(ATTN))
def test_attention_decode_matches_jax(name, mode, dtype):
    jcfg = ATTN[name]
    jdt = JDT[dtype]
    jp = JL.attn_init(jax.random.PRNGKey(3), jcfg, jdt)
    rng = np.random.default_rng(4)
    if jcfg.qk_norm:
        jp = dict(jp, q_norm=jnp.asarray(1 + 0.1 * rng.normal(size=jcfg.d_head), jdt),
                  k_norm=jnp.asarray(1 + 0.1 * rng.normal(size=jcfg.d_head), jdt))
    tp = TL.params_from_numpy(jax.device_get(jp), device="cpu")
    x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    shape = (B, S_MAX, jcfg.n_kv_heads, jcfg.d_head)
    ck, cv = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    pos, mask = POSITIONS[mode]
    jpos = jnp.asarray(pos, jnp.int32)
    jmask = None if mask is None else jnp.asarray(mask)
    want = JL.attention_decode(jp, jcfg, jnp.asarray(x, jdt), jnp.asarray(ck, jdt),
                               jnp.asarray(cv, jdt), jpos, jmask)
    tk = torch.from_numpy(ck).to(TDT[dtype])
    tv = torch.from_numpy(cv).to(TDT[dtype])
    got = TL.attention_decode(tp, _port_cfg(jcfg), torch.from_numpy(x).to(TDT[dtype]),
                              tk, tv, torch.tensor(pos, dtype=torch.int32),
                              None if mask is None else torch.tensor(mask))
    assert got[1] is tk and got[2] is tv          # written in place
    assert got[0].dtype == TDT[dtype] and tuple(got[0].shape) == want[0].shape
    _close(got[0], want[0], dtype)
    for g, w in zip(got[1:], want[1:]):
        # the caches: bitwise where nothing was written, within tol at the write
        _close(g, w, dtype)
        assert int((_f32(g) != _f32(w)).any(axis=(2, 3)).sum()) <= B


@pytest.mark.parametrize("pos", [0, S_MAX - 1, S_MAX, S_MAX + 7])
def test_attention_decode_shared_write_clamps(pos):
    """A shared position writes every slot at min(pos, S_max - 1); a
    per-slot position at or past S_max writes nothing (JAX's rules)."""
    tcfg = _port_cfg(ATTN["danube"])
    p = TL.attn_init(torch.Generator().manual_seed(0), tcfg, torch.float32, device="cpu")
    x = torch.randn((B, 1, tcfg.d_model), generator=torch.Generator().manual_seed(1))
    shape = (B, S_MAX, tcfg.n_kv_heads, tcfg.d_head)
    ck, cv = torch.zeros(shape), torch.zeros(shape)
    TL.attention_decode(p, tcfg, x, ck, cv, pos)
    written = ck.abs().sum((2, 3)) > 0
    assert written.sum(1).tolist() == [1] * B
    assert written[:, min(pos, S_MAX - 1)].all()
    ck2, cv2 = torch.zeros(shape), torch.zeros(shape)
    TL.attention_decode(p, tcfg, x, ck2, cv2, torch.full((B,), pos, dtype=torch.int32))
    assert int((ck2.abs().sum((2, 3)) > 0).sum()) == (B if pos < S_MAX else 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_matches_jax(dtype):
    jp = JL.swiglu_init(jax.random.PRNGKey(5), 64, 160, JDT[dtype])
    tp = TL.params_from_numpy(jax.device_get(jp), device="cpu")
    x = np.random.default_rng(6).normal(size=(2, 7, 64)).astype(np.float32)
    want = JL.swiglu(jp, jnp.asarray(x, JDT[dtype]))
    got = TL.swiglu(tp, torch.from_numpy(x).to(TDT[dtype]))
    assert got.dtype == TDT[dtype]
    _close(got, want, dtype)


MOE = {"deepseek": (deepseek_moe_16b.SMOKE.moe, 64),   # top-3 of 8, 2 shared
       "qwen3": (qwen3_moe_235b.SMOKE.moe, 64)}        # top-2 of 8, none shared
# (capacity_factor or None, tie two experts' router columns)
MOE_CASES = {"plain": (None, False), "overflow": (0.5, False), "ties": (None, True)}


def _moe_both(name, case, dtype, S=12, seed=0):
    mcfg, d_model = MOE[name]
    cf, tie = MOE_CASES[case]
    if cf is not None:
        mcfg = dataclasses.replace(mcfg, capacity_factor=cf)
    jp = jax.tree.map(np.array, jax.device_get(
        JL.moe_init(jax.random.PRNGKey(seed), d_model, mcfg, JDT[dtype])))
    if tie:   # experts 2 and 5 get equal scores on every token
        jp["router"][:, 5] = jp["router"][:, 2]
    tp = TL.params_from_numpy(jp, device="cpu")
    x = np.random.default_rng(seed + 1).normal(size=(2, S, d_model)).astype(np.float32)
    jx = jnp.asarray(x, JDT[dtype])
    jp = jax.tree.map(jnp.asarray, jp)
    want = JL.moe_block(jp, mcfg, jx)
    tcfg = TL.MoEConfig(**dataclasses.asdict(mcfg))
    got = TL.moe_block(tp, tcfg, torch.from_numpy(x).to(TDT[dtype]))
    return mcfg, jp, jx, tp, tcfg, want, got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("name", list(MOE))
def test_moe_block_matches_jax(name, case, dtype):
    mcfg, jp, jx, tp, tcfg, want, got = _moe_both(name, case, dtype)
    assert got[0].dtype == TDT[dtype] and tuple(got[0].shape) == want[0].shape
    _close(got[0], want[0], dtype)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)
    T, K, E = jx.shape[0] * jx.shape[1], mcfg.top_k, mcfg.n_experts
    cap = int(mcfg.capacity_factor * T * K / E) + 1
    if case == "overflow":   # some expert gets more than its capacity
        loads = np.bincount(np.asarray(jax.lax.top_k(jax.nn.softmax(
            jx.reshape(T, -1).astype(jnp.float32) @ jp["router"]), K)[1]).ravel(),
            minlength=E)
        assert loads.max() > cap


@pytest.mark.parametrize("name", list(MOE))
def test_moe_route_orders_ties_as_jax_top_k(name):
    mcfg, jp, jx, tp, tcfg, _, _ = _moe_both(name, "ties", "float32")
    xt = jx.reshape(-1, jx.shape[-1])
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ jp["router"], axis=-1)
    jw, je = jax.lax.top_k(probs, mcfg.top_k)
    tprobs, tw, te = TL.moe_route(tp, tcfg, torch.from_numpy(np.array(xt)))
    assert np.array_equal(te.numpy(), np.asarray(je))
    tied = (np.asarray(je) == 2).any(1) & (np.asarray(je) == 5).any(1)
    assert tied.any()        # the tie is met, and broken to the lower expert
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw / jw.sum(-1, keepdims=True)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(probs), rtol=1e-6, atol=1e-7)


def test_moe_init_shapes():
    mcfg, d_model = MOE["deepseek"]
    tcfg = TL.MoEConfig(**dataclasses.asdict(mcfg))
    tp = TL.moe_init(torch.Generator().manual_seed(0), d_model, tcfg, torch.bfloat16,
                     device="cpu")
    jp = jax.eval_shape(lambda k: JL.moe_init(k, d_model, mcfg, jnp.bfloat16),
                        jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        t = tp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape and str(t.dtype).split(".")[1] == str(leaf.dtype)
