"""The port's MIND (``models/recsys/mind.py``, ``configs/mind.py``)
against the JAX package's, from the reference's parameters carried
across and histories made with numpy from a seed.

Tolerances: interests, losses rtol 1e-5 (atol 1e-6 of the largest
|value|); each gradient leaf within 1e-5 of its largest |g|; after k
AdamW steps the parameters within rtol 1e-5 plus 2·lr·k (a near-zero
gradient's sign may differ, and AdamW then moves that weight by ±lr);
scores within 1e-5 of the row's largest |score|; top-k ids equal, ties
included (a slate with duplicated candidates scores them bitwise equal).
Without either of the two ``.detach()`` calls of ``interests`` the
gradients leave their tolerance.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import mind as JCM  # noqa: E402
from repro.models.recsys import mind as JM  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro_torch.configs import mind as TCM  # noqa: E402
from repro_torch.data.pipeline import prng_key, randint  # noqa: E402
from repro_torch.models.recsys import mind as TM  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

RTOL, ATOL_OF_MAX, GRAD_OF_MAX = 1e-5, 1e-6, 1e-5
LR = 1e-3          # make_train_step's rate
STEPS = 3
CFG = JM.MINDConfig(name="mind-test", n_items=300, embed_dim=16, n_interests=4,
                    capsule_iters=3, hist_len=12)


def port_cfg(jcfg):
    return TM.MINDConfig(**{f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__})


def batch(seed, B=24, cfg=CFG):
    """Histories with padding (pad_id 0) and distinct targets."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, cfg.n_items, (B, cfg.hist_len)).astype(np.int32)
    hist[rng.random(hist.shape) < 0.2] = cfg.pad_id
    target = rng.permutation(np.arange(1, cfg.n_items))[:B].astype(np.int32)
    return {"hist": hist, "target": target}


@pytest.fixture(scope="module")
def ref():
    # the table ×10 (norms near 1): the routing logits then move, so that
    # each stop_gradient shows in the gradients
    params = jax.device_get(JM.init(jax.random.PRNGKey(3), CFG))
    params = dict(params, embed=params["embed"] * np.float32(10.0))
    b = batch(4)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, CFG, jb), has_aux=True))(params)
    step = jax.jit(JCM.make_train_step(CFG))
    p, o = params, j_adamw_init(params)
    losses = []
    for _ in range(STEPS):
        p, o, m = step(p, o, jb)
        losses.append(float(m["loss"]))
    return dict(params=params, batch=b, loss=float(loss), grads=jax.device_get(grads),
                u=np.asarray(JM.interests(params, CFG, jb["hist"])),
                losses=losses, trained=jax.device_get(p))


def carried(ref):
    return TM.params_from_numpy(ref["params"], "cpu")


def tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def close(got, want, rtol=RTOL, atol_of_max=ATOL_OF_MAX):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_of_max * float(np.abs(want).max(initial=0.0)))


def port_grads(params, b):
    ps = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss, _ = TM.loss_fn(ps, port_cfg(CFG), b)
    return dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))


def grads_close(got, want):
    return all(np.abs(got[k].numpy() - want[k]).max()
               <= GRAD_OF_MAX * np.abs(want[k]).max() for k in want)


def test_interests_and_loss(ref):
    params, b = carried(ref), tbatch(ref["batch"])
    close(TM.interests(params, port_cfg(CFG), b["hist"]), ref["u"])
    loss, metrics = TM.loss_fn(params, port_cfg(CFG), b)
    close(loss, ref["loss"])
    assert metrics["loss"] is loss


def test_gradients_match(ref):
    got = port_grads(carried(ref), tbatch(ref["batch"]))
    assert set(got) == set(ref["grads"])
    for k, g in ref["grads"].items():
        close(got[k], g, rtol=0.0, atol_of_max=GRAD_OF_MAX)


@pytest.mark.parametrize("dropped", [(0,), (1, 2, 3)], ids=["routing-init", "routing-update"])
def test_gradients_need_each_detach(ref, monkeypatch, dropped):
    """``interests`` calls ``eh.detach()`` once for the routing logits'
    start and once an iteration in their update; without either set the
    gradients leave the reference's."""
    params, b = carried(ref), tbatch(ref["batch"])
    real = torch.Tensor.detach
    calls = itertools.count()

    def leaky(self):
        return self if next(calls) in dropped else real(self)

    monkeypatch.setattr(torch.Tensor, "detach", leaky)
    got = port_grads(params, b)
    monkeypatch.undo()
    assert next(calls) == 1 + CFG.capsule_iters
    assert not grads_close(got, ref["grads"])
    assert grads_close(port_grads(params, b), ref["grads"])


def test_train_steps(ref):
    cfg = port_cfg(CFG)
    params = carried(ref)
    opt, step, b = adamw_init(params), TCM.make_train_step(cfg), tbatch(ref["batch"])
    losses = []
    for _ in range(STEPS):
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, ref["losses"], rtol=RTOL)
    assert int(opt.step) == STEPS
    for k, want in ref["trained"].items():
        np.testing.assert_allclose(params[k].numpy(), want, rtol=RTOL, atol=2 * LR * STEPS)


def test_serve_scores(ref):
    cfg = port_cfg(CFG)
    hist = ref["batch"]["hist"]
    cands = np.random.default_rng(5).integers(0, CFG.n_items, 64).astype(np.int32)
    want = np.asarray(JM.serve_scores(ref["params"], CFG, jnp.asarray(hist), jnp.asarray(cands)))
    got = TM.serve_scores(carried(ref), cfg, torch.from_numpy(hist), torch.from_numpy(cands))
    assert got.shape == want.shape
    assert (np.abs(got.numpy() - want) <= 1e-5 * np.abs(want).max(1, keepdims=True)).all()


def test_retrieval_ties_in_lax_top_k_order(ref):
    """A slate that repeats candidates scores the copies bitwise equal in
    both packages; the top k order them by slate index, as lax.top_k."""
    cfg = port_cfg(CFG)
    rng = np.random.default_rng(6)
    base = rng.integers(0, CFG.n_items, 40).astype(np.int32)
    slate = np.concatenate([base, base[::-1], base[:10]])
    hist = ref["batch"]["hist"][:3]
    jvals, jids = JM.retrieval(ref["params"], CFG, jnp.asarray(hist), jnp.asarray(slate), 30)
    jscores = np.asarray(JM.serve_scores(ref["params"], CFG, jnp.asarray(hist),
                                         jnp.asarray(slate)))
    params = carried(ref)
    tscores = TM.serve_scores(params, cfg, torch.from_numpy(hist), torch.from_numpy(slate))
    for s in (jscores, tscores.numpy()):
        first = {int(c): s[:, i] for i, c in reversed(list(enumerate(slate)))}
        assert all((s[:, i] == first[int(c)]).all() for i, c in enumerate(slate))
    tvals, tids = TM.retrieval(params, cfg, torch.from_numpy(hist), torch.from_numpy(slate), 30)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    close(tvals, jvals)
    # the stable descending sort against lax.top_k on exact ties
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 1.0, 2.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 5)
    tv, ti = TM.top_k_stable(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_retrieval_cell_masks_padding(ref):
    """The retrieval cell's step on a padded slate: the padding never
    enters the top k, and the rest is the reference cell's function."""
    cfg = port_cfg(CFG)
    n, n_pad = 450, 512
    slate = np.random.default_rng(7).integers(0, CFG.n_items, n_pad).astype(np.int32)
    hist = ref["batch"]["hist"][:1]
    got_v, got_i = TCM.retrieval_fn(cfg, n)(carried(ref), torch.from_numpy(hist),
                                            torch.from_numpy(slate))
    scores = np.array(JM.serve_scores(ref["params"], CFG, jnp.asarray(hist),
                                      jnp.asarray(slate)))
    scores[:, n:] = -np.inf
    jv, ji = jax.lax.top_k(jnp.asarray(scores), TCM.RETRIEVAL_K)
    np.testing.assert_array_equal(got_i.numpy(), slate[np.asarray(ji)])
    assert np.isneginf(got_v.numpy()[0, n:]).all() and np.isfinite(got_v.numpy()[0, :n]).all()


def test_smoke_batch_bitwise():
    key = jax.random.PRNGKey(0)
    cfg = JCM.SMOKE
    b = TCM.smoke_batch("cpu")
    np.testing.assert_array_equal(
        b["hist"].numpy(), np.asarray(jax.random.randint(key, (8, cfg.hist_len), 0, cfg.n_items)))
    np.testing.assert_array_equal(
        b["target"].numpy(), np.asarray(jax.random.randint(key, (8,), 1, cfg.n_items)))
    assert b["hist"].dtype == torch.int32
    out = TCM.mind_smoke("cpu")
    assert out["finite"] and np.isfinite(out["loss"])


def test_interests_differ_and_retrieval_ranks_target():
    """``tests/test_models.py``'s behaviour test on the port alone."""
    cfg = TM.MINDConfig(n_items=256, embed_dim=16, hist_len=8)
    p = TM.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    hist = torch.from_numpy(randint(prng_key(1), (16, 8), 1, 256))
    target = hist[:, -1]
    b = {"hist": hist, "target": target}
    opt, step = adamw_init(p), TCM.make_train_step(cfg, lr=1e-2)
    for _ in range(30):
        p, opt, _ = step(p, opt, b)
    scores = TM.serve_scores(p, cfg, hist, torch.arange(256))
    ranks = (scores > torch.gather(scores, 1, target[:, None].long())).sum(1)
    assert float(ranks.float().mean()) < 64, float(ranks.float().mean())
    u = TM.interests(p, cfg, hist)
    assert u.shape == (16, cfg.n_interests, cfg.embed_dim)
    assert float((u[:, 0] - u[:, 1]).abs().max()) > 1e-3
