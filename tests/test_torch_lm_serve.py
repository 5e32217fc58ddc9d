"""The port's slot server (``repro_torch.launch.serve``) against the JAX
package's ``launch/serve.py``.

* The counterparts of ``tests/test_serving.py``'s four tests: scheduler ≡
  isolated greedy decoding, rejection of a prompt that cannot fit, the
  clamp of ``max_new``, and one ``_prefill`` call per admitted prompt.
* Both servers on the same ragged requests with carried weights: equal
  tokens, equal rejections, equal clamps (and their warnings).
* ``python -m repro_torch.launch.serve --device cpu`` exits 0.
"""

import dataclasses
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import deepseek_moe_16b, h2o_danube3_4b, qwen3_moe_235b  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.launch.serve import Request, Server  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _cfg():
    return T.LMConfig(name="t", n_layers=2, d_model=48, n_heads=4,
                      n_kv_heads=2, d_ff=96, vocab_size=128, dtype="float32")


def _server(cfg, **kw):
    return Server(cfg, device="cpu", **kw)


def _reference_greedy(cfg, params, prompt, max_new):
    """Isolated single-sequence greedy decode."""
    dec = T.make_decode(cfg)
    cache = T.init_cache(cfg, 1, 64, device="cpu")
    logits = None
    for i, t in enumerate(prompt):
        logits, cache = dec(params, cache, torch.tensor([[t]], dtype=torch.int32), i)
    out = []
    pos = len(prompt)
    for _ in range(max_new):
        nxt = int(torch.argmax(logits[0, 0]))
        out.append(nxt)
        logits, cache = dec(params, cache, torch.tensor([[nxt]], dtype=torch.int32), pos)
        pos += 1
    return out


def test_scheduler_matches_isolated_decoding():
    cfg = _cfg()
    server = _server(cfg, max_batch=2, max_seq=64, seed=3)
    rng = np.random.default_rng(0)
    # ragged prompts, more requests than slots → slot reuse after completion
    prompts = [list(rng.integers(1, 128, n)) for n in (3, 5, 2, 4)]
    reqs = [Request(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)]
    done = server.serve(reqs)
    assert len(done) == 4
    for r in done:
        ref = _reference_greedy(cfg, server.params, r.prompt, r.max_new)
        assert r.out == ref, (r.rid, r.out, ref)


def test_admit_rejects_prompt_overflowing_cache():
    cfg = _cfg()
    server = _server(cfg, max_batch=2, max_seq=8, seed=1)
    rng = np.random.default_rng(2)
    bad = Request(rid=0, prompt=list(rng.integers(1, 128, 8)), max_new=4)
    assert server.admit(bad) is False
    assert bad.done and bad.reject_reason is not None
    assert bad.slot == -1 and bad.out == []
    assert len(server.free_slots) == server.max_batch
    good = Request(rid=1, prompt=list(rng.integers(1, 128, 3)), max_new=4)
    bad2 = Request(rid=2, prompt=list(rng.integers(1, 128, 9)), max_new=1)
    done = server.serve([good, bad2])
    assert good in done and bad2 in done
    assert bad2.reject_reason is not None and bad2.out == []
    assert good.reject_reason is None and len(good.out) == 4
    assert good.out == _reference_greedy(cfg, server.params, good.prompt, good.max_new)


def test_admit_clamps_max_new_to_cache_room():
    cfg = _cfg()
    server = _server(cfg, max_batch=1, max_seq=10, seed=2)
    rng = np.random.default_rng(5)
    req = Request(rid=0, prompt=list(rng.integers(1, 128, 4)), max_new=50)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        done = server.serve([req])
    assert any("clamped" in str(w.message) for w in caught)
    (r,) = done
    assert r.reject_reason is None
    assert r.max_new == 6 and len(r.out) == 6  # max_seq - len(prompt)
    assert r.out == _reference_greedy(cfg, server.params, r.prompt, 6)


def test_prefill_is_single_dispatch(monkeypatch):
    cfg = _cfg()
    server = _server(cfg, max_batch=2, max_seq=64, seed=3)
    calls = {"prefill": 0, "decode": 0}
    real_prefill, real_decode = server._prefill, server._decode

    def counting_prefill(*a, **k):
        calls["prefill"] += 1
        return real_prefill(*a, **k)

    def counting_decode(*a, **k):
        calls["decode"] += 1
        return real_decode(*a, **k)

    monkeypatch.setattr(server, "_prefill", counting_prefill)
    monkeypatch.setattr(server, "_decode", counting_decode)
    rng = np.random.default_rng(9)
    prompt = list(rng.integers(1, 128, 7))
    req = Request(rid=0, prompt=prompt, max_new=3)
    assert server.admit(req)
    assert calls == {"prefill": 1, "decode": 0}
    while not req.done:
        server.tick()
    assert calls["decode"] == req.max_new  # one batched step per new token
    assert req.out == _reference_greedy(cfg, server.params, prompt, req.max_new)
    req1 = Request(rid=1, prompt=[5], max_new=2)
    assert server.admit(req1)
    assert calls["prefill"] == 1


def _jax_cfg(cfg):
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return JT.LMConfig(**d)


# (JAX config, max_batch, max_seq): the toy, and three SMOKE configs
# (GQA with a window; MoE with shared experts; MoE with qk-norm)
PAIRS = {"toy": (_jax_cfg(_cfg()), 2, 24),
         "danube": (h2o_danube3_4b.SMOKE, 3, 24),
         "deepseek_moe": (deepseek_moe_16b.SMOKE, 4, 24),
         "qwen3_moe": (qwen3_moe_235b.SMOKE, 2, 24)}


def _requests(vocab, max_seq):
    """Ragged prompts, one too long (rejected), one clamped, one single
    token; more requests than slots."""
    rng = np.random.default_rng(11)
    lens = (3, 7, max_seq, 1, 5, max_seq - 4, 2)
    news = (6, 4, 2, 5, 3, 9, 4)
    return [(i, [int(t) for t in rng.integers(1, vocab, n)], m)
            for i, (n, m) in enumerate(zip(lens, news))]


def _run(server, req_cls, reqs):
    rs = [req_cls(rid=i, prompt=list(p), max_new=m) for i, p, m in reqs]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        done = server.serve(rs)
    return ([(r.rid, r.out, r.max_new, r.reject_reason, r.done) for r in done],
            sorted(str(w.message) for w in caught))


@pytest.mark.parametrize("name", list(PAIRS))
def test_port_server_serves_jax_servers_tokens(name):
    jcfg, nb, max_seq = PAIRS[name]
    jp = JT.init(jax.random.PRNGKey(7), jcfg)
    d = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    if d["moe"] is not None:
        d["moe"] = TL.MoEConfig(**dataclasses.asdict(d["moe"]))
    tp = T.params_from_numpy(jax.device_get(jp), device="cpu")
    reqs = _requests(jcfg.vocab_size, max_seq)
    want = _run(JS.Server(jcfg, params=jp, max_batch=nb, max_seq=max_seq), JS.Request, reqs)
    got = _run(Server(T.LMConfig(**d), params=tp, max_batch=nb, max_seq=max_seq,
                      device="cpu"), Request, reqs)
    assert got == want
    outs, msgs = got
    assert sum(r[3] is not None for r in outs) == 1 and any("clamped" in m for m in msgs)


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
                          "--requests", "3", "--max-new", "4"],
                         env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "SERVE_OK" in res.stdout and res.stdout.count("req ") == 3
