"""The port's ``data.TokenPipeline`` against the JAX package's: the same
batches for the same (seed, step, shape), with no jax in the port.

``jax.random``'s ``PRNGKey``, ``fold_in`` and ``uniform`` rebuilt in numpy
(threefry-2x32 in jax's partitionable counter layout, the installed jax's
mode) give the reference's uniforms bitwise, and ``exp_f32`` (XLA's CPU
f32 exp) gives its tokens exactly, at the tests' vocabularies and at the
LM configs' (32,000 and 102,400), where a correctly rounded exp would
move about 3e-5 of the tokens across an integer.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import TokenPipeline as JPipe  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.data import pipeline as P  # noqa: E402

CASES = [  # seed, step, global_batch, seq_len, vocab
    (0, 0, 4, 16, 64), (0, 5, 4, 16, 64), (3, 7, 2, 33, 512), (7, 1, 1, 255, 512),
    (11, 123456, 3, 100, 32000), (0, 12, 8, 4096, 32000), (2, 2**31 + 3, 2, 64, 102400),
    (2**33 + 5, 9, 1, 10, 100), (-3, 4, 2, 8, 50),
]


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5), (7, 2**32 - 1), (123456789, 17)])
def test_key_and_fold_in_match_jax(seed, step):
    key = jax.random.PRNGKey(seed)
    assert P.prng_key(seed) == tuple(int(k) for k in np.asarray(key))
    want = np.asarray(jax.random.fold_in(key, step))
    assert P.fold_in(P.prng_key(seed), step) == tuple(int(k) for k in want)


@pytest.mark.parametrize("shape", [(1,), (7,), (2, 3), (4, 17), (3, 5, 11)])
def test_uniform_bitwise(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(4), 9)
    want = np.asarray(jax.random.uniform(key, shape))
    got = P.uniform(tuple(int(k) for k in np.asarray(key)), shape)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_exp_f32_matches_xla():
    x = np.concatenate([np.linspace(0.0, np.log(np.float32(102400)), 200_001),
                        np.random.default_rng(0).uniform(-20, 20, 100_000)]).astype(np.float32)
    want = np.asarray(jnp.exp(jnp.asarray(x)))
    np.testing.assert_array_equal(P.exp_f32(x).view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed,step,batch,seq,vocab", CASES)
def test_token_batches_equal_reference(seed, step, batch, seq, vocab):
    ref = JPipe(vocab, seq, batch, seed)
    got = TokenPipeline(vocab, seq, batch, seed)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    u = np.asarray(jax.random.uniform(key, (batch, seq + 1)))
    np.testing.assert_array_equal(got.uniforms(step).view(np.uint32), u.view(np.uint32))
    want, b = ref.batch(step), got.batch(step)
    for k in ("tokens", "labels"):
        assert b[k].dtype == torch.int32 and tuple(b[k].shape) == (batch, seq)
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < vocab


def test_batches_are_a_function_of_seed_and_step():
    p = TokenPipeline(512, 32, 4, seed=1)
    a, b = p.batch(3), TokenPipeline(512, 32, 4, seed=1).batch(3)
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["tokens"], p.batch(4)["tokens"])
    assert not torch.equal(a["tokens"], TokenPipeline(512, 32, 4, seed=2).batch(3)["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])


def test_specs_match_reference():
    want = JPipe(64, 16, 4).specs()
    got = TokenPipeline(64, 16, 4).specs()
    for k in ("tokens", "labels"):
        assert got[k].device.type == "meta" and got[k].dtype == torch.int32
        assert tuple(got[k].shape) == want[k].shape
