"""The port's ``CheckpointManager`` and ``restore_resharded`` against the
JAX package's ``repro.checkpoint``: snapshots written by either package
open in the other with the same keys, bitwise (bfloat16 leaves and an
``AdamWState`` included), and the manager's rotation, asynchronous saves
and restores behave as the reference's (``tests/test_substrates.py``).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as JC  # noqa: E402
from repro.optim import AdamWState as JAdamWState  # noqa: E402
from repro_torch import checkpoint as TC  # noqa: E402
from repro_torch.optim import AdamWState  # noqa: E402


def _np_tree(seed):
    r = np.random.default_rng(seed)
    return {"a": r.normal(size=(2, 3)).astype(np.float32),
            "b": {"c": r.integers(-5, 5, (4,)).astype(np.int32),
                  "h": r.normal(size=(3, 5)).astype(np.float32)},
            "s": np.float32(r.normal())}


def _port_state(seed, bf16=True):
    t = _np_tree(seed)
    params = {"a": torch.from_numpy(t["a"]),
              "b": {"c": torch.from_numpy(t["b"]["c"]),
                    "h": torch.from_numpy(t["b"]["h"]).to(
                        torch.bfloat16 if bf16 else torch.float32)},
              "s": torch.tensor(t["s"])}
    zeros = {"a": torch.zeros(2, 3), "h": torch.ones(3, 5)}
    opt = AdamWState(step=torch.tensor(7, dtype=torch.int32), mu=zeros,
                     nu={k: v * 2 for k, v in zeros.items()})
    return {"params": params, "opt": opt}


def _jax_state(seed, bf16=True):
    t = _np_tree(seed)
    params = {"a": jnp.asarray(t["a"]),
              "b": {"c": jnp.asarray(t["b"]["c"]),
                    "h": jnp.asarray(t["b"]["h"], jnp.bfloat16 if bf16 else jnp.float32)},
              "s": jnp.asarray(t["s"])}
    zeros = {"a": jnp.zeros((2, 3)), "h": jnp.ones((3, 5))}
    opt = JAdamWState(step=jnp.asarray(7, jnp.int32), mu=zeros,
                      nu=jax.tree.map(lambda x: x * 2, zeros))
    return {"params": params, "opt": opt}


def _bits(a):
    """A host array's bytes (bfloat16 and ``V2`` as 16-bit patterns)."""
    a = np.atleast_1d(np.asarray(a))
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a.view(np.uint8)


def _port_bits(t):
    if t.dtype == torch.bfloat16:
        return np.atleast_1d(t.view(torch.int16).numpy()).view(np.uint16)
    return _bits(t.numpy())


def _jax_paths(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_keys_match_reference():
    """An ``AdamWState`` flattens to the reference's keys (``opt/step``,
    ``opt/mu/...``, ``opt/nu/...``, dataclass fields in order)."""
    want = sorted(_jax_paths(_jax_state(0)))
    assert sorted(TC.manager._paths(_port_state(0))) == want
    assert "opt/step" in want and "opt/mu/a" in want and "params/b/h" in want


@pytest.mark.parametrize("bf16", [True, False])
def test_port_snapshot_opens_in_reference(tmp_path, bf16):
    d = str(tmp_path)
    state = _port_state(1, bf16)
    TC.CheckpointManager(d).save(state, 5, metadata={"loss": 1.5})
    loaded, step = JC.load_pytree(_jax_state(1, bf16), d)
    assert step == 5
    got = _jax_paths(loaded)
    for key, leaf in TC.manager._paths(state).items():
        assert np.asarray(got[key]).shape == tuple(leaf.shape), key
        np.testing.assert_array_equal(_bits(got[key]), _port_bits(leaf), err_msg=key)
    if bf16:
        assert np.asarray(got["params/b/h"]).dtype.kind == "V"
    with open(os.path.join(d, "manifest.json")) as f:
        assert json.load(f)["metadata"] == {"loss": 1.5}


@pytest.mark.parametrize("bf16", [True, False])
def test_reference_snapshot_opens_in_port(tmp_path, bf16):
    d = str(tmp_path)
    jstate = _jax_state(2, bf16)
    JC.CheckpointManager(d).save(jstate, 9)
    restored, step = TC.restore_resharded(_port_state(0, bf16), d, "cpu")
    assert step == 9 and isinstance(restored["opt"], AdamWState)
    assert restored["opt"].step.dtype == torch.int32 and int(restored["opt"].step) == 7
    assert restored["params"]["b"]["h"].dtype == (torch.bfloat16 if bf16 else torch.float32)
    paths = TC.manager._paths(restored)
    for key, leaf in _jax_paths(jstate).items():
        np.testing.assert_array_equal(_port_bits(paths[key]), _bits(jax.device_get(leaf)),
                                      err_msg=key)
    host, _ = TC.CheckpointManager(d).restore(_port_state(0, bf16))
    assert isinstance(host["params"]["a"], np.ndarray)


def test_round_trip_in_the_port(tmp_path):
    d = str(tmp_path)
    state = _port_state(3)
    m = TC.CheckpointManager(d)
    m.save(state, 2, blocking=False)
    restored, step = m.restore_resharded(_port_state(0), "cpu")
    assert step == 2 and m.latest_step() == 2
    for key, leaf in TC.manager._paths(state).items():
        got = TC.manager._paths(restored)[key]
        assert got.dtype == leaf.dtype and torch.equal(got, leaf), key


def test_async_save_snapshots_before_returning(tmp_path):
    """``save`` copies the state before it returns: an in-place update
    right after an asynchronous save does not reach the snapshot."""
    d = str(tmp_path)
    state = _port_state(4)
    want = state["params"]["a"].clone()
    m = TC.CheckpointManager(d)
    m.save(state, 1, blocking=False)
    state["params"]["a"].add_(100.0)
    state["opt"].step.add_(1)
    m.wait()
    host, _ = m.restore(_port_state(0))
    np.testing.assert_array_equal(host["params"]["a"], want.numpy())
    assert int(host["opt"].step) == 7


def _tree():
    return {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4, dtype=torch.int32)}}


def test_manager_rotation_and_async(tmp_path):
    """``tests/test_substrates.py::test_manager_rotation_and_async`` on the port."""
    m = TC.CheckpointManager(str(tmp_path), keep_last=2)
    for s in (1, 2, 3, 4):
        m.save(_tree(), s, blocking=(s % 2 == 0))
    m.wait()
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert len(files) == 2 and files[-1] == "step_0000000004.npz"
    _, step = m.restore(_tree())
    assert step == 4


def test_rotation_sweeps_stale_tmp_and_restores_a_step(tmp_path):
    d = str(tmp_path)
    open(os.path.join(d, "step_0000000001.npz.tmp"), "wb").close()
    m = TC.CheckpointManager(d, keep_last=3)
    for s in (1, 2, 3):
        t = _tree()
        t["a"] += s
        m.save(t, s)
    assert not any(f.endswith(".tmp") for f in os.listdir(d))
    host, step = m.restore(_tree(), step=2)
    assert step == 2 and float(host["a"][0, 0]) == 2.0


def test_structure_mismatch_raises(tmp_path):
    d = str(tmp_path)
    TC.CheckpointManager(d).save(_tree(), 1)
    with pytest.raises(ValueError, match="structure mismatch"):
        TC.restore_resharded({"a": torch.zeros(2, 3)}, d, "cpu")
    with pytest.raises(FileNotFoundError):
        TC.CheckpointManager(str(tmp_path / "empty")).restore(_tree())


def test_restore_resharded_needs_a_card_unless_given_a_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    d = str(tmp_path)
    TC.CheckpointManager(d).save(_tree(), 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TC.restore_resharded(_tree(), d)
