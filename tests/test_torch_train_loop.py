"""The port's ``launch.train`` (``Trainer``) against the JAX package's:
the reference's three trainer tests (``tests/test_train_loop.py``) run on
the port, the port's trajectory from the reference's initial weights
against the reference's, and checkpoints that resume across packages.

The config is the reference test's MoE model.  Tolerances: a resumed
run's final loss within rtol 1e-5 of the uninterrupted run's (the
reference test's; on the CPU the port's are bitwise equal); the port
against the reference after 6 steps: loss rtol 1e-5, parameters rtol 1e-4
plus 2·lr a step; a run resumed from the other package's checkpoint
within rtol 1e-4.
"""

import dataclasses
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.launch import train as JTR  # noqa: E402
from repro.models.layers import MoEConfig as JMoE  # noqa: E402
from repro.models.transformer import LMConfig as JLM  # noqa: E402
from repro_torch.launch import train as TTR  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

RESUME_RTOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-4
CROSS_RTOL = 1e-4


def jax_cfg(steps, ckpt_dir=None, compress=False):
    model = JLM(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                vocab_size=64, dtype="float32", remat=False,
                moe=JMoE(n_experts=4, top_k=2, d_expert=32))
    return JTR.TrainerConfig(model=model, global_batch=4, seq_len=16, steps=steps,
                             ckpt_dir=ckpt_dir, ckpt_every=3, compress_grads=compress)


def port_cfg(steps, ckpt_dir=None, compress=False):
    j = jax_cfg(steps, ckpt_dir, compress)
    m = {f.name: getattr(j.model, f.name) for f in dataclasses.fields(j.model)}
    m["moe"] = TL.MoEConfig(**dataclasses.asdict(m["moe"]))
    d = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    return TTR.TrainerConfig(**dict(d, model=TT.LMConfig(**m)))


def host(params):
    return TT.tree_map(lambda t: t.detach().clone(), params)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's runs: its initial weights, its uninterrupted 6-step
    run (loss, params) with the snapshot its ``CheckpointManager`` wrote at
    step 3, and the compressed 6-step run's loss.  The trainer object is
    kept: its compiled step serves ``resume_reference``."""
    full = JTR.Trainer(jax_cfg(6))
    init = jax.device_get(full.params)
    d = str(tmp_path_factory.mktemp("jax_ck"))
    full.cfg.steps = 3
    full.run()
    JCheckpointManager(d).save({"params": full.params, "opt": full.opt}, 3)
    full.cfg.steps = 6
    loss = float(full.run()["loss"])
    comp = float(JTR.Trainer(jax_cfg(6, compress=True)).run()["loss"])
    return dict(init=init, loss=loss, params=jax.device_get(full.params), ckpt=d,
                comp_loss=comp, trainer=full)


def resume_reference(trainer, directory):
    """The reference trainer's auto-resume (``Trainer._build``'s last
    lines) from ``directory``, on an existing trainer; returns its final
    loss after running to its ``cfg.steps``."""
    param_sh, opt_sh, _ = trainer._shardings()
    state = {"params": trainer.params, "opt": trainer.opt}
    restored, step = JCheckpointManager(directory).restore_resharded(
        state, {"params": param_sh, "opt": opt_sh})
    trainer.params, trainer.opt, trainer.step_num = restored["params"], restored["opt"], step
    return step, float(trainer.run()["loss"])


def carried(ref):
    return TT.params_from_numpy(ref["init"], device="cpu")


# ---- the reference's three tests, on the port ------------------------------

def test_resume_matches_uninterrupted(tmp_path):
    """Crash-and-resume lands on the uninterrupted run's trajectory."""
    t_full = TTR.Trainer(port_cfg(6), device="cpu")
    m_full = t_full.run()
    d = str(tmp_path / "ck")
    TTR.Trainer(port_cfg(3, ckpt_dir=d), device="cpu").run()
    t_b = TTR.Trainer(port_cfg(6, ckpt_dir=d), device="cpu")   # auto-resumes from step 3
    assert t_b.step_num == 3 and int(t_b.opt.step) == 3
    m_b = t_b.run()
    np.testing.assert_allclose(float(m_full["loss"]), float(m_b["loss"]), rtol=RESUME_RTOL)
    assert torch.equal(m_full["loss"], m_b["loss"])
    TT.tree_map(lambda a, b: bool(torch.equal(a, b)) or pytest.fail("params differ"),
                t_full.params, t_b.params)


def test_compressed_grads_trains():
    t = TTR.Trainer(port_cfg(8, compress=True), device="cpu")
    m = t.run()
    assert np.isfinite(float(m["loss"]))
    assert t.comp_state.error["embed"].dtype == torch.float32
    assert float(t.comp_state.error["embed"].abs().max()) > 0


def test_loss_decreases(ref):
    """The reference's test, from the reference's weights: it compares the
    losses of two different batches (1 and 25), so its outcome follows the
    draws; the port's own seeded init (torch's generator, not threefry)
    draws other weights.  ``test_training_lowers_the_loss`` holds learning
    to one batch."""
    m1 = TTR.Trainer(port_cfg(1), device="cpu", params=carried(ref)).run()
    m25 = TTR.Trainer(port_cfg(25), device="cpu", params=carried(ref)).run()
    assert float(m25["loss"]) < float(m1["loss"])


def test_training_lowers_the_loss():
    """From the port's own init: after 24 steps the loss of batch 24 is
    below its loss at the initial weights."""
    t = TTR.Trainer(port_cfg(25), device="cpu")
    init = host(t.params)
    batch = t.pipeline.batch(24)
    before = float(TT.loss_fn(init, t.cfg.model, batch)[0])
    assert float(t.run()["loss"]) < before


# ---- the port against the reference ----------------------------------------

def _lr_sum(steps, peak=3e-4):
    return sum(peak * (s + 1) / 100 for s in range(steps))


def test_trajectory_matches_reference(ref):
    t = TTR.Trainer(port_cfg(6), device="cpu", params=carried(ref))
    m = t.run()
    np.testing.assert_allclose(float(m["loss"]), ref["loss"], rtol=LOSS_RTOL)
    for path, want in jax.tree_util.tree_flatten_with_path(ref["params"])[0]:
        got = t.params
        for p in path:
            got = got[p.key]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PARAM_RTOL,
                                   atol=2 * _lr_sum(6), err_msg=str(path))


def test_compressed_trajectory_matches_reference(ref):
    t = TTR.Trainer(port_cfg(6, compress=True), device="cpu", params=carried(ref))
    np.testing.assert_allclose(float(t.run()["loss"]), ref["comp_loss"], rtol=LOSS_RTOL)


def test_resumes_reference_checkpoint(ref, tmp_path):
    """The reference's snapshot at step 3, resumed by the port to step 6."""
    d = str(tmp_path / "ck")
    shutil.copytree(ref["ckpt"], d)
    t = TTR.Trainer(port_cfg(6, ckpt_dir=d), device="cpu")
    assert t.step_num == 3 and t.opt.step.dtype == torch.int32 and int(t.opt.step) == 3
    np.testing.assert_allclose(float(t.run()["loss"]), ref["loss"], rtol=CROSS_RTOL)
    assert t.ckpt.latest_step() == 6


def test_reference_resumes_port_checkpoint(ref, tmp_path):
    """The port's snapshot at step 3 (from the reference's weights),
    resumed by the reference's trainer to step 6."""
    d = str(tmp_path / "ck")
    TTR.Trainer(port_cfg(3, ckpt_dir=d), device="cpu", params=carried(ref)).run()
    step, loss = resume_reference(ref["trainer"], d)
    assert step == 3
    np.testing.assert_allclose(loss, ref["loss"], rtol=CROSS_RTOL)


# ---- the trainer's surface --------------------------------------------------

def test_checkpoint_cadence_and_metadata(tmp_path):
    d = str(tmp_path / "ck")
    t = TTR.Trainer(dataclasses.replace(port_cfg(7, ckpt_dir=d), ckpt_every=2), device="cpu")
    m = t.run()
    from repro_torch.checkpoint import load_pytree
    import json
    import os
    files = sorted(f for f in os.listdir(d) if f.endswith(".npz"))
    assert files == [f"step_{s:010d}.npz" for s in (4, 6, 7)]    # keep_last 3
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    assert man["step"] == 7 and man["metadata"]["loss"] == float(m["loss"])
    state, step = load_pytree({"params": t.params, "opt": t.opt}, d)
    assert step == 7 and int(state["opt"].step) == 7


def test_config_and_tiny_model_match_reference():
    j, t = JTR.tiny_model(), TTR.tiny_model()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert TTR.tiny_model(64).vocab_size == 64
    jf = [(f.name, f.default) for f in dataclasses.fields(JTR.TrainerConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(TTR.TrainerConfig)]
    assert tf == jf


def test_trainer_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTR.Trainer(port_cfg(1))


def test_cli(tmp_path, monkeypatch, capsys):
    d = str(tmp_path / "ck")
    monkeypatch.setattr(sys, "argv", ["train", "--steps", "2", "--batch", "2", "--seq", "16",
                                      "--ckpt", d, "--device", "cpu", "--compress-grads"])
    TTR.main()
    out = capsys.readouterr().out
    assert "[train] step 2 loss" in out and "FINAL loss=" in out
    from repro_torch.checkpoint import latest_step
    assert latest_step(d) == 2
