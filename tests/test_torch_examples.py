"""The port's example modules (``repro_torch.examples``) against the repo's
JAX example scripts (``examples/*.py``), each run in process on the CPU.

* quickstart: the printed lines are the JAX script's;
* paper_suite: ``run_input`` on one Table-3 graph passes every oracle
  check, with the JAX script's round counts and lines (times stripped);
* serve_lm: from the JAX example server's weights, the tokens are the JAX
  example's, line for line;
* train_lm: ``--tiny`` for 4 steps from the JAX trainer's initial weights,
  every step's loss within rtol 1e-5 of the JAX script's (the tolerance of
  ``tests/test_torch_train_loop.py``).
"""

import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro_torch.examples import paper_suite, quickstart, serve_lm, train_lm  # noqa: E402
from repro_torch.graphs import generators as tgen  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
TRAIN_STEPS = 4


def jax_example(name):
    """The JAX round's ``examples/<name>.py`` as a fresh module."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed(fn, *args, **kw):
    """(fn's result, the lines it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue().splitlines()


def test_quickstart_prints_the_jax_scripts_lines():
    _, want = printed(jax_example("quickstart").main)
    got, lines = printed(quickstart.main, ["--device", "cpu"])
    assert lines == got["lines"] == want
    assert got["bfs"][0].device.type == "cpu"


def strip_ms(lines):
    return [re.sub(r"\s+[0-9.]+ ms ", " ", line) for line in lines]


def test_paper_suite_run_input_passes_every_check_at_the_jax_rounds():
    name = "clueweb12"
    src, dst, n = tgen.table3_suite(0)[name]()
    _, want = printed(jax_example("paper_suite").run_input, name, src, dst, n)
    got, lines = printed(paper_suite.run_input, name, src, dst, n, device="cpu",
                         oracles=paper_suite.load_oracles())
    assert [r["ok"] for r in got] == [True] * 7
    want_rounds = [int(m) for m in re.findall(r"rounds=(\d+)", "\n".join(want))]
    assert [r["rounds"] for r in got] == want_rounds
    assert strip_ms(lines) == strip_ms(want)
    assert all("✓" in line for line in lines if "rounds=" in line)


def test_paper_suite_oracles_resolve_from_the_module_not_the_cwd(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert paper_suite.load_oracles().triangle_count(
        np.array([0, 1, 2, 1, 2, 0]), np.array([1, 2, 0, 0, 1, 2]), 3) == 1


def test_serve_lm_serves_the_jax_examples_tokens(monkeypatch):
    jmod = jax_example("serve_lm")
    held = {}

    class Recording(jmod.Server):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            held["params"] = jax.device_get(self.params)

    jmod.Server = Recording
    monkeypatch.setattr(sys, "argv", ["serve_lm.py"])
    _, want = printed(jmod.main)
    params = TT.params_from_numpy(held["params"], device="cpu")
    got, lines = printed(serve_lm.main, ["--device", "cpu"], params=params)
    assert lines == want
    assert want[-1] == "SERVE_LM_OK" and len(got["done"]) == 8


def test_train_lm_tiny_follows_the_jax_scripts_losses(tmp_path, monkeypatch):
    jmod = jax_example("train_lm")
    held = {"losses": []}

    class Recording(jmod.Trainer):
        def _build(self):
            super()._build()
            held["init"] = jax.device_get(self.params)
            step = self._step

            def logged(*state):
                out = step(*state)
                held["losses"].append(float(out[2]["loss"]))
                return out
            self._step = logged

    jmod.Trainer = Recording
    argv = ["--tiny", "--steps", str(TRAIN_STEPS)]
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *argv, "--ckpt", str(tmp_path / "jax")])
    _, want = printed(jmod.main)
    got, lines = printed(train_lm.main, [*argv, "--ckpt", str(tmp_path / "port"),
                                         "--device", "cpu"],
                         params=TT.params_from_numpy(held["init"], device="cpu"))
    assert len(got["losses"]) == len(held["losses"]) == TRAIN_STEPS
    np.testing.assert_allclose(got["losses"], held["losses"], rtol=LOSS_RTOL)
    assert lines[0] == want[0]                   # the parameter counts
    assert lines[-1].startswith("TRAIN_LM_OK loss=")
    assert got["trainer"].ckpt.latest_step() == TRAIN_STEPS

