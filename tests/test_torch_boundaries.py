"""Package boundaries of the torch port.

* The port imports neither JAX nor the JAX package (``repro``): checked in
  a fresh interpreter that imports every module of ``repro_torch``, and
  by an AST scan of its sources and of ``chip_smoke.py``.
* Without a CUDA device, an entry point called without ``device=``
  raises instead of carrying on on the CPU.
"""

import ast
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_port_imports_no_jax():
    mods = list(_modules())
    assert "repro_torch.kernels.graph_ops.ops" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [SMOKE],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), (path, name)


def test_entry_points_need_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch import default_device, from_coo
    from repro_torch.core.graph import from_arrays

    src, dst = np.array([0, 1]), np.array([1, 2])
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        from_coo(src, dst, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_arrays({}, n=3, m=2, n_pad=512, m_pad=512, block_size=512)
    g = from_coo(src, dst, 3, device="cpu")
    assert g.device.type == "cpu"

    # the LM serving path: the server, the model's init and its cache
    from repro_torch.configs import h2o_danube3_4b
    from repro_torch.launch.serve import Server
    from repro_torch.models import transformer as T

    cfg = h2o_danube3_4b.SMOKE
    with pytest.raises(RuntimeError, match="CUDA"):
        Server(cfg, max_batch=1, max_seq=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_cache(cfg, 1, 8)
    assert Server(cfg, max_batch=1, max_seq=8, device="cpu").cache["k"].device.type == "cpu"

    # the LM training path: the trainer, the checkpoint restore, a carried
    # optimizer state
    from repro_torch.checkpoint import CheckpointManager, restore_resharded
    from repro_torch.launch.train import Trainer, TrainerConfig
    from repro_torch.optim import AdamWState, adamw_state_from_numpy

    tcfg = TrainerConfig(model=cfg, global_batch=1, seq_len=8, steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        adamw_state_from_numpy(AdamWState(step=np.int32(0), mu={}, nu={}))
    tr = Trainer(tcfg, device="cpu")
    assert tr.params["embed"].device.type == "cpu" and tr.opt.step.device.type == "cpu"
    with tempfile.TemporaryDirectory() as d:
        CheckpointManager(d).save({"w": torch.ones(2)}, 1)
        with pytest.raises(RuntimeError, match="CUDA"):
            restore_resharded({"w": torch.ones(2)}, d)
        assert restore_resharded({"w": torch.ones(2)}, d, "cpu")[0]["w"].device.type == "cpu"

    # the GNN stack: the step on a molecule batch, the models' and MLPs'
    # inits, carried parameters, the host batch builder; the sampler and
    # the seed pipeline take no device: the sampler runs on its CSR's
    # device and the pipeline's seeds are host tensors
    from repro_torch.configs import gcn_cora, gnn_common, mace
    from repro_torch.data import GraphBatchPipeline
    from repro_torch.graphs.sampler import sample_blocks
    from repro_torch.models.gnn import common as gnn, gcn
    from repro_torch.models.gnn import mace as mace_model

    with pytest.raises(RuntimeError, match="CUDA"):
        gnn_common.gnn_smoke(gcn, gcn_cora.SMOKE)
    with pytest.raises(RuntimeError, match="CUDA"):
        gcn.init(torch.Generator().manual_seed(0), gcn_cora.SMOKE)
    with pytest.raises(RuntimeError, match="CUDA"):
        mace_model.init(torch.Generator().manual_seed(0), mace.SMOKE)
    with pytest.raises(RuntimeError, match="CUDA"):
        gnn.mlp_init(torch.Generator().manual_seed(0), [2, 3])
    with pytest.raises(RuntimeError, match="CUDA"):
        gnn.params_from_numpy({"w": np.ones(2)})
    mol = (np.zeros((1, 2, 3)), np.zeros((1, 2, 3)), np.zeros((1, 1), int), np.zeros((1, 1), int),
           np.zeros(1))
    with pytest.raises(RuntimeError, match="CUDA"):
        gnn.flatten_molecules(*mol)
    assert gnn.flatten_molecules(*mol, device="cpu").src.device.type == "cpu"
    assert gnn_common.gnn_smoke(gcn, gcn_cora.SMOKE, device="cpu")["finite"]
    seeds = GraphBatchPipeline(3, 4).batch(0)
    assert seeds.device.type == "cpu"
    assert sample_blocks(g, seeds, (0, 1), (2,)).layers[0].device.type == "cpu"


def test_model_registry_entry_points_need_a_card_unless_asked():
    """MIND and the registry's smoke steps default to the card; the dry run's
    cells are meta tensors and need no device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.configs import get_arch, make_dryrun_cell
    from repro_torch.configs import mind as mind_cfg
    from repro_torch.configs.lm_common import lm_smoke
    from repro_torch.configs import h2o_danube3_4b
    from repro_torch.models.recsys import mind

    with pytest.raises(RuntimeError, match="CUDA"):
        mind.init(torch.Generator().manual_seed(0), mind_cfg.SMOKE)
    with pytest.raises(RuntimeError, match="CUDA"):
        mind.params_from_numpy({"embed": np.zeros((2, 2), np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        mind_cfg.mind_smoke()
    with pytest.raises(RuntimeError, match="CUDA"):
        mind_cfg.smoke_batch()
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_smoke(h2o_danube3_4b.SMOKE)
    for arch in ("mind", "gcn-cora", "h2o-danube-3-4b"):
        with pytest.raises(RuntimeError, match="CUDA"):
            get_arch(arch).smoke_step()
    assert mind_cfg.mind_smoke("cpu")["finite"]
    cell = make_dryrun_cell("mind", "serve_p99")
    assert {t.device.type for t in cell.arg_specs[0].values()} == {"meta"}


@pytest.mark.parametrize("module, argv", [
    ("repro_torch.examples.quickstart", []),
    ("repro_torch.examples.paper_suite", ["--no-verify"]),
    ("repro_torch.examples.serve_lm", ["--requests", "1"]),
    ("repro_torch.examples.train_lm", ["--tiny", "--steps", "1"]),
    ("repro_torch.benchmarks.run", ["--suite", "roofline"]),
], ids=["quickstart", "paper_suite", "serve_lm", "train_lm", "harness"])
def test_examples_and_harness_need_a_card_unless_asked(module, argv, tmp_path, monkeypatch):
    """Each example and the harness raise without a card unless given
    ``--device cpu`` (``test_torch_examples.py`` and ``test_torch_harness.py``
    run them with it); the harness checks before its first suite, so even
    ``roofline``, which touches no device, is refused."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    import importlib

    monkeypatch.chdir(tmp_path)
    main = importlib.import_module(module).main
    if module.endswith("train_lm"):
        argv = argv + ["--ckpt", str(tmp_path / "ck")]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
    assert not (tmp_path / "ck").exists()
