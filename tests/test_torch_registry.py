"""The port's architecture registry (``configs/registry.py`` and the ten
config modules that register into it) against the JAX package's: the 40
(arch, shape) cells in the reference's order; each cell's arguments as
meta tensors, leaf for leaf the reference's ``ShapeDtypeStruct``s in
shape and dtype; its in/out specs and donations entry for entry in tree
order; the LM sharding rules for all five configs; every smoke step
finite on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.distributed.mesh_utils import P  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

REF_CELLS = JR.list_cells()
LM_MODULES = ("h2o_danube3_4b", "stablelm_3b", "glm4_9b", "deepseek_moe_16b", "qwen3_moe_235b")


def jspecs(tree):
    return [tuple(s) for s in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP))]


def tspecs(tree):
    leaves = TR.leaves(tree)
    assert all(isinstance(s, P) for s in leaves), leaves
    return [tuple(s) for s in leaves]


def test_list_cells_is_the_reference():
    assert len(REF_CELLS) == 40
    assert TR.list_cells() == REF_CELLS
    assert sorted(TR.ARCHS) == sorted(JR.ARCHS)
    for a, spec in TR.ARCHS.items():
        ref = JR.ARCHS[a]
        assert (spec.family, spec.shapes) == (ref.family, ref.shapes), a


@pytest.mark.parametrize("arch,shape", REF_CELLS, ids=[f"{a}-{s}" for a, s in REF_CELLS])
def test_cell_matches_reference(arch, shape):
    got = TR.make_dryrun_cell(arch, shape)
    want = JR.make_dryrun_cell(arch, shape)
    assert (got.arch, got.shape, got.kind, got.donate, got.note) == \
        (want.arch, want.shape, want.kind, want.donate, want.note)
    assert len(got.arg_specs) == len(want.arg_specs) == len(got.in_specs)
    for i, (g, w) in enumerate(zip(got.arg_specs, want.arg_specs)):
        gl, wl = TR.leaves(g), jax.tree.leaves(w)
        assert len(gl) == len(wl), (i, len(gl), len(wl))
        for t, s in zip(gl, wl):
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(s.shape), (i, t.shape, s.shape)
            assert str(t.dtype).removeprefix("torch.") == np.dtype(s.dtype).name, (i, t.dtype)
    assert [tspecs(s) for s in got.in_specs] == [jspecs(s) for s in want.in_specs]
    assert tspecs(got.out_specs) == jspecs(want.out_specs)


@pytest.mark.parametrize("mod", LM_MODULES)
def test_lm_sharding_rules(mod):
    import importlib

    tcfg = importlib.import_module(f"repro_torch.configs.{mod}").FULL
    jcfg = importlib.import_module(f"repro.configs.{mod}").FULL
    for fsdp in (True, False):
        assert tspecs(TT.param_specs(tcfg, fsdp)) == jspecs(JT.param_specs(jcfg, fsdp))
    assert tspecs(TT.param_specs_serve(tcfg)) == jspecs(JT.param_specs_serve(jcfg))
    for axes, seq in ((("pod", "data"), "model"), (None, ("data", "model"))):
        assert tspecs(TT.cache_pspec(axes, seq)) == jspecs(JT.cache_pspec(axes, seq))
    got, want = TT.cache_specs(tcfg, 2, 64), JT.cache_specs(jcfg, 2, 64)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in got.items()} == \
        {k: (tuple(v.shape), "torch." + np.dtype(v.dtype).name) for k, v in want.items()}


@pytest.mark.parametrize("arch", sorted({a for a, _ in REF_CELLS}))
def test_smoke_step_finite(arch):
    out = TR.get_arch(arch).smoke_step(device="cpu")
    assert out["finite"] and np.isfinite(out["loss"]), out


def test_lm_smoke_tokens_bitwise():
    from repro.configs import h2o_danube3_4b as JD
    from repro_torch.configs import h2o_danube3_4b as TD
    from repro_torch.configs.lm_common import smoke_tokens

    key = jax.random.PRNGKey(0)
    want = jax.random.randint(key, (2, 16), 0, JD.SMOKE.vocab_size)
    np.testing.assert_array_equal(smoke_tokens(TD.SMOKE), np.asarray(want))
