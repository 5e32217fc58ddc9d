"""The port's GNN architectures (``models/gnn/{gcn,egnn,nequip,mace}.py``)
and training step (``configs/gnn_common.py``) against the JAX package's,
with the reference's parameters carried across and batches made with
numpy from a seed.

Each architecture's reference results (apply, loss and gradient, three
``make_train_step`` steps) are computed once per module by one jitted
call each and shared by the tests that read them.  Tolerances: outputs
and losses rtol 1e-5 (atol 1e-6 of the largest output); each gradient
leaf within 1e-4 of its largest |g|; after k AdamW steps the parameters
within rtol 1e-5 plus 2·lr·k (a near-zero gradient's sign may differ,
and AdamW then moves that weight by ±lr).  Equivariance is the port's
own: NequIP's and MACE's energies invariant under a rotation and a
translation to 1e-9 in float64, EGNN's coordinates rotating with the
frame.
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import gnn_common as JG  # noqa: E402
from repro.models.gnn import common as JC  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro_torch.configs import gnn_common as TG  # noqa: E402
from repro_torch.core.graph import from_coo  # noqa: E402
from repro_torch.data import GraphBatchPipeline  # noqa: E402
from repro_torch.models.gnn import common as TC  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

RTOL = 1e-5
ATOL_OF_MAX = 1e-6
GRAD_OF_MAX = 1e-4
LR = 1e-3          # make_train_step's rate
STEPS = 3
ARCHS = {"gcn": "gcn_cora", "egnn": "egnn", "nequip": "nequip", "mace": "mace"}


def mods(arch):
    cfg = ARCHS[arch]
    return (importlib.import_module(f"repro.models.gnn.{arch}"),
            importlib.import_module(f"repro_torch.models.gnn.{arch}"),
            importlib.import_module(f"repro.configs.{cfg}"),
            importlib.import_module(f"repro_torch.configs.{cfg}"))


def port_cfg(tmod, jcfg):
    cls = next(v for v in vars(tmod).values()
               if isinstance(v, type) and v.__name__ == type(jcfg).__name__)
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


def mol(seed, B=4, n=10, m=20, F=8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, n, F)).astype(np.float32),
            rng.normal(size=(B, n, 3)).astype(np.float32),
            rng.integers(0, n, (B, m)), rng.integers(0, n, (B, m)),
            rng.normal(size=(B,)).astype(np.float32))


def close(got, want, rtol=RTOL, atol_of_max=ATOL_OF_MAX):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_of_max * float(np.abs(want).max(initial=0.0)))


def paired(jtree, ttree):
    """(path, reference leaf, port leaf) over the reference tree's leaves."""
    for path, a in jax.tree_util.tree_flatten_with_path(jax.device_get(jtree))[0]:
        t = ttree
        for p in path:
            t = t[p.key if hasattr(p, "key") else p.idx]
        yield jax.tree_util.keystr(path), np.asarray(a), t.detach().numpy()


def params_within(jtree, ttree, atol):
    for path, a, t in paired(jtree, ttree):
        excess = float(np.max(np.abs(t - a) - RTOL * np.abs(a)))
        assert excess <= atol, (path, excess, atol)


@pytest.fixture(scope="module", params=list(ARCHS))
def ref(request):
    """The reference's apply, loss, gradient and STEPS train steps on the
    SMOKE config, each one jitted call; the port's carried parameters."""
    jmod, tmod, jc, tc = mods(request.param)
    cfg = jc.SMOKE
    arrays = mol(1)
    em = np.random.default_rng(2).random(arrays[2].shape) < 0.8
    jb = JC.flatten_molecules(*arrays, edge_mask=em)
    jp = jmod.init(jax.random.PRNGKey(0), cfg)

    def first(p, b):
        return jmod.apply(p, cfg, b), jax.value_and_grad(jmod.loss_fn, has_aux=True)(p, cfg, b)

    out, ((loss, _), grads) = jax.jit(first)(jp, jb)
    step = jax.jit(JG.make_train_step(jmod, cfg))
    p, opt, steps = jp, j_adamw_init(jp), []
    for _ in range(STEPS):
        p, opt, metrics = step(p, opt, jb)
        steps.append((float(metrics["loss"]), jax.device_get(p)))
    return dict(arch=request.param, tmod=tmod, cfg=tc.SMOKE, jcfg=cfg, jp=jax.device_get(jp),
                out=np.asarray(out), loss=float(loss), grads=jax.device_get(grads), steps=steps,
                batch=TC.flatten_molecules(*arrays, edge_mask=em, device="cpu"))


def carried(ref):
    return TC.params_from_numpy(ref["jp"], device="cpu")


def test_config_copies(ref):
    assert ref["cfg"] == port_cfg(ref["tmod"], ref["jcfg"])
    _, _, jc, tc = mods(ref["arch"])
    assert tc.BASE == port_cfg(ref["tmod"], jc.BASE)
    for shape, info in JG.GNN_SHAPE_TABLE.items():
        assert TG.GNN_SHAPE_TABLE[shape] == info
        assert tc.cfg_for_shape(shape, info) == port_cfg(ref["tmod"], jc.cfg_for_shape(shape, info))


def test_apply(ref):
    close(ref["tmod"].apply(carried(ref), ref["cfg"], ref["batch"]), ref["out"])


def test_loss_and_gradient(ref):
    params = carried(ref)
    (loss, metrics), grads = TG.value_and_grad(ref["tmod"].loss_fn, params, ref["cfg"],
                                               ref["batch"])
    assert abs(float(loss) - ref["loss"]) <= RTOL * abs(ref["loss"])
    assert float(metrics["loss"]) == float(loss)
    n = 0
    for path, a, g in paired(ref["grads"], grads):
        tol = GRAD_OF_MAX * max(float(np.abs(a).max()), 1e-12)
        assert float(np.abs(g - a).max()) <= tol, (path, float(np.abs(g - a).max()), tol)
        n += 1
    assert n == len(TC.leaves(params)) and not any(p.requires_grad for p in TC.leaves(params))


def test_train_steps(ref):
    params = carried(ref)
    opt = adamw_init(params)
    step = TG.make_train_step(ref["tmod"], ref["cfg"])
    for k, (jloss, jparams) in enumerate(ref["steps"], 1):
        params, opt, metrics = step(params, opt, ref["batch"])
        assert abs(float(metrics["loss"]) - jloss) <= RTOL * abs(jloss), (k, metrics, jloss)
        params_within(jparams, params, 2 * LR * k)
    assert int(opt.step) == STEPS


def test_gnn_smoke(ref):
    got = TG.gnn_smoke(ref["tmod"], ref["cfg"], device="cpu")
    assert got["finite"] and got["loss"] > 0


# ---------------------------------------------------------------------------
# the reference cells' steps
# ---------------------------------------------------------------------------

def cell_pair(arch, shape, info=None):
    jmod, tmod, jc, tc = mods(arch)
    info = info or JG.GNN_SHAPE_TABLE[shape]
    cell = JG.build_gnn_cell(arch, shape, jmod, jc.cfg_for_shape)
    jp = jmod.init(jax.random.PRNGKey(3), jc.cfg_for_shape(shape, info))
    tp = TC.params_from_numpy(jax.device_get(jp), device="cpu")
    fn, specs = TG.build_gnn_step(tmod, tc.cfg_for_shape(shape, info), info["kind"], info)
    return cell, jp, fn, tp, specs


def compare_step(cell, jp, fn, tp, args):
    jparams, jopt, jm = jax.jit(cell.fn)(jp, j_adamw_init(jp), *(jnp.asarray(a) for a in args))
    targs = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    tparams, topt, tm = fn(tp, adamw_init(tp), *targs)
    want = float(jm["loss"])
    assert np.isfinite(want) and abs(float(tm["loss"]) - want) <= RTOL * abs(want)
    params_within(jparams, tparams, 2 * LR)
    assert int(topt.step) == int(jopt.step) == 1


def test_full_step_at_cora_size():
    info = JG.GNN_SHAPE_TABLE["full_graph_sm"]
    cell, jp, fn, tp, specs = cell_pair("gcn", "full_graph_sm")
    N, M = JG._ru(info["n"]), JG._ru(info["m"])
    assert (N, M) == (3072, 10752) and tuple(specs[2].shape) == (N, info["d_feat"])
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(N, info["d_feat"])).astype(np.float32)
    pos = np.zeros((N, 3), np.float32)
    src = rng.integers(0, info["n"], M).astype(np.int32)
    dst = rng.integers(0, info["n"], M).astype(np.int32)
    src[info["m"]:] = dst[info["m"]:] = N - 1          # padding edges, masked
    labels = rng.integers(0, info["n_classes"], N).astype(np.int32)
    node_mask = np.arange(N) < info["n"]
    edge_mask = np.arange(M) < info["m"]
    compare_step(cell, jp, fn, tp, (feats, pos, src, dst, labels, node_mask, edge_mask))


def test_sampled_step_on_a_small_graph():
    info = JG.GNN_SHAPE_TABLE["minibatch_lg"]
    cell, jp, fn, tp, _ = cell_pair("gcn", "minibatch_lg")
    rng = np.random.default_rng(5)
    n, m = 400, 3_000
    src = np.minimum(rng.zipf(1.5, m) - 1, n - 1)
    src[src % 5 == 2] = 0           # some vertices without out-edges
    g = from_coo(src, rng.integers(0, n, m), n, device="cpu")
    feats = rng.normal(size=(g.n_pad, info["d_feat"])).astype(np.float32)
    labels = rng.integers(0, info["n_classes"], g.n_pad).astype(np.int32)
    seeds = GraphBatchPipeline(n, 48, 2).batch(1).numpy()
    key = np.asarray(jax.random.PRNGKey(6))
    args = (g.row_ptr.numpy(), g.col_idx.numpy(), g.out_deg.numpy(), feats, labels, seeds)
    jparams, jopt, jm = jax.jit(cell.fn)(jp, j_adamw_init(jp), *(jnp.asarray(a) for a in args),
                                         jnp.asarray(key))
    tparams, topt, tm = fn(tp, adamw_init(tp), *(torch.from_numpy(a) for a in args), key)
    want = float(jm["loss"])
    assert abs(float(tm["loss"]) - want) <= RTOL * abs(want)
    params_within(jparams, tparams, 2 * LR)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_molecule_step_at_base_width(arch):
    cell, jp, fn, tp, specs = cell_pair(arch, "molecule")
    assert [tuple(s.shape) for s in specs[2:]] == [tuple(s.shape) for s in cell.arg_specs[2:]]
    compare_step(cell, jp, fn, tp, mol(7, B=6, n=30, m=64, F=16))


def spec_leaves(tree):
    return [(tuple(x.shape), str(x.dtype).replace("torch.", "")) for x in TC.leaves(tree)]


@pytest.mark.parametrize("shape", list(JG.GNN_SHAPE_TABLE))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_step_specs(arch, shape):
    jmod, tmod, jc, tc = mods(arch)
    info = JG.GNN_SHAPE_TABLE[shape]
    cell = JG.build_gnn_cell(arch, shape, jmod, jc.cfg_for_shape)
    _, specs = TG.build_gnn_step(tmod, tc.cfg_for_shape(shape, info), info["kind"], info)
    assert len(specs) == len(cell.arg_specs)
    for got, want in zip(specs[2:], cell.arg_specs[2:]):
        assert got.device.type == "meta"
        assert (tuple(got.shape), str(got.dtype).replace("torch.", "")) == (
            want.shape, str(want.dtype))
    jleaves = [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(cell.arg_specs[0])]
    assert spec_leaves(specs[0]) == jleaves
    assert spec_leaves(specs[1].mu) == jleaves and specs[1].step.device.type == "meta"


def test_unknown_kind_raises():
    _, tmod, _, tc = mods("gcn")
    with pytest.raises(ValueError, match="kind"):
        TG.build_gnn_step(tmod, tc.SMOKE, "dense", {})


def test_gcn_bf16_messages():
    jmod, tmod, jc, tc = mods("gcn")
    cfg = dataclasses.replace(jc.SMOKE, message_dtype="bfloat16")
    arrays = mol(8, F=8)
    jp = jmod.init(jax.random.PRNGKey(1), cfg)
    want = np.asarray(jmod.apply(jp, cfg, JC.flatten_molecules(*arrays)))
    got = tmod.apply(TC.params_from_numpy(jax.device_get(jp), device="cpu"),
                     port_cfg(tmod, cfg), TC.flatten_molecules(*arrays, device="cpu"))
    close(got, want, rtol=2e-2, atol_of_max=2e-2)


# ---------------------------------------------------------------------------
# equivariance (the port alone)
# ---------------------------------------------------------------------------

def rotation(seed):
    Q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q


@pytest.mark.parametrize("arch", ["nequip", "mace"])
def test_x64_invariance(arch):
    _, tmod, _, _ = mods(arch)
    cls = {"nequip": "NequIPConfig", "mace": "MACEConfig"}[arch]
    cfg = getattr(tmod, cls)(d_feat=8, n_layers=2, hidden_mul=4)
    params = TC.tree_map(torch.Tensor.double,
                         tmod.init(torch.Generator().manual_seed(0), cfg, device="cpu"))
    feats, pos, src, dst, labels = mol(0, B=2, n=8, m=16, F=8)
    pos = pos.astype(np.float64) * 2
    Q, shift = rotation(1), np.random.default_rng(2).normal(size=(3,))

    def energy(p):
        b = TC.flatten_molecules(feats, p.astype(np.float32), src, dst, labels, device="cpu")
        b = dataclasses.replace(b, features=torch.from_numpy(feats.astype(np.float64)).reshape(16, 8),
                                positions=torch.from_numpy(p.reshape(16, 3)))
        return tmod.apply(params, cfg, b)

    e1, e2 = energy(pos), energy(pos @ Q.T + shift)
    assert e1.dtype == torch.float64
    rel = float((e2 - e1).abs().max() / (e1.abs().max() + 1e-12))
    assert rel < 1e-9, rel


@pytest.mark.parametrize("arch", ["egnn", "nequip", "mace"])
def test_f32_energy_invariance(arch):
    _, tmod, _, tc = mods(arch)
    cfg = dataclasses.replace(tc.SMOKE, n_layers=2)
    params = tmod.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    feats, pos, src, dst, labels = mol(3)
    Q = rotation(5).astype(np.float32)
    t = np.random.default_rng(5).normal(size=(3,)).astype(np.float32)
    e1 = tmod.apply(params, cfg, TC.flatten_molecules(feats, pos, src, dst, labels, device="cpu"))
    e2 = tmod.apply(params, cfg, TC.flatten_molecules(feats, pos @ Q.T + t, src, dst, labels,
                                                      device="cpu"))
    assert float((e2 - e1).abs().max() / (e1.abs().max() + 1e-9)) < 8e-3


def test_egnn_coordinates_equivariant():
    """EGNN's coordinate update rotates with the input frame (its layer
    loop, as ``egnn.apply`` runs it, with the coordinates exposed)."""
    from repro_torch.models.gnn import egnn

    cfg = egnn.EGNNConfig(d_feat=8, d_hidden=16, n_layers=2)
    params = egnn.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    feats, pos, src, dst, labels = mol(4)

    def final_coords(p):
        batch = TC.flatten_molecules(feats, p, src, dst, labels, device="cpu")
        h = TC.mlp_apply(params["embed"], batch.features, final_act=True)
        x, s, d = batch.positions, batch.src.long(), batch.dst
        em = batch.edge_mask.float()[:, None]
        deg = TC.degrees(batch)[:, None] + 1.0
        for lp in params["layers"]:
            rel = x[d.long()] - x[s]
            r2 = torch.sum(torch.square(rel), -1, keepdim=True)
            m = TC.mlp_apply(lp["phi_e"], torch.cat([h[d.long()], h[s], r2], -1),
                             final_act=True) * em
            cw = torch.tanh(TC.mlp_apply(lp["phi_x"], m)) * em
            x = x + TC.segment_sum(rel * cw, d, batch.n_nodes) / deg
            h = h + TC.mlp_apply(lp["phi_h"], torch.cat([h, TC.segment_sum(m, d, batch.n_nodes)],
                                                        -1))
        out = TC.mlp_apply(params["readout"], h)
        assert torch.allclose(TC.segment_sum(out[:, 0], batch.graph_id, batch.n_graphs),
                              egnn.apply(params, cfg, batch), rtol=1e-5, atol=1e-6)
        return x.numpy()

    Q = rotation(6).astype(np.float32)
    np.testing.assert_allclose(final_coords(pos) @ Q.T, final_coords(pos @ Q.T), atol=2e-4)
