"""The port's GNN building blocks (``models/gnn/irreps.py`` and
``models/gnn/common.py``) against the JAX package's, on inputs made with
numpy from a seed.

Tolerances: the Clebsch-Gordan arrays (float64 numpy in both packages)
within 1e-12; the f32 torch functions (spherical harmonics, the tensor
products, the channel mix, the gate, the helpers) within rtol 1e-5 and an
atol of 1e-6 of the output's largest magnitude (sums of products in
another order); integer outputs and the batch builders bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.gnn import common as JC  # noqa: E402
from repro.models.gnn import irreps as JI  # noqa: E402
from repro_torch.models.gnn import common as TC  # noqa: E402
from repro_torch.models.gnn import irreps as TI  # noqa: E402

RTOL = 1e-5
ATOL_OF_MAX = 1e-6
PATHS = JI.tp_paths(2)


def close(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_OF_MAX * float(np.abs(want).max(initial=0.0)))


def unit_vectors(rng, e):
    v = rng.normal(size=(e, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def feats(rng, lmax, e, mul):
    return {l: rng.normal(size=(e, mul, 2 * l + 1)).astype(np.float32) for l in range(lmax + 1)}


def t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


# ---------------------------------------------------------------------------
# irreps
# ---------------------------------------------------------------------------

def test_tp_paths():
    assert TI.tp_paths(2) == JI.tp_paths(2) and len(TI.tp_paths(2)) == 15
    assert [TI.tp_paths(l) for l in range(4)] == [JI.tp_paths(l) for l in range(4)]


@pytest.mark.parametrize("path", PATHS, ids=lambda p: "%d%d%d" % p)
def test_clebsch_gordan(path):
    np.testing.assert_allclose(TI.cg_real(*path), JI.cg_real(*path), rtol=0, atol=1e-12)
    np.testing.assert_allclose(TI.complex_cg(*path), JI.complex_cg(*path), rtol=0, atol=1e-12)
    assert np.abs(TI.cg_real(*path)).max() > 0


@pytest.mark.parametrize("l", [0, 1, 2])
def test_real_basis_and_wigner_d(l):
    np.testing.assert_array_equal(TI.u_real(l), JI.u_real(l))
    R, _ = np.linalg.qr(np.random.default_rng(l).normal(size=(3, 3)))
    np.testing.assert_allclose(TI.wigner_d_from_rotation(l, R),
                               JI.wigner_d_from_rotation(l, R), rtol=0, atol=1e-12)
    v = unit_vectors(np.random.default_rng(10 + l), 16).astype(np.float64)
    np.testing.assert_array_equal(TI.sph_harm_np(l, v), JI.sph_harm_np(l, v))


@pytest.mark.parametrize("l", [0, 1, 2])
def test_sph_harm(l):
    v = unit_vectors(np.random.default_rng(l), 257)
    close(TI.sph_harm(l, torch.from_numpy(v)), JI.sph_harm(l, jnp.asarray(v)))


def test_sph_harm_l1_order_is_y_z_x():
    v = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    got = TI.sph_harm(1, v) / np.sqrt(3.0)
    assert torch.equal(got, torch.tensor([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]))
    with pytest.raises(NotImplementedError):
        TI.sph_harm(3, v)


@pytest.mark.parametrize("lmax", [0, 1, 2])
def test_edge_tensor_product(lmax):
    rng = np.random.default_rng(20 + lmax)
    e, mul = 96, 5
    h = feats(rng, lmax, e, mul)
    v = unit_vectors(rng, e)
    radial = rng.normal(size=(e, len(JI.tp_paths(lmax)), mul)).astype(np.float32)
    want = JI.edge_tensor_product(j(h), JI.sph_all(lmax, jnp.asarray(v)), jnp.asarray(radial),
                                  lmax)
    got = TI.edge_tensor_product(t(h), TI.sph_all(lmax, torch.from_numpy(v)),
                                 torch.from_numpy(radial), lmax)
    assert list(got) == list(want)
    for l in want:
        close(got[l], want[l])


def test_linear_mix_and_gate():
    rng = np.random.default_rng(3)
    h = feats(rng, 2, 40, 6)
    w = {l: rng.normal(size=(6, 4)).astype(np.float32) for l in range(3)}
    want, got = JI.linear_mix(j(h), j(w)), TI.linear_mix(t(h), t(w))
    for l in want:
        close(got[l], want[l])
    want, got = JI.gate(j(h)), TI.gate(t(h))
    assert list(got) == list(want)
    for l in want:
        close(got[l], want[l])


def test_zeros_feat_and_feat_map():
    z = TI.zeros_feat(2, 7, 3, device="cpu")
    assert {l: tuple(x.shape) for l, x in z.items()} == {0: (7, 3, 1), 1: (7, 3, 3),
                                                         2: (7, 3, 5)}
    assert all(x.dtype == torch.float32 and not x.any() for x in z.values())
    assert TI.feat_map(lambda l, x: x.shape[-1], z) == {0: 1, 1: 3, 2: 5}


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------

def mol_arrays(seed=0, B=3, n=7, m=11, F=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, n, F)).astype(np.float32),
            rng.normal(size=(B, n, 3)).astype(np.float32),
            rng.integers(0, n, (B, m)), rng.integers(0, n, (B, m)),
            rng.normal(size=(B,)).astype(np.float32))


def batch_pair(seed=0, edge_mask=None):
    a = mol_arrays(seed)
    return (JC.flatten_molecules(*a, edge_mask=edge_mask),
            TC.flatten_molecules(*a, edge_mask=edge_mask, device="cpu"))


def assert_batch_equal(tb, jb):
    assert tb.n_graphs == jb.n_graphs
    assert (tb.n_nodes, tb.n_edges) == (jb.n_nodes, jb.n_edges)
    for name in ("features", "positions", "src", "dst", "edge_mask", "graph_id", "node_mask",
                 "labels"):
        want = np.asarray(getattr(jb, name))
        got = getattr(tb, name).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), name


@pytest.mark.parametrize("masked", [False, True])
def test_flatten_molecules_bitwise(masked):
    em = np.random.default_rng(1).random((3, 11)) < 0.7 if masked else None
    jb, tb = batch_pair(0, em)
    assert_batch_equal(tb, jb)
    tensors = TC.flatten_molecules(*(torch.as_tensor(x) for x in mol_arrays(0)), edge_mask=em)
    assert_batch_equal(tensors, jb)
    moved = tb.to("cpu")
    assert_batch_equal(moved, jb)


def test_degrees_and_segments():
    em = np.random.default_rng(2).random((3, 11)) < 0.6
    jb, tb = batch_pair(4, em)
    assert torch.equal(TC.degrees(tb), torch.from_numpy(np.array(JC.degrees(jb))))
    data = np.random.default_rng(5).normal(size=(tb.n_edges, 4)).astype(np.float32)
    close(TC.segment_sum(torch.from_numpy(data), tb.dst, tb.n_nodes),
          jax.ops.segment_sum(jnp.asarray(data), jb.dst, num_segments=jb.n_nodes))
    close(TC.segment_mean(torch.from_numpy(data), tb.dst, tb.n_nodes),
          JC.segment_mean(jnp.asarray(data), jb.dst, jb.n_nodes))


@pytest.mark.parametrize("cutoff", [1.5, 5.0])
def test_bessel_rbf(cutoff):
    d = np.concatenate([[0.0, 1e-7], np.random.default_rng(6).uniform(0, 6, 200)])
    d = d.astype(np.float32)
    close(TC.bessel_rbf(torch.from_numpy(d), 8, cutoff), JC.bessel_rbf(jnp.asarray(d), 8, cutoff))


@pytest.mark.parametrize("final_act", [False, True])
def test_mlp_apply(final_act):
    rng = np.random.default_rng(7)
    jl = JC.mlp_init(jax.random.PRNGKey(1), [6, 9, 4])
    tl = TC.params_from_numpy(jax.device_get(jl), device="cpu")
    x = rng.normal(size=(13, 6)).astype(np.float32)
    close(TC.mlp_apply(tl, torch.from_numpy(x), final_act=final_act),
          JC.mlp_apply(jl, jnp.asarray(x), final_act=final_act))
    mine = TC.mlp_init(torch.Generator().manual_seed(0), [6, 9, 4], device="cpu")
    assert [tuple(x["w"].shape) for x in mine] == [(6, 9), (9, 4)]
    assert not any(x["b"].any() for x in mine)


def test_losses():
    rng = np.random.default_rng(8)
    N, K = 19, 5
    logits = rng.normal(size=(N, K)).astype(np.float32) * 3
    labels = rng.integers(0, K, N).astype(np.int32)
    mask = rng.random(N) < 0.5

    def nb(mod, arr, lab, nm):
        return mod.GNNBatch(n_graphs=1, features=arr(np.zeros((N, 1), np.float32)),
                            positions=arr(np.zeros((N, 3), np.float32)),
                            src=arr(np.zeros(1, np.int32)), dst=arr(np.zeros(1, np.int32)),
                            edge_mask=arr(np.ones(1, bool)), graph_id=arr(np.zeros(N, np.int32)),
                            node_mask=arr(nm), labels=arr(lab))

    jb, tb = nb(JC, jnp.asarray, labels, mask), nb(TC, torch.from_numpy, labels, mask)
    close(TC.node_class_loss(torch.from_numpy(logits), tb),
          JC.node_class_loss(jnp.asarray(logits), jb))
    energies = rng.normal(size=(N,)).astype(np.float32)
    pred = rng.normal(size=(4,)).astype(np.float32)
    jb, tb = nb(JC, jnp.asarray, energies, mask), nb(TC, torch.from_numpy, energies, mask)
    close(TC.energy_loss(torch.from_numpy(pred), tb), JC.energy_loss(jnp.asarray(pred), jb))


def test_params_from_numpy_keeps_the_tree():
    tree = {"layers": [{"w": np.ones((2, 3), np.float32), "mix": {0: np.zeros(2), 2: np.ones(1)}}],
            "embed": [{"b": np.arange(3, dtype=np.float32)}]}
    got = TC.params_from_numpy(tree, device="cpu")
    assert isinstance(got["layers"], list) and set(got["layers"][0]["mix"]) == {0, 2}
    assert got["layers"][0]["mix"][0].dtype == torch.float64
    assert torch.equal(got["embed"][0]["b"], torch.arange(3, dtype=torch.float32))
    assert [tuple(x.shape) for x in TC.leaves(got)] == [(3,), (2,), (1,), (2, 3)]
    assert len(jax.tree.leaves(tree)) == len(TC.leaves(got))
