"""The port's dry run (``launch/dryrun.py``: the meta-tensor account of a
cell), its meshes (``launch/mesh.py``), the sharding helpers
(``distributed/mesh_utils.py``), the trainer's filtered specs and the
roofline rows (``benchmarks/roofline.py``).

Exact, as the accounts are integers from shapes: a dense LM step's FLOPs
are three times its forward matrix products (every product's two
operands need a gradient); the probes' extrapolation equals a direct
account at depth 4; argument bytes are hand-computed shard bytes; the
collective model on a synthetic tree is its rule applied by hand.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro_torch.benchmarks import roofline  # noqa: E402
from repro_torch.configs import h2o_danube3_4b as dn  # noqa: E402
from repro_torch.configs.lm_common import build_lm_cell  # noqa: E402
from repro_torch.configs.registry import DryrunCell  # noqa: E402
from repro_torch.distributed import mesh_utils as MU  # noqa: E402
from repro_torch.distributed.mesh_utils import P  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.train import Trainer, TrainerConfig  # noqa: E402

REF_KEYS = {"arch", "shape", "mesh", "axes", "n_chips", "kind", "unrolled", "note",
            "lower_s", "compile_s", "per_device", "roofline"}
REF_PER_DEVICE = {"flops", "bytes_accessed", "collective_bytes", "collective_counts",
                  "argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
TINY = dataclasses.replace(dn.SMOKE, name="tiny", n_layers=2, d_model=32, n_heads=4,
                           n_kv_heads=2, d_head=8, d_ff=48, vocab_size=96,
                           sliding_window=None, remat=False)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_partition_spec_normalises_as_jax():
    for entries in [(), (None,), ("data",), (("pod", "data"), None), ((), "model"),
                    (["data", "model"], None), (("data",), None, "model")]:
        assert tuple(P(*entries)) == tuple(JP(*entries)), entries
    assert P("a") == P(("a",)) and hash(P("a", None)) == hash(P("a", None))


def test_meshes_and_helpers():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16}
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert single.device.type == "meta"
    host = make_host_mesh((2, 4), ("data", "model"))
    assert host.shape == {"data": 2, "model": 4} and host.device.type == "cpu"
    assert MU.axis_size(single, "pod") == 1 and MU.axis_size(multi, "pod") == 2
    assert len(MU.flat_devices(multi)) == 512
    assert MU.batch_axes(single) == ("data",) and MU.batch_axes(multi) == ("pod", "data")
    # spec drops a whole entry naming an absent axis; filter_pspec keeps the rest
    assert MU.spec(single, ("pod", "data"), "model", None) == P(None, "model", None)
    assert MU.filter_pspec(P(("pod", "data"), "model"), single) == P("data", "model")
    assert MU.shard_shape((100, 7, 3), P(("pod", "data"), "model"), single) == (7, 1, 3)
    assert MU.shard_shape((100, 7, 3), P(("pod", "data"), "model"), multi) == (4, 1, 3)


def test_trainer_specs_filtered_to_its_mesh():
    cfg = TrainerConfig(model=dn.SMOKE, global_batch=1, seq_len=8, steps=1)
    tr = Trainer(cfg, device="cpu")
    assert tr.mesh.shape == {"data": 1, "model": 1}
    params, opt, batch = tr._shardings()
    assert params["layers"]["attn"]["wq"] == P(None, "data", "model")
    assert opt.step == P() and opt.mu is params and opt.nu is params
    assert batch == {"tokens": P("data", None), "labels": P("data", None)}
    tr.mesh = make_host_mesh((4,), ("model",))
    params, _, batch = tr._shardings()
    assert params["embed"] == P("model", None) and batch["tokens"] == P(None, None)


def forward_matmul_flops(cfg, B, S):
    T, D, H, KV, dh = B * S, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    layer = (2 * T * D * H * dh + 2 * 2 * T * D * KV * dh + 2 * T * H * dh * D
             + 2 * 2 * B * H * S * S * dh + 3 * 2 * T * D * cfg.d_ff)
    return cfg.n_layers * layer + 2 * T * D * cfg.vocab_size


def test_dense_step_flops_closed_form():
    cfg = dataclasses.replace(TINY, n_layers=3)
    cell = build_lm_cell(cfg, "train_4k")
    flops, nbytes, ops, out = dryrun.account(cell.fn, cell.arg_specs)
    B, S = cell.arg_specs[2]["tokens"].shape
    assert flops == 3 * forward_matmul_flops(cfg, B, S)
    assert nbytes > 0 and ops > 0
    assert out[2]["loss"].device.type == "meta" and int(out[1].step.numel()) == 1


def test_extrapolation_equals_direct_account():
    def build(nl):
        return build_lm_cell(TINY, "train_4k", n_layers_override=nl)

    recs = {nl: dryrun.run_cell("tiny", "train_4k", False, save=False, verbose=False,
                                cell=build(nl)) for nl in (1, 2, 4)}
    for key in ("flops", "bytes_accessed", "aten_ops"):
        f = {nl: r["totals"][key] for nl, r in recs.items()}
        assert f[4] == f[1] + 3 * (f[2] - f[1]), key
    ext = dryrun.run_cell_extrapolated("tiny", "train_4k", save=False, build=build, n_layers=4)
    assert ext["accounting"].startswith("extrapolated")
    assert ext["per_device"] == recs[4]["per_device"]
    assert ext["totals"] == recs[4]["totals"] and ext["roofline"] == recs[4]["roofline"]
    assert ext["per_device"]["collective_bytes"]["total"] > 0


def test_argument_bytes_are_shard_bytes():
    args = ({"w": _meta((1000, 30)), "b": _meta((7,), torch.bfloat16)},
            _meta((513, 5), torch.int32))
    specs = ({"w": P(("pod", "data"), "model"), "b": P()}, P("data", None))
    cell = DryrunCell(arch="syn", shape="s", kind="serve",
                      fn=lambda p, x: x[:, :2] + 1, arg_specs=args, in_specs=specs,
                      out_specs=P(None, "model"))
    rec = dryrun.run_cell("syn", "s", False, save=False, verbose=False, cell=cell)
    pd = rec["per_device"]
    # 'pod' dropped on the single pod; 1000/16 and 30/16 and 513/16 ceil-padded
    assert pd["argument_bytes"] == 63 * 2 * 4 + 7 * 2 + 33 * 5 * 4
    assert pd["output_bytes"] == 513 * 1 * 4
    assert pd["temp_bytes"] is None and pd["peak_bytes"] is None
    assert pd["collective_bytes"]["total"] == 0          # serve cells count none
    multi = dryrun.run_cell("syn", "s", True, save=False, verbose=False, cell=cell)
    assert multi["per_device"]["argument_bytes"] == 32 * 2 * 4 + 7 * 2 + 33 * 5 * 4
    assert multi["n_chips"] == 512 and multi["unrolled"] is False


def test_collective_model_on_a_synthetic_tree():
    params = {"fsdp": _meta((1000, 64)), "both": _meta((100, 8), torch.bfloat16),
              "rep": _meta((64,)), "tp": _meta((64, 48))}
    specs = {"fsdp": P("data", "model"), "both": P(("pod", "data"), None), "rep": P(),
             "tp": P(None, "model")}
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    nbytes, counts = dryrun.collective_model(params, specs, single, train=True)
    # gathers (result: the model-sharded leaf) twice; grads reduce-scattered
    assert nbytes["all-gather"] == 2 * (1000 * 4 * 4 + 100 * 8 * 2)
    assert nbytes["reduce-scatter"] == 63 * 4 * 4 + 7 * 8 * 2
    # replicated over 'data': rep and tp all-reduced at their shard size
    assert nbytes["all-reduce"] == 64 * 4 + 64 * 3 * 4
    assert counts == {"all-gather": 4, "reduce-scatter": 2, "all-reduce": 2,
                      "all-to-all": 0, "collective-permute": 0}
    nbytes, counts = dryrun.collective_model(params, specs, multi, train=True)
    # fsdp is replicated over 'pod' as well: all-reduced over it
    assert nbytes["reduce-scatter"] == 63 * 4 * 4 + 4 * 8 * 2
    assert nbytes["all-reduce"] == 63 * 4 * 4 + 64 * 4 + 64 * 3 * 4
    assert counts["all-reduce"] == 3
    assert nbytes["total"] == sum(v for k, v in nbytes.items() if k != "total")
    assert dryrun.collective_model(params, specs, multi, train=False)[0]["total"] == 0


def test_record_keys_and_roofline_rows(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    cell = build_lm_cell(TINY, "decode_32k")
    rec = dryrun.run_cell("h2o-danube-3-4b", "decode_32k", False, verbose=False, cell=cell)
    assert REF_KEYS <= set(rec) and REF_PER_DEVICE <= set(rec["per_device"])
    assert rec["collective_model"] == "params-only lower bound"
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s", "bottleneck"}
    dt = str(TINY.dtype).removeprefix("torch.")
    peak = {"bfloat16": 989e12, "float32": 67e12}[dt]
    assert rec["compute_dtype"] == dt and rec["peak_flops"] == peak
    assert rec["roofline"]["compute_s"] == rec["per_device"]["flops"] / peak
    saved = tmp_path / "h2o-danube-3-4b__decode_32k__pod1.json"
    assert json.loads(saved.read_text()) == rec
    rows = roofline.run(directory=str(tmp_path))
    assert [r[0] for r in rows] == ["roofline/h2o-danube-3-4b/decode_32k/16x16"]
    dom = max(rec["roofline"][k] for k in ("compute_s", "memory_s", "collective_s"))
    assert rows[0][1] == dom * 1e6
    mf = 2 * dn.FULL.active_param_count * 128
    assert f"model_flops={mf};" in rows[0][2] and "useful_ratio=" in rows[0][2]
    assert roofline.run(directory=str(tmp_path / "none"))[0][0] == "roofline/EMPTY"


def test_cli_list_prints_the_forty_cells(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["dryrun", "--list"])
    dryrun.main()
    lines = capsys.readouterr().out.split("\n")
    cells = [tuple(line.split()) for line in lines if line.strip()]
    from repro_torch.configs import list_cells

    assert cells == list_cells() and len(cells) == 40
    assert np.unique([a for a, _ in cells]).size == 10


def test_sampler_key_tensor_draws_equal_host():
    """The sampler hashes its key on the CSR's device in torch
    (``randint_t``), bitwise the numpy draws; a key given as a pair, a
    numpy array or a (2,) uint32 tensor (meta in the dry run) samples the
    same blocks."""
    from repro_torch.data import pipeline as DP
    from repro_torch.graphs.sampler import sample_blocks_raw

    key = DP.fold_in(DP.prng_key(5), 2)
    kt = torch.tensor(key, dtype=torch.uint32)
    for shape, lo, hi in (((6, 7), 0, 1 << 30), ((257,), 1, 512), ((9,), -5, 2**31 - 1)):
        np.testing.assert_array_equal(DP.randint_t(kt.to(torch.int64), shape, lo, hi).numpy(),
                                      DP.randint(key, shape, lo, hi))
    rng = np.random.default_rng(8)
    n = 60
    deg = rng.integers(0, 14, n)
    deg[[3, 17]] = 0                     # self-loops
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    col_idx = rng.integers(0, n, int(row_ptr[-1])).astype(np.int32)
    csr = [torch.from_numpy(a) for a in (row_ptr, col_idx, deg.astype(np.int32))]
    seeds = np.array([3, 0, 17, 42, 59], np.int32)
    pair = sample_blocks_raw(*csr, seeds, key, (4, 3))
    assert len(pair.layers) == 2
    for k in (np.array(key, np.uint32), kt):
        for a, b in zip(pair.layers, sample_blocks_raw(*csr, seeds, k, (4, 3)).layers):
            assert torch.equal(a, b)
    meta = sample_blocks_raw(*(t.to("meta") for t in csr), _meta((5,), torch.int32),
                             _meta((2,), torch.uint32), (4, 3))
    assert [tuple(x.shape) for x in meta.layers] == [(20,), (60,)]
    assert all(x.device.type == "meta" for x in meta.layers)
