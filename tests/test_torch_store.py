"""The port's graph store (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``), after the store cases of
``tests/test_tiered.py``.

A store either package writes opens in the other with equal arrays,
CRCs and labels; the verify modes, the v1/v2 manifests, and the refusals
of a partial or corrupt store behave as the reference's.
"""

import json
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import checkpoint as jck  # noqa: E402
from repro.core import from_coo as jfrom_coo  # noqa: E402
from repro.core import tier_graph as jtier  # noqa: E402
from repro.core.algorithms import bfs as jbfs  # noqa: E402
from repro.graphs import generators as gen  # noqa: E402
from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch.core import faultio as tfault  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core.algorithms import bfs as tbfs  # noqa: E402
from repro_torch.core.tiered import TieredGraph, shard_crc, tier_graph  # noqa: E402
from test_torch_graph import port_graph  # noqa: E402

PACKAGES = {
    "jax": (jck.save_graph, lambda d, **kw: jck.open_graph(d, **kw)),
    "torch": (tck.save_graph, lambda d, **kw: tck.open_graph(d, device="cpu", **kw)),
}


def graphs(seed=3, n=300, m=2500, csc=False):
    src, dst, n = gen.erdos(n, m, seed=seed)
    w = np.random.default_rng(seed).uniform(0.5, 3.0, len(src)).astype(np.float32)
    jg = jfrom_coo(src, dst, n, w, block_size=32, build_csc=csc)
    return jg, port_graph(jg)


def manifest(directory):
    with open(os.path.join(str(directory), tck.GRAPH_MANIFEST)) as f:
        return json.load(f)


def flip_byte(path):
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(blob))


def host_arrays(tg):
    cuts = [tg._host] + ([tg._csc_host] if tg.has_csc else [])
    return [np.asarray(a) for cut in cuts for shard in cut for a in shard]


@pytest.mark.parametrize("csc", [False, True])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax"),
                                           ("torch", "torch")])
def test_store_opens_across_packages(tmp_path, writer, reader, csc):
    """The same graph saved by one package and opened by the other (or
    itself): equal manifests (but the time), shard arrays, CRCs, vertex
    arrays and bfs labels; the shards are memory-mapped."""
    jg, g = graphs(seed=5, csc=csc)
    save, _ = PACKAGES[writer]
    _, open_ = PACKAGES[reader]
    save(jg if writer == "jax" else g, str(tmp_path / "a"), nshards=6)
    jck.save_graph(jg, str(tmp_path / "b"), nshards=6)
    ma, mb = manifest(tmp_path / "a"), manifest(tmp_path / "b")
    ma.pop("time"), mb.pop("time")
    assert ma == mb
    assert ("csc" in ma) == csc
    got = open_(str(tmp_path / "a"), resident_shards=2, verify="require")
    want = jck.open_graph(str(tmp_path / "b"), resident_shards=2)
    assert isinstance(got._host[0][0], np.memmap)
    assert got.shard_crcs == want.shard_crcs and got.verified
    assert got.in_shard_crcs == want.in_shard_crcs
    for a, b in zip(host_arrays(got), host_arrays(want)):
        np.testing.assert_array_equal(a, b)
    for name in ("out_deg",) + (("in_deg",) if csc else ()):
        np.testing.assert_array_equal(np.asarray(getattr(got, name).cpu()
                                                 if reader == "torch" else getattr(got, name)),
                                      np.asarray(getattr(want, name)))
    ref = tbfs.bfs_dd_sparse(g, 0)[0].numpy()
    if reader == "torch":
        lab, st = tbfs.bfs_dd_sparse(got, 0)
        np.testing.assert_array_equal(ref, lab.numpy())
        assert st.h2d_bytes == st.shards_streamed * got.shard_bytes
    else:
        np.testing.assert_array_equal(ref, np.asarray(jbfs.bfs_dd_sparse(got, 0)[0]))
    assert not [f for f in os.listdir(tmp_path / "a") if f.endswith(".tmp")]


def test_store_accepts_pre_cut_tiered_graph_and_keeps_its_cut(tmp_path):
    jg, g = graphs(seed=6, csc=True)
    tg = tier_graph(g, nshards=4, resident_shards=2, build_csc=True)
    tck.save_graph(tg, str(tmp_path))
    re = tck.open_graph(str(tmp_path), device="cpu")
    assert isinstance(re, TieredGraph) and re.nshards == 4 and re.epd == tg.epd
    np.testing.assert_array_equal(tg._host[1][0], np.asarray(re._host[1][0]))
    man = manifest(tmp_path)
    assert man["format"] == "tiered-graph-v2"
    assert man["shard_dtypes"] == ["int32", "int32", "float32"]
    assert man["shard_shape"] == [tg.epd]
    assert man["shard_crcs"] == [shard_crc(*tg._host[s]) for s in range(4)]
    assert man["csc"]["shard_sizes"] == [int(s) for s in tg.in_shard_sizes]
    assert man["shard_crcs"] == jtier(jg, nshards=4, build_csc=True).shard_crcs
    with pytest.raises(ValueError, match="build_csc=True"):
        tck.save_graph(tier_graph(g, nshards=4), str(tmp_path / "x"), build_csc=True)
    tck.save_graph(tg, str(tmp_path / "no_csc"), build_csc=False)
    assert not tck.open_graph(str(tmp_path / "no_csc"), device="cpu").has_csc
    vals = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 5, g.n_pad).astype(np.float32))
    init = g.vertex_full(1e9, torch.float32)
    want = tops.pull_dense(g, vals, g.valid_vertex_mask(), init, kind="min")
    got = tops.pull_dense(re, vals, g.valid_vertex_mask(), init, kind="min")
    assert torch.equal(want, got)


def test_store_refuses_uncommitted_missing_and_truncated(tmp_path):
    _, g = graphs(seed=7)
    tck.save_graph(g, str(tmp_path), nshards=4)
    os.remove(os.path.join(str(tmp_path), tck.GRAPH_MANIFEST))
    with pytest.raises(FileNotFoundError):
        tck.open_graph(str(tmp_path), device="cpu")
    tck.save_graph(g, str(tmp_path), nshards=4)
    shard = os.path.join(str(tmp_path), "shard_000002.npz")
    os.remove(shard)
    with pytest.raises(ValueError, match="incomplete"):
        tck.open_graph(str(tmp_path), device="cpu")
    # a shard of another cut is refused, not mixed in
    other = tier_graph(g, nshards=2, resident_shards=2)
    np.savez(shard, src=other._host[0][0], dst=other._host[0][1], w=other._host[0][2])
    with pytest.raises(ValueError, match="shard 2"):
        tck.open_graph(str(tmp_path), device="cpu")


def test_store_resave_sweeps_stale_tmps(tmp_path):
    _, g = graphs(seed=13)
    stale = os.path.join(str(tmp_path), "shard_000000.npz.tmp")
    with open(stale, "wb") as f:
        f.write(b"crashed mid-write")
    tck.save_graph(g, str(tmp_path), nshards=2)
    assert not os.path.exists(stale)
    tck.open_graph(str(tmp_path), device="cpu")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_open_graph_verify_modes(tmp_path, writer):
    jg, g = graphs(seed=10)
    PACKAGES[writer][0](jg if writer == "jax" else g, str(tmp_path), nshards=4)
    flip_byte(os.path.join(str(tmp_path), "shard_000001.npz"))
    with pytest.raises(tfault.ShardCorruptError, match="shard 1"):
        tck.open_graph(str(tmp_path), verify="open", device="cpu")   # eager fsck
    tg = tck.open_graph(str(tmp_path), device="cpu")                  # lazy opens
    with pytest.raises(tfault.ShardCorruptError):
        tbfs.bfs_dd_sparse(tg, 0)                                     # caught at fetch
    assert tg.io.checksum_failures == 3 and tg.io.io_retries == 2
    off = tck.open_graph(str(tmp_path), verify="off", device="cpu")
    assert not off.verify_checksums and not off.verified
    with pytest.raises(ValueError, match="fetch\\|open\\|require\\|off"):
        tck.open_graph(str(tmp_path), verify="eventually", device="cpu")


def test_corrupt_csc_shard_detected_at_fetch(tmp_path):
    _, g = graphs(seed=20, csc=True)
    tck.save_graph(g, str(tmp_path), nshards=4)
    flip_byte(os.path.join(str(tmp_path), "cscshard_000002.npz"))
    with pytest.raises(tfault.ShardCorruptError, match="csc shard 2"):
        tck.open_graph(str(tmp_path), verify="open", device="cpu")
    tg = tck.open_graph(str(tmp_path), device="cpu")  # push side untouched
    tbfs.bfs_dd_sparse(tg, 0)
    with pytest.raises(tfault.ShardCorruptError, match="csc shard 2"):
        tbfs.bfs_dirop(tg, 0)


def _downgrade_to_v1(directory):
    mpath = os.path.join(directory, tck.GRAPH_MANIFEST)
    man = manifest(directory)
    man["format"] = "tiered-graph-v1"
    for k in ("shard_crcs", "shard_dtypes", "shard_shape"):
        man.pop(k)
    with open(mpath, "w") as f:
        json.dump(man, f)


def test_v2_store_is_verified_and_v1_opens_unverified(tmp_path):
    _, g = graphs(seed=11)
    tck.save_graph(g, str(tmp_path), nshards=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a healthy v2 open must not warn
        assert tck.open_graph(str(tmp_path), verify="require", device="cpu").verified
    _downgrade_to_v1(str(tmp_path))
    with pytest.warns(UserWarning, match="UNVERIFIED"):
        tg = tck.open_graph(str(tmp_path), verify="open", device="cpu")
    assert tg.shard_crcs is None and not tg.verified
    with pytest.warns(UserWarning, match="UNVERIFIED"):
        assert not tck.open_graph(str(tmp_path), device="cpu").verified
    with pytest.raises(ValueError, match="no\\s+per-shard checksums"):
        tck.open_graph(str(tmp_path), verify="require", device="cpu")
    np.testing.assert_array_equal(tbfs.bfs_dd_sparse(g, 0)[0].numpy(),
                                  tbfs.bfs_dd_sparse(tg, 0)[0].numpy())
    # the reference reads the same downgraded store the same way
    with pytest.warns(UserWarning, match="UNVERIFIED"):
        assert not jck.open_graph(str(tmp_path)).verified


def test_unreadable_shard_and_pending_dynamic_logs_refused(tmp_path):
    _, g = graphs(seed=12)
    tck.save_graph(g, str(tmp_path), nshards=2)
    man = manifest(tmp_path)
    man["format"] = "tiered-graph-v3"
    man["logs"] = {"sizes": [0, 0]}
    with open(os.path.join(str(tmp_path), tck.GRAPH_MANIFEST), "w") as f:
        json.dump(man, f)
    tck.open_graph(str(tmp_path), device="cpu")   # a v3 store with empty logs
    man["logs"] = {"sizes": [0, 3]}
    with open(os.path.join(str(tmp_path), tck.GRAPH_MANIFEST), "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match="pending"):
        tck.open_graph(str(tmp_path), device="cpu")
    tck.save_graph(g, str(tmp_path / "u"), nshards=2)
    with open(os.path.join(str(tmp_path / "u"), "shard_000000.npz"), "wb") as f:
        f.write(b"not a zip at all")
    with pytest.raises(tfault.ShardCorruptError, match="unreadable"):
        tck.open_graph(str(tmp_path / "u"), device="cpu")
