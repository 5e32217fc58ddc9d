"""The port's run checkpoints (``repro_torch.checkpoint.RunCheckpointer``)
and resume (``engine.resume_run`` and every runner's ``checkpointer``)
against the JAX package's, after ``tests/test_chaos.py``'s drills.

Held: the checkpointer's cadence, rotation and refusals; resumes bitwise
equal to the uninterrupted run on a tiered graph (streamed), through the
fused resident ladder (snapshots at stretch boundaries, at the reference's
rounds, twice in one process) and per round; the kill drill in a real
subprocess that imports only ``repro_torch`` (``os._exit(7)`` at round 3,
then a resume bitwise to the uninterrupted run) for streamed bfs and
det-add pagerank; snapshots resumed across packages; and no added
``engine.fetch`` for a checkpointer.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro_torch  # noqa: E402
from repro.checkpoint import RunCheckpointer as JRunCheckpointer  # noqa: E402
from repro.checkpoint import load_pytree as jload_pytree  # noqa: E402
from repro.core import from_coo as jfrom_coo  # noqa: E402
from repro.core import operators as jops  # noqa: E402
from repro.core import tier_graph as jtier  # noqa: E402
from repro.core.algorithms import bfs as jbfs  # noqa: E402
from repro.core.algorithms import pagerank as jpr  # noqa: E402
from repro.graphs import generators as gen  # noqa: E402
from repro_torch.checkpoint import (RunCheckpointer, latest_step,  # noqa: E402
                                    load_pytree, save_pytree)
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import faultio as tfault  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core import tier_graph  # noqa: E402
from repro_torch.core.algorithms import bfs as tbfs  # noqa: E402
from repro_torch.core.algorithms import pagerank as tpr  # noqa: E402
from repro_torch.core.algorithms import sssp as tsssp  # noqa: E402
from test_torch_graph import port_graph  # noqa: E402


def chaos_graph(seed=0, n=512, m=4096):
    """``tests/test_chaos.py``'s graph, in both packages."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    return jfrom_coo(src, dst, n, block_size=64)


def tiered(jg=None):
    return tier_graph(port_graph(chaos_graph() if jg is None else jg), nshards=4,
                      resident_shards=2)


def steps(directory):
    return sorted(int(f[5:-4]) for f in os.listdir(directory)
                  if f.startswith("step_") and f.endswith(".npz"))


# ---------------------------------------------------------------------------
# RunCheckpointer
# ---------------------------------------------------------------------------

def test_run_checkpointer_cadence_and_rotation(tmp_path):
    ckr = RunCheckpointer(str(tmp_path), every=3, keep_last=2)
    state = {"x": torch.arange(4)}
    for r in range(1, 10):
        ckr.maybe_save(state, r)
    assert ckr.saves == 3                       # at 3, 6 and 9
    assert steps(tmp_path) == [6, 9]
    ckr.maybe_save(state, 25)                   # a jump past a multiple fires
    assert ckr.saves == 4


def test_run_checkpointer_load_fresh_dir_returns_round_zero(tmp_path):
    ckr = RunCheckpointer(str(tmp_path / "empty"))
    state = {"x": torch.arange(4)}
    got, start = ckr.load(state)
    assert start == 0 and got is state


def test_run_checkpointer_rejects_bad_every(tmp_path):
    with pytest.raises(ValueError, match="every"):
        RunCheckpointer(str(tmp_path), every=0)


def test_rotation_sweeps_stale_tmp_files(tmp_path):
    (tmp_path / "step_0000000001.npz.tmp").write_bytes(b"torn")
    (tmp_path / "manifest.json.1.tmp").write_bytes(b"torn")
    ckr = RunCheckpointer(str(tmp_path), every=1)
    ckr.save((torch.zeros(3),), 2)
    assert sorted(os.listdir(tmp_path)) == ["manifest.json", "step_0000000002.npz"]


@pytest.mark.parametrize("kind", ["tuple", "nested", "dict", "prstate"])
def test_snapshot_keys_and_values_match_reference(tmp_path, kind):
    """A state tree flattens to the reference's keys, and each package loads
    the other's snapshot into its own structure."""
    a, b = np.arange(5, dtype=np.int32), np.linspace(0, 1, 5, dtype=np.float32)
    mask = np.array([True, False, True, False, False])
    trees = {
        "tuple": lambda T: (T(a), T(mask)),
        "nested": lambda T: ((T(a), (T(b), T(mask))), T(b)),
        "dict": lambda T: {"lab": T(a), "alive": T(mask), "deg": T(b)},
        "prstate": lambda T: (tpr.PRState if T is torch.from_numpy else jpr.PRState)(
            rank=T(b), resid=T(b * 2)),
    }
    port_tree, jax_tree = trees[kind](torch.from_numpy), trees[kind](jnp.asarray)
    save_pytree(port_tree, str(tmp_path / "t"), 7)
    JRunCheckpointer(str(tmp_path / "j"), every=1).save(jax_tree, 7)
    pt = np.load(tmp_path / "t" / "step_0000000007.npz")
    jt = np.load(tmp_path / "j" / "step_0000000007.npz")
    assert sorted(pt.files) == sorted(jt.files)
    for k in pt.files:
        np.testing.assert_array_equal(pt[k], jt[k])
    got, step = load_pytree(port_tree, str(tmp_path / "j"))
    assert step == 7 and type(got) is type(port_tree)
    jgot, _ = jload_pytree(jax_tree, str(tmp_path / "t"))
    flat = save_pytree(got, str(tmp_path / "again"), 7)
    back = np.load(flat)
    for k in back.files:
        np.testing.assert_array_equal(back[k], pt[k])
    del jgot


def test_load_refuses_a_structure_mismatch(tmp_path):
    save_pytree((torch.zeros(3), torch.ones(3)), str(tmp_path), 4)
    with pytest.raises(ValueError, match="structure mismatch"):
        load_pytree((torch.zeros(3),), str(tmp_path))
    with pytest.raises(FileNotFoundError):
        load_pytree((torch.zeros(3),), str(tmp_path / "none"))
    assert latest_step(str(tmp_path)) == 4


def test_failed_snapshot_write_keeps_the_last_committed(tmp_path):
    """A fault at the ``ckpt_write`` site stops a save before it writes:
    the committed snapshot stays the latest, and a resume from it is
    bitwise."""
    ref, _ = tbfs.bfs_dd_sparse(tiered(), 0, fused=False)
    fault = tfault.FaultInjector([tfault.eio("ckpt_write", at=1)])
    ckr = RunCheckpointer(str(tmp_path), every=2, fault=fault)
    with pytest.raises(tfault.InjectedIOError):
        tbfs.bfs_dd_sparse(tiered(), 0, checkpointer=ckr)
    assert steps(tmp_path) == [2]
    dist, _ = tbfs.bfs_dd_sparse(tiered(), 0, checkpointer=RunCheckpointer(
        str(tmp_path), every=2))
    assert torch.equal(dist, ref)


# ---------------------------------------------------------------------------
# in-process resumes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [True, False])
def test_in_process_resume_is_bitwise_streamed(tmp_path, fused):
    ref, st_ref = tbfs.bfs_dd_sparse(tiered(), 0, fused=False)
    d1, _ = tbfs.bfs_dd_sparse(tiered(), 0, fused=fused, checkpointer=RunCheckpointer(
        str(tmp_path), every=2))
    assert torch.equal(d1, ref)
    assert steps(tmp_path)
    d2, st2 = tbfs.bfs_dd_sparse(tiered(), 0, fused=fused,
                                 checkpointer=RunCheckpointer(str(tmp_path), every=2))
    assert torch.equal(d2, ref) and st2.rounds < st_ref.rounds


@pytest.mark.parametrize("fused", [True, False])
def test_interrupted_streamed_run_resumes_bitwise(tmp_path, fused):
    """A run stopped at its round budget (``max_rounds`` is the total
    budget) and resumed with a larger one finishes as the uninterrupted
    run, labels bitwise."""
    ref, st_ref = tbfs.bfs_dd_sparse(tiered(), 0)
    assert st_ref.rounds > 4
    tbfs.bfs_dd_sparse(tiered(), 0, max_rounds=4, fused=fused,
                       checkpointer=RunCheckpointer(str(tmp_path), every=1))
    assert max(steps(tmp_path)) == 4
    dist, st = tbfs.bfs_dd_sparse(tiered(), 0, fused=fused,
                                  checkpointer=RunCheckpointer(str(tmp_path), every=1))
    assert torch.equal(dist, ref) and st.rounds == st_ref.rounds - 4


def ladder_graph():
    src, dst, n = gen.web_crawl_like(24, 5, 10, 2, seed=2)
    w = gen.random_weights(len(src), seed=3)
    return jfrom_coo(src, dst, n, w, block_size=64)


@pytest.mark.parametrize("algo", ["bfs", "sssp"])
def test_fused_resident_resume_at_stretch_boundaries(tmp_path, algo):
    """The fused ladder snapshots after each settled stretch, at the
    reference's rounds; a run resumed from each snapshot in turn (two and
    more resumes in one process, on one graph whose rung loops are kept)
    is bitwise equal to the uninterrupted run."""
    jg = ladder_graph()
    g = port_graph(jg)
    def sssp_run(checkpointer=None):
        # sssp_dd_sparse's own engine run, with a checkpointer
        eng = teng.SparseLadderEngine(g, tsssp._sssp_sparse_step,
                                      tsssp._sssp_dense_step)
        dist, _ = eng.run(tsssp._init_dist(g, 0), tbfs._source_mask(g, 0),
                          checkpointer=checkpointer)
        return dist, eng.stats

    run = {"bfs": lambda **kw: tbfs.bfs_dd_sparse(g, 0, **kw),
           "sssp": sssp_run}[algo]
    ref, st_ref = run()
    all_dir = tmp_path / "all"
    run(checkpointer=RunCheckpointer(str(all_dir), every=1, keep_last=10**6))
    taken = steps(all_dir)
    assert len(taken) >= 2 and taken[-1] == st_ref.rounds
    if algo == "bfs":
        jdir = tmp_path / "ref"
        jbfs.bfs_dd_sparse(jg, 0, checkpointer=JRunCheckpointer(
            str(jdir), every=1, keep_last=10**6))
        assert steps(jdir) == taken          # the reference's snapshot rounds
    for r in taken[:-1][:3]:
        one = tmp_path / f"from_{r}"
        one.mkdir()
        os.link(all_dir / f"step_{r:010d}.npz", one / f"step_{r:010d}.npz")
        dist, st = run(checkpointer=RunCheckpointer(str(one), every=10**6))
        assert torch.equal(dist, ref), r
        assert st.rounds == st_ref.rounds - r


def test_per_round_resident_resume(tmp_path):
    g = port_graph(ladder_graph())
    ref, st_ref = tbfs.bfs_dd_sparse(g, 0, fused=False)
    tbfs.bfs_dd_sparse(g, 0, fused=False, max_rounds=5,
                       checkpointer=RunCheckpointer(str(tmp_path), every=5))
    assert steps(tmp_path) == [5]
    dist, st = tbfs.bfs_dd_sparse(g, 0, fused=False,
                                  checkpointer=RunCheckpointer(str(tmp_path)))
    assert torch.equal(dist, ref) and st.rounds == st_ref.rounds - 5


@pytest.mark.parametrize("fused", [True, False])
def test_checkpointer_adds_no_fetch(tmp_path, fused):
    """The stretch and round counts ``tests/test_torch_stretch.py`` pins
    hold with a checkpointer: its snapshots copy state to the host only
    when they save, and no snapshot is an ``engine.fetch``."""
    for g in (port_graph(ladder_graph()), tiered()):
        counts = []
        for ckr in (None, RunCheckpointer(str(tmp_path / f"{id(g)}{fused}"), every=1)):
            before = teng.fetch.calls
            dist, _ = tbfs.bfs_dd_sparse(g, 0, fused=fused, checkpointer=ckr)
            counts.append((teng.fetch.calls - before, dist))
        assert counts[0][0] == counts[1][0]
        assert torch.equal(counts[0][1], counts[1][1])
        assert ckr.saves >= 1


def test_det_pagerank_resume_is_bitwise(tmp_path):
    with tops.deterministic_add_scope(True):
        ref, _ = tpr.pr_push(tiered(), max_iters=20)
        tpr.pr_push(tiered(), max_iters=7, checkpointer=RunCheckpointer(
            str(tmp_path), every=3))
        assert max(steps(tmp_path)) == 6
        rank, st = tpr.pr_push(tiered(), max_iters=20, checkpointer=RunCheckpointer(
            str(tmp_path), every=3))
    # pr_push reports the runner's round counter, which a resume continues
    assert torch.equal(rank, ref) and st.rounds == 20


# ---------------------------------------------------------------------------
# snapshots across packages
# ---------------------------------------------------------------------------

def test_port_resumes_a_reference_snapshot(tmp_path):
    jg = chaos_graph()
    jref, _ = jbfs.bfs_dd_sparse(jtier(jg, nshards=4, resident_shards=2), 0)
    jbfs.bfs_dd_sparse(jtier(jg, nshards=4, resident_shards=2), 0, max_rounds=3,
                       checkpointer=JRunCheckpointer(str(tmp_path), every=1))
    assert max(steps(tmp_path)) == 3
    dist, _ = tbfs.bfs_dd_sparse(tiered(jg), 0,
                                 checkpointer=RunCheckpointer(str(tmp_path)))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jref))


def test_reference_resumes_a_port_snapshot(tmp_path):
    jg = chaos_graph()
    jref, _ = jbfs.bfs_dd_sparse(jtier(jg, nshards=4, resident_shards=2), 0)
    tbfs.bfs_dd_sparse(tiered(jg), 0, max_rounds=3,
                       checkpointer=RunCheckpointer(str(tmp_path), every=1))
    assert max(steps(tmp_path)) == 3
    jdist, _ = jbfs.bfs_dd_sparse(jtier(jg, nshards=4, resident_shards=2), 0,
                                  checkpointer=JRunCheckpointer(str(tmp_path)))
    np.testing.assert_array_equal(np.asarray(jdist), np.asarray(jref))


def test_det_pagerank_snapshot_resumes_across_packages(tmp_path):
    jg = chaos_graph()
    with jops.deterministic_add_scope(True):
        jpr.pr_push(jtier(jg, nshards=4, resident_shards=2), max_iters=5,
                    checkpointer=JRunCheckpointer(str(tmp_path), every=5))
    with tops.deterministic_add_scope(True):
        ref, _ = tpr.pr_push(tiered(jg), max_iters=20)
        rank, st = tpr.pr_push(tiered(jg), max_iters=20,
                               checkpointer=RunCheckpointer(str(tmp_path), every=5))
    assert st.rounds == 20
    assert torch.equal(rank, ref)


# ---------------------------------------------------------------------------
# kill-at-round-r drills (a real subprocess, os._exit: nothing unwinds)
# ---------------------------------------------------------------------------

CHILD = textwrap.dedent("""
    import sys
    import numpy as np
    from repro_torch.checkpoint import RunCheckpointer
    from repro_torch.core import faultio, from_coo, tier_graph
    from repro_torch.core import operators as ops
    from repro_torch.core.algorithms import bfs, pagerank

    algo, ckdir, mode = sys.argv[1], sys.argv[2], sys.argv[3]
    rng = np.random.default_rng(0)
    n, m = 512, 4096
    g0 = from_coo(rng.integers(0, n, m), rng.integers(0, n, m), n,
                  block_size=64, device="cpu")
    tg = tier_graph(g0, nshards=4, resident_shards=2)
    if mode == "kill":
        tg.set_fault_injector(faultio.FaultInjector([faultio.kill("round", at=3)]))
    ckr = RunCheckpointer(ckdir, every=2)
    if algo == "bfs":
        out, st = bfs.bfs_dd_sparse(tg, 0, checkpointer=ckr)
    else:
        ops.set_deterministic_add(True)
        out, st = pagerank.pr_push(tg, max_iters=20, checkpointer=ckr)
    np.save(ckdir + "/result.npy", out.numpy())
    assert "jax" not in sys.modules and "repro" not in sys.modules
    print("DONE", st.rounds)
""")


def run_child(algo, ckdir, mode):
    env = dict(os.environ)
    src_dir = os.path.dirname(os.path.abspath(list(repro_torch.__path__)[0]))
    env["PYTHONPATH"] = src_dir + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", CHILD, algo, ckdir, mode],
                          env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("algo", ["bfs", "pagerank"])
def test_kill_and_resume_matches_uninterrupted_bitwise(tmp_path, algo):
    ref_dir, kill_dir = tmp_path / "ref", tmp_path / "kill"
    ref_dir.mkdir(), kill_dir.mkdir()
    p = run_child(algo, str(ref_dir), "plain")
    assert p.returncode == 0, p.stderr[-2000:]
    ref = np.load(ref_dir / "result.npy")
    p = run_child(algo, str(kill_dir), "kill")
    assert p.returncode == 7, (p.returncode, p.stderr[-2000:])   # died hard
    assert not (kill_dir / "result.npy").exists()
    assert steps(kill_dir) == [2]          # committed before the kill at round 3
    p = run_child(algo, str(kill_dir), "resume")
    assert p.returncode == 0, p.stderr[-2000:]
    np.testing.assert_array_equal(np.load(kill_dir / "result.npy"), ref)
    # and the uninterrupted run is the reference's
    jg = chaos_graph()
    if algo == "bfs":
        want, _ = jbfs.bfs_dd_sparse(jtier(jg, nshards=4, resident_shards=2), 0)
        np.testing.assert_array_equal(ref, np.asarray(want))
    else:
        with jops.deterministic_add_scope(True):
            want, _ = jpr.pr_push(jtier(jg, nshards=4, resident_shards=2), max_iters=20)
        np.testing.assert_allclose(ref, np.asarray(want), rtol=1e-4, atol=1e-10)
