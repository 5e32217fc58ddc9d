"""The port's benchmark harness (``repro_torch.benchmarks.run``) against the
JAX round's (``benchmarks/run.py``): the same suites in the same order, the
same flags and refusals, a failing suite failing the run, and a suite's
JSON read back by the unchanged ``benchmarks/ci_gate.py``."""

import argparse
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from benchmarks import ci_gate  # noqa: E402
from benchmarks import run as jrun  # noqa: E402
from repro_torch.benchmarks import run  # noqa: E402


def test_suites_are_the_jax_harness_names_in_order():
    assert list(run.SUITES) == list(jrun.SUITES)
    assert run.SUITES["kernels"].__name__ == "repro_torch.benchmarks.kernels_bench"
    for name, mod in run.SUITES.items():
        assert mod.__name__.startswith("repro_torch.benchmarks."), name


def test_list_prints_the_suites(capsys):
    assert run.main(["--list"]) == 0
    assert capsys.readouterr().out.split() == list(jrun.SUITES)


@pytest.mark.parametrize("argv", [
    ["--suite", "no_such_suite", "--device", "cpu"],
    ["--suite", "serving", "--suite", "dynamic", "--emit-json", "out.json",
     "--device", "cpu"],
], ids=["unknown_suite", "path_with_two_suites"])
def test_refused(argv, capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        run.main(argv)
    assert exc.value.code == 2
    assert "error:" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


def _fake(rows=None, error=None):
    def fake_run(device=None):
        if error is not None:
            raise error
        return rows
    return types.SimpleNamespace(run=fake_run)


def test_a_raising_suite_fails_the_run_and_the_rest_still_run(capsys, monkeypatch):
    monkeypatch.setattr(run, "SUITES", {
        "boom": _fake(error=ValueError("suite broke")),
        "fine": _fake(rows=[("fine/row", 1.0, "k=1", None)])})
    assert run.main(["--device", "cpu"]) == 1
    out = capsys.readouterr()
    assert out.out.splitlines() == ["name,us_per_call,derived", "boom/SUITE_ERROR,0.0,",
                                    "fine/row,1.0,k=1"]
    assert "ValueError: suite broke" in out.err


def test_an_error_row_fails_the_run(capsys, monkeypatch):
    monkeypatch.setattr(run, "SUITES", {"sub": _fake(rows=[("sub/ERROR", 0.0, "", None)])})
    assert run.main(["--device", "cpu"]) == 1


def test_auto_json_names_stay_off_the_jax_rounds_files(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(run, "SUITES", {"fine": _fake(rows=[("fine/row", 1.0, "", None)])})
    assert run.main(["--emit-json", "--device", "cpu"]) == 0
    assert [p.name for p in tmp_path.iterdir()] == ["BENCH_torch_fine.json"]


def test_serving_json_passes_ci_gate_serve(tmp_path, capsys):
    path = tmp_path / "BENCH_torch_serving.json"
    assert run.main(["--suite", "serving", "--emit-json", str(path), "--device", "cpu"]) == 0
    assert "serving/server_bfs" in capsys.readouterr().out
    # the serving-smoke job's bounds (ci.yml and ci_torch.yml)
    args = argparse.Namespace(bench=str(path), max_frac=0.5, min_qps=5.0, algos="bfs,sssp")
    assert ci_gate.cmd_serve(args) == 0
