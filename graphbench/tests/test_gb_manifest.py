"""BENCHMARK.json against the rules it is held to, and the harness's
sources: no JAX, no JAX package, nothing of the JAX-era benchmarks."""

import ast
import json
import re

import gb_fixtures
import pytest

ROOT, BENCH = gb_fixtures.ROOT, gb_fixtures.BENCH
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
E2E = ("gteps", "trial_ms_p95", "solve_s", "peak_gib", "setup_s")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _metrics():
    return MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["graphbench"]
    assert MANIFEST["command"][1].startswith("graphbench/") and len(MANIFEST["command"]) <= 32
    assert all(LINE.match(w) and not w.startswith("/") and ".." not in w
               for w in MANIFEST["command"])
    t = MANIFEST["run_seconds"]
    assert isinstance(t, int) and 1 <= t <= 51
    assert (2 + 14 * 24) * (t + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines():
    names = [c["name"] for c in MANIFEST["configs"]] + [w["name"] for w in MANIFEST["workloads"]]
    names += [m["name"] for m in _metrics()]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in MANIFEST["workloads"]]:
        assert NAME.match(n), n
    for m in _metrics():
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["why"]) and LINE.match(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert LINE.match(w["why"]) and w["chips"] == 1
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_metric_sets():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert tuple(e2e) == E2E
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert LINE.match(m["layer"])
        layers.setdefault(m["layer"], []).append(m["name"])
        assert m["moves"] in e2e


def _reports(cell):
    return [m["name"] for m in MANIFEST["end_to_end"] if cell in m.get("workloads", [cell])]


@pytest.mark.parametrize("cell", gb_fixtures.cells())
def test_each_cell_reports_what_it_must(cell):
    e2e = _reports(cell)
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in MANIFEST["per_layer"] if cell in m.get("workloads", [cell])]
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])


def test_files_are_found_by_name():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    for c in configs.values():
        assert c["file"].startswith("graphbench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert (BENCH / "generators" / f"{cfg['generator']}.py").is_file()
    for w in MANIFEST["workloads"]:
        assert w["config"] in configs
        json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == set(configs)
    for m in MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        for cell in m.get("workloads", []):
            assert cell in gb_fixtures.cells()


@pytest.mark.parametrize("mix", sorted({w["traffic"] for w in MANIFEST["workloads"]}))
def test_traffic_names_program_functions_and_answers(mix):
    import importlib

    from gbharness import main, program
    program.import_program(ROOT)
    traffic = gb_fixtures.traffic(mix)
    algos = program.specs(traffic)
    checks = set()
    for name, spec in algos.items():
        fn = getattr(importlib.import_module(f"repro_torch.{spec['module']}"), spec["function"])
        assert callable(fn), name
        ans = main.load_file(ROOT, "answers", spec["answer"]["kind"])
        assert all(hasattr(ans, a) for a in ("CHECK", "fold", "compare", "reference_answer",
                                              "least_bytes"))
        checks.add(ans.CHECK)
    # every check of the mix is read by one of its answers, and each has a limit
    assert checks == set(traffic["checks"])
    assert traffic["sample_per_algo"] >= 1 and traffic["traced"] >= len(algos)


def test_configs_state_their_vertex_count():
    for c in MANIFEST["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        n = 1 << cfg["scale"] if cfg["generator"] == "kron" else \
            cfg["n_communities"] << cfg["community_scale"]
        assert cfg["num_vertices"] == n and cfg["precision"] == "float32"
        assert isinstance(cfg["graph_seed"], int)
        assert set(c["reduced"]) <= set(cfg["reduced"])


def _sources():
    return sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_era_benchmarks(path):
    assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "repro"}, path
    if "tests" not in path.parts:
        text = path.read_text().replace("graphbench/", "")
        assert "benchmarks/" not in text and "src/repro/" not in text, path


def test_only_program_py_imports_the_program():
    for path in _sources():
        if "tests" in path.parts or path.name == "program.py":
            continue
        assert "repro_torch" not in set(_imports(path)), path
