"""One run of one cell: set-up, the measured (or traced) window, the
comparison with the plain reference, and the result line.

The cell, its configuration and its traffic mix are found by name: the
cell in ``BENCHMARK.json``, the configuration in the file it names, its
generator in ``graphbench/generators/<generator>.py``, the mix in
``graphbench/traffic/<traffic>.json``, the reference and the comparison
of each answer kind in ``graphbench/answers/<kind>.py`` and each
per-layer metric's reader in ``graphbench/metrics/<metric>.py``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import random
import sys
import time
from pathlib import Path

import torch

from . import check, gen, reference, roofline, trace, window
from .program import Program, import_program, load_kernels, specs

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
MAX_PAIRS = 1 << 16   # sources drawn ahead for a window


class RunError(Exception):
    """A run that prints no result: ``code`` is its exit code."""

    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


def bench_dir(root: Path) -> Path:
    return Path(root) / "graphbench"


def load_cell(root: Path, workload: str):
    """``(manifest, cell, config, traffic)`` of a workload."""
    manifest = json.loads((Path(root) / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise RunError(2, f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = json.loads((Path(root) / entry["file"]).read_text())
    traffic = json.loads(
        (bench_dir(root) / "traffic" / f"{cell['traffic']}.json").read_text())
    return manifest, cell, config, traffic


def applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_file(root: Path, folder: str, name: str):
    """The module ``graphbench/<folder>/<name>.py``, found by name."""
    path = bench_dir(root) / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"graphbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_inputs(root, config: dict, traffic: dict, device):
    """The cell's COO on ``device``: ``(src, dst, w or None, n)``, made from
    the configuration's ``graph_seed``.  Every run of a configuration gets
    the same graph and weights, as a deployment serves one data set:
    ``--seed`` draws the sources and their order (``make_plan``), so that a
    seed changes which queries come, not how much work the graph holds."""
    g = gen.generator(config["graph_seed"], device)
    src, dst, n = load_file(root, "generators", config["generator"]).make(config, g, device)
    if n != config["num_vertices"]:
        raise RunError(2, f"the generator made {n} vertices; the configuration "
                          f"states {config['num_vertices']}")
    weighted = any(s["weighted"] for s in specs(traffic).values())
    w = gen.weights(src.numel(), *config["weights"], g, device) if weighted else None
    return src, dst, w, n


def make_plan(src, dst, n: int, config: dict, traffic: dict, seed: int):
    """``plan(k) -> (algo, source)`` of trial ``k``: the mix's algorithms in
    turn, each pair of trials from one source of the spread sequence;
    warm-up trials are ``k = -warmup .. -1``."""
    mix = specs(traffic)
    algos = list(mix)
    if not any(s["source"] for s in mix.values()):
        return lambda k: (algos[k % len(algos)], None)
    rule = traffic["sources"]
    cand = gen.candidates(src, dst, n, rule["rule"], rule["order"], config["undirected"])
    warm = -(-traffic["warmup"] // len(algos))
    pool = gen.sources(cand, random.Random(seed).random(), -warm, warm + MAX_PAIRS)

    def plan(k: int):
        return algos[k % len(algos)], pool[(k // len(algos) + warm) % len(pool)]
    return plan


def symmetric(config: dict, traffic: dict) -> bool:
    """Whether the cell's graph holds both directions of every edge: an
    undirected configuration, or a mix that asks for it."""
    return config["undirected"] or traffic.get("symmetrize", False)


def reference_csr(coo, n: int, config: dict, traffic: dict, device):
    """The reference's own CSR of the generated COO, laid out as the cell
    asks (a directed COO symmetrized holds repeated pairs to drop)."""
    return reference.build_csr(coo[0], coo[1], n, coo[2], device=device,
                               symmetrize=symmetric(config, traffic),
                               dedup=symmetric(config, traffic) and not config["undirected"])


def judge(root, items, csr, traffic: dict, control=None):
    """Readings of every check over ``items`` (``(algo, source, output)``)
    and each item's least bytes (``None`` where its answer kind has no
    bound).  ``control`` (a dtype) puts the reference in that precision in
    the program's place, ignoring the outputs."""
    mix = specs(traffic)
    kinds: dict = {}
    refs: dict = {}
    readings: dict = {}
    least = []
    for algo, source, out in items:
        answer = mix[algo]["answer"]
        kind, args = answer["kind"], answer.get("args", {})
        if kind not in kinds:
            kinds[kind] = load_file(root, "answers", kind)
        ans = kinds[kind]
        key = (kind, source, json.dumps(args, sort_keys=True))
        if key not in refs:
            refs[key] = ans.reference_answer(csr, source, args)
        ref = refs[key]
        least.append(ans.least_bytes(csr, ref))
        if control is not None:
            out = ans.reference_answer(csr, source, args, dtype=control)
        labels = out[0] if isinstance(out, tuple) else out
        value = ans.compare(labels, ref)
        readings[ans.CHECK] = (ans.fold(readings[ans.CHECK], value)
                               if ans.CHECK in readings else value)
    return readings, least


class Stages:
    """Set-up seconds by stage, on the host clock."""

    def __init__(self, t0: float, sync):
        self.t0 = self.last = t0
        self.sync = sync
        self.s: dict = {}

    def mark(self, name: str, sync: bool = True) -> None:
        if sync:
            self.sync()
        now = time.perf_counter()
        self.s[name] = now - self.last
        self.last = now

    def total(self) -> float:
        return self.last - self.t0


def read_metric(root: Path, name: str, ctx: dict):
    return load_file(root, "metrics", name).read(ctx)


def run_cell(root, workload: str, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda", t0: float | None = None, log=sys.stderr) -> dict:
    """Run ``workload`` once and return its result line (a dict).  Raises
    ``RunError`` where no result may be printed."""
    t0 = time.perf_counter() if t0 is None else t0
    root = Path(root)
    manifest, cell, config, traffic = load_cell(root, workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise RunError(3, f"{workload} needs {cell['chips']} CUDA device(s); "
                              f"{torch.cuda.device_count()} available")
        sync = torch.cuda.synchronize
    else:
        def sync():
            pass
    stages = Stages(t0, sync)
    stages.mark("import", sync=False)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
    stages.mark("cuda_init")

    tc = import_program(root)
    load_kernels(dev)
    stages.mark("kernels")

    src, dst, w, n = make_inputs(root, config, traffic, dev)
    m_input = src.numel()
    plan = make_plan(src, dst, n, config, traffic, seed)
    stages.mark("generate")

    coo = (src.cpu().numpy(), dst.cpu().numpy(),
           None if w is None else w.cpu().numpy())
    del src, dst, w
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    stages.mark("host_copy")

    build: dict = {}
    prog = Program(tc, coo, n, symmetrize=symmetric(config, traffic),
                   algos=specs(traffic), tier=traffic.get("tier"), device=dev, timings=build)
    stages.mark("from_coo_and_tier" if traffic.get("tier") else "from_coo")

    for k in range(-traffic["warmup"], 0):
        prog.call(*plan(k))
        sync()
    stages.mark("warmup")
    setup_s = stages.total()

    # the window's own peak, apart from set-up's (the build's)
    peak_setup = peak_window = 0
    if dev.type == "cuda":
        peak_setup = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    sample = window.Sample(seed, traffic["sample_per_algo"])
    kept: list = []
    fetch0, loops0 = prog.fetches(), prog.loop_launches()
    if traced:
        prof = trace.profiler(dev)

        def call(algo, source):
            with torch.profiler.record_function(trace.TRIAL):
                out = prog.call(algo, source)
                sync()
            return out
        with prof:
            win = window.run(plan, call, sync, None, max_trials=traffic["traced"],
                             on_trial=lambda t, o: kept.append((t, o)),
                             captures=prog.captures)
        summary = trace.summarise(prof.events())
    else:
        win = window.run(plan, prog.call, sync, seconds, on_trial=sample.offer,
                         captures=prog.captures)
        kept = sample.items()
    fetches, loops = prog.fetches() - fetch0, prog.loop_launches() - loops0

    if dev.type == "cuda":
        peak_window = torch.cuda.max_memory_allocated(dev)
    peak = max(peak_setup, peak_window)
    found = loaded_forbidden()
    if found:
        raise RunError(4, "modules of JAX or the JAX package are loaded: " + ", ".join(found))

    # the program's state goes before the reference runs
    prog.close()
    del prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    csr = reference_csr(coo, n, config, traffic, dev)
    readings, least = judge(root, [(t.algo, t.source, out) for t, out in kept], csr, traffic)
    ref_s = time.perf_counter() - t_ref
    limits = traffic["checks"]
    correct = check.verdict(readings, limits)

    log.write("setup stages (s): " + ", ".join(f"{k} {v:.4f}" for k, v in stages.s.items())
              + f"; setup_s {setup_s:.4f}; from_coo stages (s): "
              + ", ".join(f"{k} {v:.4f}" for k, v in build.items()) + "\n")
    by_algo = {}
    for t in win.trials:
        by_algo.setdefault(t.algo, []).append(t.wall * 1e3)
    log.write(f"window: {len(win.trials)} trials in {win.seconds:.4f} s ("
              + "; ".join(f"{a} {len(v)}, ms min {min(v):.3f} median "
                          f"{sorted(v)[len(v) // 2]:.3f} max {max(v):.3f}"
                          for a, v in by_algo.items())
              + f"); rung loops captured inside it: {win.captures}; "
              f"reference: {len(kept)} trials compared in {ref_s:.2f} s; device peak "
              f"GiB: set-up {peak_setup / 2**30:.4f}, window {peak_window / 2**30:.4f}\n")

    log.write("trial walls (ms, in order): "
              + " ".join(f"{t.algo[0]}{t.wall * 1e3:.1f}" for t in win.trials) + "\n")

    if traced:
        ctx = dict(cell=workload, config=config, traffic=traffic, build=build,
                   stages=stages.s, trials=win.trials, fetches=fetches,
                   loop_launches=loops,
                   trace=summary, least_bytes=least, peak_window_bytes=peak_window,
                   hbm_bytes_per_s=roofline.HBM_BYTES_PER_S)
        metrics = {}
        for m in manifest["per_layer"]:
            if applies(m, workload):
                v = read_metric(root, m["name"], ctx)
                if v is not None:
                    metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        values = dict(
            gteps=lambda: window.gteps(win.trials, win.seconds, m_input),
            trial_ms_p95=lambda: window.trial_ms_p95(win.trials),
            solve_s=lambda: window.solve_s(win.trials, win.seconds),
            peak_gib=lambda: peak / 2**30,
            setup_s=lambda: setup_s)
        metrics = {m["name"]: dict(value=values[m["name"]](), unit=m["unit"])
                   for m in manifest["end_to_end"] if applies(m, workload)}

    devinfo = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                   kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   count=cell["chips"], memory_peak_bytes=peak)
    result = dict(correct=correct, attempted=len(win.trials), failed=0,
                  metrics=metrics, device=devinfo)
    if traced:
        devinfo["busy_s"] = summary["busy_s"] or 0.0
        devinfo["window_s"] = summary["window_s"]
        result["breakdown"] = dict(device_ops=[list(x) for x in summary["device_ops"]],
                                   idle_gaps=[list(x) for x in summary["idle_gaps"]])
    result["checks"] = {k: dict(value=readings.get(k), limit=v) for k, v in limits.items()}
    for k, v in result["checks"].items():
        log.write(f"check {k}: {v['value']} (limit {v['limit']})\n")
    return result


def main(argv=None, t0: float | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one graphbench cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[2]
    build = root / "build" / "graphbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    try:
        result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                          t0=t0)
    except RunError as err:
        print(f"graphbench: {err}", file=sys.stderr)
        return err.code
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
