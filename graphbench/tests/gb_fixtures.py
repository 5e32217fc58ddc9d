"""Shared pieces of the graphbench tests: the harness on ``sys.path`` and
a checkout whose configurations are cut to sizes a CPU runs in seconds
(the manifest, traffic mixes and metric readers are the real ones)."""

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"kron24": dict(scale=9, num_vertices=512),
        "crawl8m": dict(n_communities=8, community_scale=6, num_vertices=512)}


def tiny_root(tmp: Path) -> Path:
    """A checkout under ``tmp`` with every configuration cut to TINY."""
    (tmp / "graphbench" / "configs").mkdir(parents=True)
    for d in ("traffic", "metrics", "answers", "generators", "gbharness"):
        # bytecode that another test process may be writing is not copied
        shutil.copytree(BENCH / d, tmp / "graphbench" / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (tmp / "src").symlink_to(ROOT / "src")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(TINY[c["name"]])
        (tmp / c["file"]).write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp


def cells():
    return [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def traffic(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())
