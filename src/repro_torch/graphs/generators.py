"""Synthetic graph generators reproducing the paper's input taxonomy (Table 3).

The paper's central data observation: synthetic rmat/kron graphs have tiny
diameter (6–7) while real web-crawls have huge diameter (498–5274), and the
two regimes favour different algorithm classes.  We therefore provide both:

* ``rmat`` / ``kron``   — scale-free, low diameter (graph500 parameters).
* ``web_crawl_like``    — power-law degrees *and* high diameter: a long chain
  of communities with heavy intra-community RMAT structure and sparse
  next-community links, mimicking crawl frontiers (host-locality + deep paths).
* ``erdos`` / ``grid2d`` / ``path`` — regular baselines and test fixtures.

All generators are host-side numpy (the data pipeline layer), returning COO
arrays for ``core.graph.from_coo``.
"""

from __future__ import annotations

import numpy as np


def _dedup(src, dst, n):
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src.astype(np.int64) * n + dst
    _, first = np.unique(key, return_index=True)
    return src[first], dst[first]


def rmat(
    scale: int,
    edge_factor: int = 16,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
) -> tuple[np.ndarray, np.ndarray, int]:
    """RMAT generator with graph500 defaults (a,b,c,d=0.05)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    abc = a + b + c
    for bit in range(scale):
        r = rng.random(m)
        go_right = (r > a) & (r <= ab) | (r > abc)
        go_down = r > ab
        src = src * 2 + go_down.astype(np.int64)
        dst = dst * 2 + go_right.astype(np.int64)
    src, dst = _dedup(src, dst, n)
    return src, dst, n


def kron(scale: int, edge_factor: int = 16, seed: int = 0):
    """Kronecker-style generator — same recursive scheme, symmetric probs."""
    return rmat(scale, edge_factor, seed, a=0.57, b=0.19, c=0.19)


def erdos(n: int, m: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    src, dst = _dedup(src, dst, n)
    return src, dst, n


def grid2d(rows: int, cols: int):
    n = rows * cols
    idx = np.arange(n).reshape(rows, cols)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()])
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()])
    e = np.concatenate([right, down], axis=1)
    return e[0], e[1], n


def path(n: int):
    src = np.arange(n - 1)
    return src, src + 1, n


def web_crawl_like(
    n_communities: int = 64,
    community_scale: int = 6,
    edge_factor: int = 8,
    inter_links: int = 3,
    seed: int = 0,
):
    """High-diameter power-law graph: RMAT communities chained into a long path
    with a few forward links per community (diameter ≈ n_communities · d_c)."""
    rng = np.random.default_rng(seed)
    c_n = 1 << community_scale
    srcs, dsts = [], []
    for ci in range(n_communities):
        s, d, _ = rmat(community_scale, edge_factor, seed=seed * 977 + ci)
        srcs.append(s + ci * c_n)
        dsts.append(d + ci * c_n)
        if ci + 1 < n_communities:
            u = rng.integers(0, c_n, inter_links) + ci * c_n
            v = rng.integers(0, c_n, inter_links) + (ci + 1) * c_n
            srcs.append(u)
            dsts.append(v)
            srcs.append(v)  # a back link keeps it connected for CC
            dsts.append(u)
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    n = n_communities * c_n
    src, dst = _dedup(src, dst, n)
    return src, dst, n


def random_weights(m: int, seed: int = 0, lo: float = 1.0, hi: float = 8.0):
    """The paper: 'all graphs are unweighted, so we generate random weights'."""
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, m).astype(np.float32)


# ---- scaled stand-ins for the paper's Table 3 suite -------------------------
# (name → builder). True inputs are 136–986 GB web-crawls; these mirror their
# structural contrast (low vs high diameter, heavy skew) at CPU-test scale.
def table3_suite(scale_shift: int = 0):
    return {
        "kron30": lambda: kron(10 + scale_shift, 16, seed=1),
        "rmat32": lambda: rmat(11 + scale_shift, 16, seed=2),
        "clueweb12": lambda: web_crawl_like(24, 5, 12, 3, seed=3),
        "uk14": lambda: web_crawl_like(48, 4, 12, 2, seed=4),
        "wdc12": lambda: web_crawl_like(96, 4, 9, 2, seed=5),
    }
