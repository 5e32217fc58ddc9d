"""The port's flash-attention, block-sparse SpMM and embedding-bag wrappers
against the JAX package's Pallas kernels, and the port's ``kernels_bench``
against the reference's.

The same inputs (numpy, from seeds) go through the JAX kernels in interpret
mode, as ``tests/test_kernels.py`` runs them, and through the port's
wrappers on CPU tensors, which take their plain versions.  Every
parametrised case of ``tests/test_kernels.py`` for the three kernels is
here, in both dtypes.

Tolerances are the reference's own (``TOL``): f32 2e-5, bf16 2e-2; x10 for
SpMM against its kernel and oracle and x20 against the edge list, x5 for
the embedding bag; bf16 results may differ by one rounding of the output.
``to_bsr`` is held bitwise: it is the same numpy code.
"""

import functools
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import benchmarks.kernels_bench as jbench  # noqa: E402
from repro.kernels.embedding_bag.embedding_bag import embedding_bag as j_eb  # noqa: E402
from repro.kernels.embedding_bag.ops import embedding_bag as j_eb_ops  # noqa: E402
from repro.kernels.embedding_bag.ref import embedding_bag_ref as j_eb_ref  # noqa: E402
from repro.kernels.flash_attention.flash_attention import flash_attention_bhsd as j_fa  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as j_fa_ops  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as j_attn_ref  # noqa: E402
from repro.kernels.spmm_bsr.ops import BsrMatrix as JBsrMatrix  # noqa: E402
from repro.kernels.spmm_bsr.ref import spmm_ref as j_spmm_ref  # noqa: E402
from repro.kernels.spmm_bsr.spmm_bsr import spmm_bsr as j_spmm, to_bsr as j_to_bsr  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.benchmarks import kernels_bench as tbench  # noqa: E402
from repro_torch.kernels.embedding_bag import ref as t_eb_ref  # noqa: E402
from repro_torch.kernels.embedding_bag.embedding_bag import embedding_bag as t_eb  # noqa: E402
from repro_torch.kernels.embedding_bag.ops import embedding_bag as t_eb_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as t_fa_ref  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import flash_attention_bhsd as t_fa  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import MAX_SPLITS, kv_splits, split_ranges  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention as t_fa_ops  # noqa: E402
from repro_torch.kernels.spmm_bsr import ref as t_spmm_ref  # noqa: E402
from repro_torch.kernels.spmm_bsr.ops import BsrMatrix as TBsrMatrix  # noqa: E402
from repro_torch.kernels.spmm_bsr.spmm_bsr import spmm_bsr as t_spmm, to_bsr as t_to_bsr  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
J_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def J(a, dtype=None):
    return jnp.asarray(a, J_DTYPE[dtype] if dtype else None)


def T(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(T_DTYPE[dtype]) if dtype else t


def f32(x):
    """numpy f32 of a JAX array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # the cases of tests/test_kernels.py::test_flash_attention
    (2, 128, 64, True, None, 64, 64),
    (1, 256, 128, True, None, 128, 128),
    (2, 192, 32, True, None, 128, 64),   # non-multiple seq (padding)
    (2, 256, 64, True, 64, 64, 64),      # sliding window
    (1, 128, 64, False, None, 64, 128),  # bidirectional
    (3, 96, 16, True, 32, 32, 32),
    # head widths of the repo's configs that are not powers of two
    (2, 160, 80, True, None, 64, 64),    # stablelm-3b's d_head
    (2, 200, 120, True, 48, 64, 64),     # h2o-danube-3-4b's d_head, windowed
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,s,d,causal,window,bq,bk", FLASH_CASES)
def test_flash_attention_matches_jax(dtype, bh, s, d, causal, window, bq, bk):
    rng = np.random.default_rng(bh * 1000 + s + d)
    q, k, v = (rng.normal(size=(bh, s, d)) for _ in range(3))
    kw = dict(causal=causal, window=window)
    want = j_fa(J(q, dtype), J(k, dtype), J(v, dtype), block_q=bq, block_k=bk,
                interpret=True, **kw)
    got = t_fa(T(q, dtype), T(k, dtype), T(v, dtype), block_q=bq, block_k=bk, **kw)
    assert got.dtype == T_DTYPE[dtype] and got.shape == (bh, s, d)
    close(got, want, TOL[dtype])
    # the port's oracle against the reference's, and the kernel against both
    ref = t_fa_ref.attention_ref(T(q, dtype), T(k, dtype), T(v, dtype), **kw)
    close(ref, j_attn_ref(J(q, dtype), J(k, dtype), J(v, dtype), **kw), TOL[dtype])
    close(got, ref, TOL[dtype])


@pytest.mark.parametrize("causal,window", [(True, None), (True, 8), (False, None)])
def test_flash_attention_bshd_wrapper_matches_jax(causal, window):
    rng = np.random.default_rng(3)
    B, S, H, d = 2, 40, 3, 16
    q, k, v = (rng.normal(size=(B, S, H, d)).astype(np.float32) for _ in range(3))
    kw = dict(causal=causal, window=window, block_q=16, block_k=16)
    want = j_fa_ops(J(q), J(k), J(v), interpret=True, **kw)
    got = t_fa_ops(T(q), T(k), T(v), **kw)
    assert got.shape == (B, S, H, d)
    close(got, want, TOL["float32"])


def test_attention_ref_rows_are_the_full_rows():
    rng = np.random.default_rng(4)
    q, k, v = (T(rng.normal(size=(2, 70, 8)).astype(np.float32)) for _ in range(3))
    rows = torch.tensor([0, 5, 31, 69])
    full = t_fa_ref.attention_ref(q, k, v, causal=True, window=9)
    part = t_fa_ref.attention_ref(q, k, v, causal=True, window=9, rows=rows)
    assert torch.equal(part, full[:, rows])


def _tensor_core_model(q, k, v, causal, window):
    """The bf16 tensor-core kernel's arithmetic (``flash_tc_kernel`` in
    ``csrc/flash_attention.cu``) in plain torch: bf16 q and k, f32 raw
    scores, 64-key tiles through an online softmax on the raw max with
    p = 2^(s c - m c), c = scale * log2(e), p split into bf16 hi and lo,
    both products against bf16 v summed in f32, one rounding of the
    output."""
    bh, s, d = q.shape
    scale = float(np.float32(1.0 / math.sqrt(d)))       # as ctypes passes it
    scale_log2 = float(np.float32(scale * math.log2(math.e)))
    qf, kf, vf = q.float(), k.float(), v.float()
    qpos = torch.arange(s)[:, None]
    m = torch.full((bh, s, 1), t_fa_ref.NEG_INF)
    l = torch.zeros((bh, s, 1))
    acc = torch.zeros((bh, s, d))
    for k0 in range(0, s, 64):
        mask = t_fa_ref._mask(qpos, torch.arange(k0, min(k0 + 64, s))[None, :], s,
                              causal, window)
        kb, vb = kf[:, k0:k0 + 64], vf[:, k0:k0 + 64]
        raw = torch.where(mask, qf @ kb.transpose(1, 2), t_fa_ref.NEG_INF)
        m_new = torch.maximum(m, raw.amax(-1, keepdim=True))
        p = torch.where(mask, torch.exp2(raw * scale_log2 - m_new * scale_log2), 0.0)
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        assert bool(((hi + lo - p).abs() <= 2.0**-16 * p).all())
        corr = torch.exp2((m - m_new) * scale_log2)
        l = corr * l + p.sum(-1, keepdim=True)
        acc = corr * acc + hi @ vb + lo @ vb
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(torch.bfloat16)


@pytest.mark.parametrize("bh,s,d,causal,window,bq,bk", FLASH_CASES)
def test_tensor_core_arithmetic_matches_jax_oracle(bh, s, d, causal, window, bq, bk):
    """p carried as bf16 hi + lo keeps the bf16 kernel within chip_smoke.py's
    limit of the reference's f32 oracle: 8e-3 |want| + 1e-3 rms(want)."""
    rng = np.random.default_rng(bh * 1000 + s + d)
    q, k, v = (rng.normal(size=(bh, s, d)) for _ in range(3))
    got = _tensor_core_model(T(q, "bfloat16"), T(k, "bfloat16"), T(v, "bfloat16"),
                             causal, window)
    want = f32(j_attn_ref(J(q, "bfloat16"), J(k, "bfloat16"), J(v, "bfloat16"),
                          causal=causal, window=window))
    err = np.abs(f32(got) - want)
    rms = np.sqrt(np.mean(want.astype(np.float64) ** 2))
    assert got.dtype == torch.bfloat16 and got.shape == (bh, s, d)
    assert (err <= 8e-3 * np.abs(want) + 1e-3 * rms).all(), float(err.max())


PERM8 = (0, 2, 4, 6, 1, 3, 5, 7)   # the key that column c of an 8-key P.V step stands for


def _tf32(x):
    """``tf32`` of ``csrc/flash_attention.cu``: half a TF32 ulp added to the
    bits, the 13 below TF32's mantissa cleared."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _truncated(x):
    """x truncated to TF32, as the kernel's AND does: the low 13 bits cleared."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _mm_split(a, b):
    """a @ b as ``mma_split`` computes it: hi = tf32(x) and lo = x - hi
    truncated to TF32 of both operands, lo.hi + hi.lo + hi.hi (each product
    exact in f32)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _truncated(a - a_hi), _truncated(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _f32_kernel_model(q, k, v, causal, window, splits):
    """The f32 kernel's arithmetic (``flash_f32_kernel`` in
    ``csrc/flash_attention.cu``, its cluster merge included) in plain
    torch: each query tile's split shares of ``split_ranges`` in 64-key
    tiles (K and V zero past S); raw scores and P V in split TF32
    (``_mm_split``), P V over each 8-key step in the kernel's key order
    (column c is key PERM8[c]); the online softmax on the raw max with
    p = 2^(s c - m c), c = scale * log2(e), rounded once as the kernel's
    FMA; each share's (m, l, acc) merged with weights 2^((m_i - max m) c)
    and out = acc / max(l, 1e-30)."""
    bh, s, d = q.shape
    scale = float(np.float32(1.0 / math.sqrt(d)))       # as ctypes passes it
    c = float(np.float32(scale * math.log2(math.e)))
    s_pad = -(-s // 64) * 64
    qf, kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, s_pad - s)) for t in (q, k, v))
    order = torch.tensor([8 * (i // 8) + PERM8[i % 8] for i in range(64)])
    out = torch.empty((bh, s, d))
    for t, shares in enumerate(split_ranges(s, causal, window, splits)):
        q0 = 64 * t
        qpos = torch.arange(q0, q0 + 64)[:, None]
        parts = []
        for lo, hi in shares:
            m = torch.full((bh, 64, 1), t_fa_ref.NEG_INF)
            l = torch.zeros((bh, 64, 1))
            acc = torch.zeros((bh, 64, d))
            for k0 in range(64 * lo, 64 * hi, 64):
                kb, vb = kf[:, k0:k0 + 64], vf[:, k0:k0 + 64]
                mask = t_fa_ref._mask(qpos, torch.arange(k0, k0 + 64)[None, :], s, causal,
                                      window)
                raw = torch.where(mask, _mm_split(qf[:, q0:q0 + 64], kb.transpose(1, 2)),
                                  t_fa_ref.NEG_INF)
                m_new = torch.maximum(m, raw.amax(-1, keepdim=True))
                arg = (raw.double() * c - (m_new * c).double()).float()
                p = torch.where(mask, torch.exp2(arg), 0.0)
                corr = torch.exp2((m - m_new) * c)
                l = corr * l + p.sum(-1, keepdim=True)
                acc = corr * acc + _mm_split(p[..., order], vb[:, order])
                m = m_new
            parts.append((m, l, acc))
        ms, ls, accs = (torch.stack(x) for x in zip(*parts))
        w = torch.exp2((ms - ms.amax(0)) * c)
        tile = (w * accs).sum(0) / (w * ls).sum(0).clamp_min(1e-30)
        out[:, q0:q0 + 64] = tile[:, :min(64, s - q0)]
    return out


@functools.lru_cache(maxsize=None)
def _jax_f32(bh, s, d, causal, window, bq, bk):
    """The f32 inputs of ``test_flash_attention_matches_jax``'s case and the
    JAX package's kernel (interpret mode) and oracle on them."""
    rng = np.random.default_rng(bh * 1000 + s + d)
    q, k, v = (rng.normal(size=(bh, s, d)).astype(np.float32) for _ in range(3))
    kw = dict(causal=causal, window=window)
    kernel = f32(j_fa(J(q), J(k), J(v), block_q=bq, block_k=bk, interpret=True, **kw))
    return (q, k, v), kernel, f32(j_attn_ref(J(q), J(k), J(v), **kw))


@pytest.mark.parametrize("splits", [1, 2, 5])
@pytest.mark.parametrize("bh,s,d,causal,window,bq,bk", FLASH_CASES)
def test_f32_kernel_arithmetic_matches_jax(splits, bh, s, d, causal, window, bq, bk):
    """Split TF32 in both products, the permuted keys of P V and the merge
    of 1, 2 or 5 key-range splits (5 leaves some shares empty) keep the f32
    kernel within the reference's 2e-5 of its kernel and its oracle."""
    (q, k, v), kernel, oracle = _jax_f32(bh, s, d, causal, window, bq, bk)
    got = _f32_kernel_model(T(q), T(k), T(v), causal, window, splits)
    assert got.dtype == torch.float32 and got.shape == (bh, s, d)
    close(got, kernel, TOL["float32"])
    close(got, oracle, TOL["float32"])


def test_f32_p_accumulator_fragment_is_the_pv_a_fragment():
    """mma.m16n8k8 TF32: lane (g, tig)'s accumulator holds (g, 2 tig),
    (g, 2 tig + 1), (g + 8, 2 tig), (g + 8, 2 tig + 1); its A fragment is
    (g, tig), (g + 8, tig), (g, tig + 4), (g + 8, tig + 4) and its B
    fragment rows tig and tig + 4.  With column c standing for key
    PERM8[c], the kernel's (c0, c2, c1, c3) is the A fragment and its V
    rows 2 tig, 2 tig + 1 are B's."""
    assert sorted(PERM8) == list(range(8))
    for lane in range(32):
        g, tig = lane >> 2, lane & 3
        acc = [(g, 2 * tig), (g, 2 * tig + 1), (g + 8, 2 * tig), (g + 8, 2 * tig + 1)]
        a = [(g, tig), (g + 8, tig), (g, tig + 4), (g + 8, tig + 4)]
        assert [acc[i] for i in (0, 2, 1, 3)] == [(r, PERM8[col]) for r, col in a]
        assert (PERM8[tig], PERM8[tig + 4]) == (2 * tig, 2 * tig + 1)


def test_tf32_split_keeps_f32_products_to_2_pow_minus_20():
    """hi + lo carries x to 2^-21; the three products
    of _mm_split reach f64's product to 2^-20 of |a| |b|, where one TF32
    product misses by about 2^-11."""
    rng = np.random.default_rng(27)
    a, b = (T(rng.normal(size=(64, 64)).astype(np.float32)) for _ in range(2))
    hi = _tf32(a)
    assert bool(((hi + _truncated(a - hi) - a).abs() <= 2.0**-21 * a.abs()).all())
    exact = a.double() @ b.double()
    scale = a.abs().double() @ b.abs().double()
    assert float(((_mm_split(a, b).double() - exact).abs() / scale).max()) <= 2.0**-20
    assert float(((_tf32(a) @ _tf32(b)).double() - exact).abs().div(scale).max()) > 2.0**-14


# (bh, S, causal, window): kernels_bench's f32 row, train_lm's model_100m,
# danube's train_4k, FLASH_SMALL's two, and edges of the chooser (1 x 1024:
# 16 blocks would want 9 splits, a cluster holds 8)
SPLIT_CASES = [(2, 256, True, None), (128, 256, True, None), (32, 4096, True, 4096),
               (4, 200, True, 48), (2, 300, False, None), (1, 64, True, None),
               (1, 1000, True, 100), (3, 96, True, 32), (1, 3000, False, 300),
               (33, 256, True, None), (32, 257, True, None), (1, 8192, True, None),
               (1, 1024, False, None)]


@pytest.mark.parametrize("bh,s,causal,window", SPLIT_CASES)
def test_f32_kv_splits_cover_each_visible_key_tile_once(bh, s, causal, window):
    """kv_splits' count and every other count's shares: each query tile's
    shares hold each key tile with a visible key once, in order, and no
    other; the count is never above the most tiles a query tile sees, is 1
    once bh x ceil(S / 64) blocks fill the card's 132 SMs, and fills it
    otherwise unless the tiles or a cluster's 8 blocks run out."""
    n_qt = -(-s // 64)
    chosen = kv_splits(bh, s, causal, window)
    kpos = torch.arange(n_qt * 64)[None, :]
    want = []   # per query tile, the key tiles holding a key one of its queries sees
    for q0 in range(0, s, 64):
        qpos = torch.arange(q0, min(q0 + 64, s))[:, None]
        seen = t_fa_ref._mask(qpos, kpos, s, causal, window).any(0)
        want.append(torch.nonzero(seen.view(n_qt, 64).any(1)).flatten().tolist())
    for splits in sorted({1, 2, 3, 7, chosen}):
        shares = split_ranges(s, causal, window, splits)
        assert [len(x) for x in shares] == [splits] * n_qt
        assert [[kt for lo, hi in x for kt in range(lo, hi)] for x in shares] == want
    most = max(len(x) for x in want)
    assert 1 <= chosen <= min(most, MAX_SPLITS)
    if bh * n_qt >= 132:
        assert chosen == 1
    else:
        assert bh * n_qt * chosen >= 132 or chosen == min(most, MAX_SPLITS)


def test_tensor_core_launch_count_is_reset_and_left_alone_on_the_cpu():
    t_fa.tc_launches = 5
    tk.reset_launches()
    assert t_fa.tc_launches == 0
    q = T(np.random.default_rng(15).normal(size=(1, 40, 16)), "bfloat16")
    t_fa(q, q, q)
    assert t_fa.tc_launches == 0 and t_fa.launches == 0


@pytest.mark.parametrize("s,window,bq,bk", [(100, None, 64, 48), (64, 0, 64, 64)])
def test_flash_attention_rejects_what_the_reference_gets_wrong(s, window, bq, bk):
    """A key block that does not divide S padded to block_q (the reference
    drops the last keys) and a window below 1 raise."""
    q = torch.zeros((1, s, 8))
    with pytest.raises(ValueError):
        t_fa(q, q, q, window=window, block_q=bq, block_k=bk)


# ---------------------------------------------------------------------------
# block-sparse SpMM
# ---------------------------------------------------------------------------

SPMM_CASES = [
    (256, 1200, 64, 128, 128),
    (300, 800, 32, 128, 128),    # n not a block multiple
    (512, 4000, 128, 128, 128),
    (256, 600, 16, 64, 64),      # smaller blocks
]


def _random_graph(rng, n, m):
    return (rng.integers(0, n, m), rng.integers(0, n, m),
            rng.normal(size=m).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,m,f,bm,bk", SPMM_CASES)
def test_spmm_bsr_matches_jax(dtype, n, m, f, bm, bk):
    rng = np.random.default_rng(n + m + f)
    src, dst, w = _random_graph(rng, n, m)
    idx, blocks = t_to_bsr(src, dst, w, n, bm=bm, bk=bk)
    jidx, jblocks = j_to_bsr(src, dst, w, n, bm=bm, bk=bk)
    x = rng.normal(size=(((n + bk - 1) // bk) * bk, f))
    want = j_spmm(jidx, jblocks.astype(J_DTYPE[dtype]), J(x, dtype), interpret=True)
    got = t_spmm(T(idx), T(blocks, dtype), T(x, dtype))
    assert got.dtype == T_DTYPE[dtype] and got.shape == (idx.shape[0] * bm, f)
    close(got, want, TOL[dtype] * 10)
    # the oracle (blocks in f32, x in the dtype), both packages
    ref = t_spmm_ref.spmm_ref(T(idx), T(blocks), T(x, dtype))
    close(ref, j_spmm_ref(jidx, jblocks, J(x, dtype)), TOL[dtype] * 10)
    close(got, ref, TOL[dtype] * 10)
    # the edge-list semantics out[dst] += w * x[src]
    coo = t_spmm_ref.spmm_coo_ref(T(src), T(dst), T(w), n, T(x, dtype).float())
    close(got[:n], coo, TOL[dtype] * 20)


@pytest.mark.parametrize("blocks_dtype,x_dtype", [("float32", "bfloat16"),
                                                  ("bfloat16", "float32")])
def test_spmm_bsr_mixed_dtypes_match_jax(blocks_dtype, x_dtype):
    """blocks and x in different dtypes; out takes x's."""
    rng = np.random.default_rng(8)
    n, f = 200, 24
    src, dst, w = _random_graph(rng, n, 900)
    idx, blocks = t_to_bsr(src, dst, w, n, bm=64, bk=64)
    x = rng.normal(size=(256, f))
    want = j_spmm(J(idx), J(blocks, blocks_dtype), J(x, x_dtype), interpret=True)
    got = t_spmm(T(idx), T(blocks, blocks_dtype), T(x, x_dtype))
    assert got.dtype == T_DTYPE[x_dtype]
    close(got, want, TOL["bfloat16"] * 10)


@pytest.mark.parametrize("n,m,bm,bk,seed", [(100, 400, 32, 32, 0), (300, 2000, 128, 64, 1),
                                            (1000, 50, 128, 128, 2), (64, 3000, 16, 16, 3)])
def test_to_bsr_bitwise_equal_to_jax_with_duplicate_edges(n, m, bm, bk, seed):
    rng = np.random.default_rng(seed)
    src, dst, w = _random_graph(rng, n, m)
    src, dst, w = (np.concatenate([a, a[: m // 3]]) for a in (src, dst, w))  # duplicates
    idx, blocks = t_to_bsr(src, dst, w, n, bm=bm, bk=bk)
    jidx, jblocks = j_to_bsr(src, dst, w, n, bm=bm, bk=bk)
    assert idx.dtype == np.int32 and blocks.dtype == np.float32
    assert np.array_equal(idx, np.asarray(jidx))
    assert np.array_equal(blocks.view(np.int32), np.asarray(jblocks).view(np.int32))


def test_bsr_matrix_matmul_matches_jax():
    rng = np.random.default_rng(9)
    n, f = 300, 16
    src, dst, w = _random_graph(rng, n, 1500)
    x = rng.normal(size=(384, f)).astype(np.float32)
    want = JBsrMatrix(src, dst, w, n).matmul(J(x), interpret=True)
    tm = TBsrMatrix(src, dst, w, n, device="cpu")
    got = tm.matmul(T(x))
    assert got.shape == (n, f) and tm.indices.dtype == torch.int32
    close(got, want, TOL["float32"] * 10)


# ---------------------------------------------------------------------------
# embedding bag
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,v,d", [(8, 10, 100, 128), (4, 1, 50, 64), (16, 7, 1000, 256)])
def test_embedding_bag_matches_jax(dtype, b, l, v, d):
    rng = np.random.default_rng(b * l + v + d)
    ids = rng.integers(0, v, (b, l)).astype(np.int32)
    ids[0, -1] = -1  # padding slot
    w = rng.normal(size=(b, l)).astype(np.float32)
    table = rng.normal(size=(v, d))
    want = j_eb(J(ids), J(w), J(table, dtype), interpret=True)
    got = t_eb(T(ids), T(w), T(table, dtype))
    assert got.dtype == T_DTYPE[dtype] and got.shape == (b, d)
    close(got, want, TOL[dtype] * 5)
    ref = t_eb_ref.embedding_bag_ref(T(ids), T(w), T(table, dtype))
    close(ref, j_eb_ref(J(ids), J(w), J(table, dtype)), TOL[dtype] * 5)


def test_embedding_bag_all_padding_bag_is_zero():
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 30, (5, 6)).astype(np.int32)
    ids[2] = -1
    w = rng.normal(size=(5, 6)).astype(np.float32)
    table = rng.normal(size=(30, 16)).astype(np.float32)
    got = t_eb(T(ids), T(w), T(table))
    assert torch.equal(got[2], torch.zeros(16))
    close(got, j_eb(J(ids), J(w), J(table), interpret=True), TOL["float32"] * 5)


def test_embedding_bag_clamps_ids_past_the_table_as_the_oracle_does():
    rng = np.random.default_rng(12)
    v = 40
    ids = rng.integers(0, v, (6, 5)).astype(np.int32)
    ids[1, 2], ids[3, 0], ids[4, 4] = v, v + 7, 2**31 - 1
    ids[5, 1] = -1
    w = rng.normal(size=(6, 5)).astype(np.float32)
    table = rng.normal(size=(v, 32)).astype(np.float32)
    want = j_eb_ref(J(ids), J(w), J(table))
    close(t_eb(T(ids), T(w), T(table)), want, TOL["float32"] * 5)
    close(t_eb_ref.embedding_bag_ref(T(ids), T(w), T(table)), want, TOL["float32"] * 5)
    clamped = np.where(ids >= v, v - 1, ids).astype(np.int32)
    assert torch.equal(t_eb(T(ids), T(w), T(table)), t_eb(T(clamped), T(w), T(table)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,weighted", [("sum", False), ("mean", False), ("mean", True)])
def test_embedding_bag_modes_match_jax(dtype, mode, weighted):
    rng = np.random.default_rng(13)
    ids = rng.integers(-1, 60, (7, 9)).astype(np.int32)
    ids[3] = -1   # an empty bag: mean divides by max(0, 1e-9)
    w = rng.random(size=(7, 9)).astype(np.float32) if weighted else None
    table = rng.normal(size=(60, 24))
    want = j_eb_ops(J(ids), J(table, dtype), None if w is None else J(w), mode=mode,
                    interpret=True)
    got = t_eb_ops(T(ids), T(table, dtype), None if w is None else T(w), mode=mode)
    assert got.dtype == {"sum": T_DTYPE[dtype], "mean": torch.float32}[mode]
    assert str(want.dtype) == {"sum": dtype, "mean": "float32"}[mode]
    close(got, want, TOL[dtype] * 5)


def test_embedding_bag_rejects_an_unknown_mode():
    with pytest.raises(ValueError):
        t_eb_ops(T(np.zeros((1, 1), np.int32)), T(np.zeros((2, 2), np.float32)), mode="max")


@pytest.mark.parametrize("d,size,want", [(64, 4, 8), (100, 4, 8), (128, 4, 16),
                                          (512, 4, 16), (128, 2, 8), (256, 2, 16)])
def test_embedding_bag_vector_width_keeps_every_lane_busy(d, size, want):
    """16-B row loads where 32 lanes of them fit in a row, else 8-B."""
    from repro_torch.kernels.embedding_bag.embedding_bag import vec_bytes
    assert vec_bytes(d, size) == want


def test_kernel_wrappers_launch_nothing_on_the_cpu():
    tk.reset_launches()
    rng = np.random.default_rng(14)
    q = T(rng.normal(size=(1, 64, 8)).astype(np.float32))
    t_fa(q, q, q)
    idx, blocks = t_to_bsr(np.array([0, 1]), np.array([1, 0]), np.ones(2, np.float32), 4,
                           bm=4, bk=4)
    t_spmm(T(idx), T(blocks), T(np.ones((4, 2), np.float32)))
    t_eb(T(np.zeros((1, 1), np.int32)), T(np.ones((1, 1), np.float32)),
         T(np.ones((2, 2), np.float32)))
    assert set(tk.launch_counts()) == {"edge_relax", "advance", "intersect",
                                       "edge_relax_lanes", "flash_attention",
                                       "spmm_bsr", "embedding_bag"}
    assert all(n == 0 for n in tk.launch_counts().values())


# ---------------------------------------------------------------------------
# kernels_bench: the port's rows against the reference's
# ---------------------------------------------------------------------------

SUBSTRATE_OF = {"jnp": "torch", "pallas": "cuda"}
TIMING_KEYS = {"ref_us"}


def _port_name(jax_name):
    for jsub, tsub in SUBSTRATE_OF.items():
        jax_name = jax_name.replace(f"[{jsub}]", f"[{tsub}]")
    return jax_name


def _derived(text):
    return dict(kv.split("=", 1) for kv in text.split(";"))


@pytest.fixture(scope="module")
def bench_rows():
    """Both suites' rows, each timed callable run once (the timing helper
    is swapped for one call, so the suites stay quick here)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jbench, "time_call",
               lambda fn, *a, **k: (jax.block_until_ready(fn(*a)), 0.0)[1])
    mp.setattr(tbench, "time_call", lambda fn, *a, **k: (fn(*a), 0.0)[1])
    try:
        return jbench.run(), tbench.run(device="cpu")
    finally:
        mp.undo()


def test_kernels_bench_rows_match_the_reference(bench_rows):
    jrows, trows = bench_rows
    assert [r[0] for r in trows] == [_port_name(r[0]) for r in jrows]
    for jr, tr in zip(jrows, trows):
        jd, td = _derived(jr[2]), _derived(tr[2])
        assert set(jd) == set(td), (jr[0], jd, td)
        for key in set(jd) - TIMING_KEYS - {"substrate"}:
            assert jd[key] == td[key], (jr[0], key, jd[key], td[key])
    # on the CPU every wrapper takes its plain version, so the port's BFS
    # says it ran the plain substrate under both
    bfs_rows = [r for r in trows if r[0].startswith("kern/graph_bfs_e2e")]
    assert [_derived(r[2])["substrate"] for r in bfs_rows] == ["torch", "torch"]


def test_chip_smoke_expects_the_reference_rows(bench_rows):
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert list(smoke.KERNELS_BENCH_ROWS) == [_port_name(r[0]) for r in bench_rows[0]]


def test_kernels_bench_cli_writes_the_rows(tmp_path, capsys):
    path = tmp_path / "rows.json"
    assert tbench.main(["--device", "cpu", "--emit-json", str(path)]) == 0
    doc = json.loads(path.read_text())
    printed = capsys.readouterr().out.strip().splitlines()
    assert doc["suite"] == "kernels"
    assert [r["name"] for r in doc["rows"]] == [line.split(",")[0] for line in printed]
    assert len(printed) == 13


def test_kernels_bench_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.run()
