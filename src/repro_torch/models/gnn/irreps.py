"""Real-spherical-harmonic irrep algebra for the equivariant GNNs, as
``repro.models.gnn.irreps``: real spherical harmonics, real
Clebsch-Gordan coefficients, and the channel-wise tensor-product
contraction, at l_max <= 2.

Conventions (the reference's):

* Component order within an irrep of degree l: m = -l..l; l = 1 is
  ``(y, z, x)``.
* SO(3) equivariance; parity is not tracked.
* SH normalisation "component": Y_0 = 1, |Y_l(v)|² = 2l+1 for unit v.

Feature layout: ``{l: (N, mul, 2l+1)}`` dicts (the same ``mul`` for every
l).  The coefficients are built in float64 numpy, copied from the
reference, so ``cg_real`` gives its arrays: the same seed, the same SVD
null vector, the same sign rule.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ...core.graph import _device


# ---------------------------------------------------------------------------
# Clebsch-Gordan (complex, Racah) + real change of basis
# ---------------------------------------------------------------------------

def _f(n: int) -> float:
    return float(math.factorial(n))


def su2_cg(j1, m1, j2, m2, j3, m3) -> float:
    """⟨j1 m1 j2 m2 | j3 m3⟩ via the Racah formula (integer spins only)."""
    if m3 != m1 + m2 or not (abs(j1 - j2) <= j3 <= j1 + j2):
        return 0.0
    if abs(m1) > j1 or abs(m2) > j2 or abs(m3) > j3:
        return 0.0
    pre = math.sqrt(
        (2 * j3 + 1)
        * _f(j3 + j1 - j2) * _f(j3 - j1 + j2) * _f(j1 + j2 - j3)
        / _f(j1 + j2 + j3 + 1)
    )
    pre *= math.sqrt(
        _f(j3 + m3) * _f(j3 - m3)
        * _f(j1 - m1) * _f(j1 + m1)
        * _f(j2 - m2) * _f(j2 + m2)
    )
    s = 0.0
    for k in range(0, j1 + j2 - j3 + 1):
        denoms = [
            k,
            j1 + j2 - j3 - k,
            j1 - m1 - k,
            j2 + m2 - k,
            j3 - j2 + m1 + k,
            j3 - j1 - m2 + k,
        ]
        if any(d < 0 for d in denoms):
            continue
        s += (-1) ** k / np.prod([_f(d) for d in denoms])
    return pre * s


@lru_cache(maxsize=None)
def complex_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    c = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) <= l3:
                c[m1 + l1, m2 + l2, m3 + l3] = su2_cg(l1, m1, l2, m2, l3, m3)
    return c


@lru_cache(maxsize=None)
def u_real(l: int) -> np.ndarray:
    """Change of basis: Y_real = U @ Y_complex (rows m_real = -l..l)."""
    u = np.zeros((2 * l + 1, 2 * l + 1), dtype=np.complex128)
    s2 = 1.0 / math.sqrt(2.0)
    for m in range(-l, l + 1):
        i = m + l
        if m > 0:
            u[i, m + l] = (-1) ** m * s2
            u[i, -m + l] = s2
        elif m == 0:
            u[i, l] = 1.0
        else:  # m < 0
            u[i, -m + l] = -1j * (-1) ** m * s2
            u[i, m + l] = 1j * s2
    return u


@lru_cache(maxsize=None)
def cg_real(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real CG tensor T st. out_k = Σ_ij T[i,j,k] x_i y_j is equivariant when
    x, y, out carry real-SH irreps (components transforming as
    Y_l(Rv) = D_l(R) Y_l(v)).

    Built numerically, convention-free: T spans the (1-dimensional) null
    space of the intertwining constraints
        Σ_ij T[i,j,k] D1[i,a] D2[j,b] = Σ_m D3[k,m] T[a,b,m]
    stacked over a few random rotations (whose D_l come from the same real
    SH used at runtime, so the convention is self-consistent by
    construction).  Normalised to ‖T‖_F = 1, deterministic sign.
    The analytic Racah/complex path above is retained as documentation and
    for the (l,l,0) cross-checks in tests.
    """
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    if (l3 < abs(l1 - l2)) or (l3 > l1 + l2):
        return np.zeros((d1, d2, d3))
    rng = np.random.default_rng(12345)
    rows = []
    I1, I2, I3 = np.eye(d1), np.eye(d2), np.eye(d3)
    for _ in range(3):
        Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(Q) < 0:
            Q[:, 0] *= -1
        D1 = wigner_d_from_rotation(l1, Q)
        D2 = wigner_d_from_rotation(l2, Q)
        D3 = wigner_d_from_rotation(l3, Q)
        # A[(a,b,k),(i,j,m)] = D1[i,a] D2[j,b] δ_mk − δ_ai δ_bj D3[k,m]
        t1 = np.einsum("ia,jb,mk->abkijm", D1, D2, I3)
        t2 = np.einsum("ai,bj,km->abkijm", I1, I2, D3)
        rows.append((t1 - t2).reshape(d1 * d2 * d3, d1 * d2 * d3))
    A = np.concatenate(rows, axis=0)
    _, s, vt = np.linalg.svd(A)
    assert s[-1] < 1e-10 and (s[-2] if len(s) > 1 else 1.0) > 1e-6, (
        l1, l2, l3, s[-3:],
    )
    T = vt[-1].reshape(d1, d2, d3)
    # deterministic sign: largest |entry| is positive
    flat = T.ravel()
    T = T * np.sign(flat[np.argmax(np.abs(flat))])
    return np.ascontiguousarray(T)


# ---------------------------------------------------------------------------
# real spherical harmonics, component normalisation, order m=-l..l
# ---------------------------------------------------------------------------

def sph_harm(l: int, v: torch.Tensor) -> torch.Tensor:
    """v: (..., 3) unit vectors → (..., 2l+1). Component normalisation."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    if l == 0:
        return torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)
    if l == 1:
        return math.sqrt(3.0) * torch.stack([y, z, x], dim=-1)
    if l == 2:
        s15, s5 = math.sqrt(15.0), math.sqrt(5.0)
        return torch.stack(
            [
                s15 * x * y,
                s15 * y * z,
                s5 * 0.5 * (3 * z * z - 1.0),
                s15 * x * z,
                s15 * 0.5 * (x * x - y * y),
            ],
            dim=-1,
        )
    raise NotImplementedError(f"l={l} > 2")


def sph_all(l_max: int, v: torch.Tensor) -> dict:
    return {l: sph_harm(l, v) for l in range(l_max + 1)}


def sph_harm_np(l: int, v: np.ndarray) -> np.ndarray:
    """float64 numpy twin of ``sph_harm`` (used for high-precision tests)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    if l == 0:
        return np.ones(v.shape[:-1] + (1,))
    if l == 1:
        return math.sqrt(3.0) * np.stack([y, z, x], axis=-1)
    if l == 2:
        s15, s5 = math.sqrt(15.0), math.sqrt(5.0)
        return np.stack(
            [s15 * x * y, s15 * y * z, s5 * 0.5 * (3 * z * z - 1.0),
             s15 * x * z, s15 * 0.5 * (x * x - y * y)], axis=-1)
    raise NotImplementedError


def wigner_d_from_rotation(l: int, R: np.ndarray, n_samples: int = 64,
                           seed: int = 0) -> np.ndarray:
    """Empirical D_l(R): solves Y_l(R v) = D Y_l(v) by least squares — used by
    tests to certify equivariance without an analytic Wigner-D."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n_samples, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    A = sph_harm_np(l, v)           # (n, 2l+1)
    B = sph_harm_np(l, v @ R.T)     # (n, 2l+1)
    D, *_ = np.linalg.lstsq(A, B, rcond=None)
    return D.T  # B_rows = A @ D^T  ⇒  Y(Rv) = D @ Y(v)


# ---------------------------------------------------------------------------
# feature-dict helpers + tensor product contraction
# ---------------------------------------------------------------------------

def zeros_feat(l_max: int, n: int, mul: int, dtype=torch.float32, device=None) -> dict:
    device = _device(device)
    return {l: torch.zeros((n, mul, 2 * l + 1), dtype=dtype, device=device)
            for l in range(l_max + 1)}


def feat_map(f, feat: dict) -> dict:
    return {l: f(l, x) for l, x in feat.items()}


def linear_mix(feat: dict, weights: dict) -> dict:
    """Per-l channel mixing: weights[l] (mul_in, mul_out)."""
    return {l: torch.einsum("nui,uv->nvi", x, weights[l]) for l, x in feat.items()}


def tp_paths(l_max: int):
    """All (l1, l2, l3) with l3 ≤ l_max, triangle-valid, l2 = SH degree."""
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                out.append((l1, l2, l3))
    return out


def cg_tensor(l1: int, l2: int, l3: int, like: torch.Tensor) -> torch.Tensor:
    """``cg_real(l1, l2, l3)`` in ``like``'s dtype, on its device."""
    return torch.from_numpy(cg_real(l1, l2, l3)).to(device=like.device, dtype=like.dtype)


def edge_tensor_product(
    h_src: dict,          # {l1: (E, mul, 2l1+1)} gathered source features
    Y: dict,              # {l2: (E, 2l2+1)} edge spherical harmonics
    radial: torch.Tensor,  # (E, n_paths, mul) per-path per-channel weights
    l_max: int,
) -> dict:
    """Σ_paths w_path ⊗ (h_{l1} ⊗ Y_{l2} → l3). Returns {l3: (E, mul, 2l3+1)}."""
    first = next(iter(h_src.values()))
    out = {}
    for pi, (l1, l2, l3) in enumerate(tp_paths(l_max)):
        cg = cg_tensor(l1, l2, l3, first)
        m = torch.einsum("eui,ej,ijk->euk", h_src[l1], Y[l2], cg)
        m = m * radial[:, pi, :, None]
        out[l3] = m if l3 not in out else out[l3] + m
    return out


def gate(feat: dict, scalars_act=F.silu) -> dict:
    """Equivariant gate: l=0 passes through silu; l>0 scaled by
    sigmoid(mean of l=0 channels), a norm-preserving nonlinearity."""
    s = feat[0]
    g = torch.sigmoid(torch.mean(s, dim=-1, keepdim=True))  # (N, mul, 1)
    out = {0: scalars_act(s)}
    for l, x in feat.items():
        if l > 0:
            out[l] = x * g
    return out
