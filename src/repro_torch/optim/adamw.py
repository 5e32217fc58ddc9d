"""AdamW with decoupled weight decay and global-norm clipping, as
``repro.optim.adamw``.

The arithmetic is the reference's, in f32, term for term: clip by the
global norm, ``c1 = 1 - b1**step``, ``m``, ``v``, ``mhat``, ``vhat``,
``delta = mhat/(sqrt(vhat)+eps) + wd·p`` and ``p - lr·delta`` cast back
to the parameter's dtype (no master weights: a bf16 parameter is rounded
each step, as in the reference).  ``step`` is a 0-d int32 tensor; ``mu``
and ``nu`` are f32 whatever the parameters' dtype.

The update runs in place, a leaf at a time and a stacked leaf in chunks
along its leading dim (the reference's donated buffers): the parameters,
``mu`` and ``nu`` are written and returned, and no f32 temporary is larger
than ``CHUNK`` elements.  At h2o-danube-3-4b's width the stacked
``wi_gate`` is 943 M elements, whose every whole f32 temporary would be
3.8 GB.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..core.graph import _device
from ..distributed.mesh_utils import P

CHUNK = 1 << 26   # elements of a leaf updated at once (256 MB of f32)


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor
    mu: Any
    nu: Any


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists (and the same
    leaves of ``rest``)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, *xs) for xs in zip(tree, *rest)]
    return fn(tree, *rest)


def _leaves(tree):
    """Leaves in the reference's order (JAX's flattening): dict keys
    sorted, lists and tuples in order, a dataclass's fields in declaration
    order, ``None`` empty; a partition spec ``P`` is a leaf."""
    if tree is None:
        return []
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [leaf for f in dataclasses.fields(tree) for leaf in _leaves(getattr(tree, f.name))]
    return [tree]


def _chunks(t: torch.Tensor):
    """Views of ``t`` along its leading dim, each at most ``CHUNK`` elements
    (one row at least); a 0-d or small leaf is one chunk."""
    if t.dim() == 0 or t.numel() <= CHUNK:
        return [t]
    rows = max(1, CHUNK // max(1, t[0].numel()))
    return list(t.split(rows))


def adamw_init(params) -> AdamWState:
    zeros = _tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    step = torch.zeros((), dtype=torch.int32, device=_leaves(params)[0].device)
    return AdamWState(step=step, mu=zeros, nu=_tree_map(torch.clone, zeros))


def adamw_state_from_numpy(state, device=None) -> AdamWState:
    """A reference ``AdamWState`` with numpy leaves (``jax.device_get`` of
    one) as tensors on ``device`` (the card by default)."""
    from ..models.layers import params_from_numpy
    step = torch.from_numpy(np.array(state.step, dtype=np.int32))
    return AdamWState(step=step.to(_device(device)),
                      mu=params_from_numpy(state.mu, device),
                      nu=params_from_numpy(state.nu, device))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    total = 0
    for leaf in _leaves(tree):
        sq = sum(torch.sum(torch.square(c.to(torch.float32))) for c in _chunks(leaf))
        total = total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(
    grads,
    state: AdamWState,
    params,
    lr,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: Optional[float] = 1.0,
):
    """Returns (params, state), both updated in place.  ``lr`` is a Python
    float or an f32 0-d tensor (a schedule's value from ``state.step``)."""
    scale = None
    if clip_norm is not None:
        gn = global_norm(grads)
        scale = torch.clamp(gn.new_tensor(clip_norm) / torch.clamp(gn, min=1e-12), max=1.0)

    step = state.step + 1
    sf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, sf)
    c2 = 1.0 - torch.pow(b2, sf)

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        if scale is not None:
            g = g * scale
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
        mhat = m / c1
        vhat = v / c2
        pf = p.to(torch.float32)
        delta = mhat.div_(torch.sqrt_(vhat).add_(eps)).add_(weight_decay * pf)
        p.copy_((pf - lr * delta).to(p.dtype))

    for p, g, m, v in zip(*(_leaves(t) for t in (params, grads, state.mu, state.nu))):
        for cp, cg, cm, cv in zip(*(_chunks(t) for t in (p, g, m, v))):
            upd(cp, cg, cm, cv)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
