"""The GNN batch format and helpers shared by the four architectures, as
``repro.models.gnn.common``.

Every architecture consumes one ``GNNBatch``: a (possibly block-diagonal)
flat graph.  Batched small graphs (the ``molecule`` shape) are flattened
with index offsets; sampled mini-batches (``minibatch_lg``) become layered
child→parent edges; full-graph shapes pass through unchanged.  Message
passing is gather → edge op → ``segment_sum``: the engine's push operator
applied to learning.  ``segment_sum`` is ``index_add`` into zeros of
``num_segments`` rows; on the card its float adds are atomics, so sums
come in an order that changes from run to run.

Parameters are nested dicts and lists of tensors, as the reference's
pytrees (the irreps' ``{l: ...}`` dicts keep their int keys);
``params_from_numpy`` carries a reference tree across, and ``tree_map``
and ``leaves`` (the optimizer's) walk one, leaves in the reference's
order (dict keys sorted, lists in order).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ...core.graph import _device
from ...optim.adamw import _leaves as leaves  # noqa: F401
from ...optim.adamw import _tree_map as tree_map


@dataclasses.dataclass(frozen=True)
class GNNBatch:
    n_graphs: int
    features: torch.Tensor     # (N, F) float
    positions: torch.Tensor    # (N, 3) float (zeros for non-geometric)
    src: torch.Tensor          # (M,) int32
    dst: torch.Tensor          # (M,) int32
    edge_mask: torch.Tensor    # (M,) bool
    graph_id: torch.Tensor     # (N,) int32
    node_mask: torch.Tensor    # (N,) bool: nodes carrying loss
    labels: torch.Tensor       # (N,) int32 node labels or (G,) float energies

    @property
    def n_nodes(self) -> int:
        return self.features.shape[0]

    @property
    def n_edges(self) -> int:
        return self.src.shape[0]

    def to(self, device) -> "GNNBatch":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "n_graphs"})


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def params_from_numpy(tree, device=None):
    """A GNN parameter tree of numpy arrays (``jax.device_get`` of the
    reference's: dicts, with int keys in the irreps' mixes, and lists) as
    tensors on ``device`` (the card by default)."""
    device = _device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


# ---------------------------------------------------------------------------
# message passing helpers
# ---------------------------------------------------------------------------

def segment_sum(data, segment_ids, num_segments: int):
    """Rows of ``data`` summed into ``num_segments`` rows by id."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, segment_ids, data)


def segment_mean(data, segment_ids, num_segments: int):
    s = segment_sum(data, segment_ids, num_segments)
    ones = torch.ones(segment_ids.shape, dtype=torch.float32, device=data.device)
    c = segment_sum(ones, segment_ids, num_segments)
    return s / torch.clamp(c, min=1.0)[..., None]


def degrees(batch: GNNBatch) -> torch.Tensor:
    """In-degree of each node over the unmasked edges (f32)."""
    return segment_sum(batch.edge_mask.to(torch.float32), batch.dst, batch.n_nodes)


def mlp_init(gen: torch.Generator, dims, dtype=torch.float32, device=None):
    """Layers of N(0, 1)/sqrt(fan_in) weights and zero biases, drawn from
    ``gen`` on ``device`` (the card by default; ``gen`` must live there)."""
    device = _device(device)
    return [
        {"w": torch.randn((a, b), generator=gen, dtype=dtype, device=device) / math.sqrt(a),
         "b": torch.zeros((b,), dtype=dtype, device=device)}
        for a, b in zip(dims[:-1], dims[1:])
    ]


def mlp_apply(layers, x, act=F.silu, final_act: bool = False):
    for i, lay in enumerate(layers):
        x = x @ lay["w"] + lay["b"]
        if i + 1 < len(layers) or final_act:
            x = act(x)
    return x


def bessel_rbf(d, n_rbf: int, cutoff: float):
    """Bessel radial basis with a smooth polynomial cutoff (NequIP/DimeNet)."""
    d = torch.clamp(d, min=1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=d.dtype, device=d.device)
    rb = math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * d[..., None] / cutoff) / d[..., None]
    x = torch.clamp(d / cutoff, 0.0, 1.0)
    p = 6.0
    env = 1.0 - (p + 1) * (p + 2) / 2 * x ** p + p * (p + 2) * x ** (p + 1) \
        - p * (p + 1) / 2 * x ** (p + 2)
    return rb * env[..., None]


def node_class_loss(logits, batch: GNNBatch):
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch.labels[:, None].long())[:, 0]
    w = batch.node_mask.to(torch.float32)
    return torch.sum((logz - gold) * w) / torch.clamp(torch.sum(w), min=1.0)


def energy_loss(energy, batch: GNNBatch):
    tgt = batch.labels.to(torch.float32)[: energy.shape[0]]
    return torch.mean(torch.square(energy - tgt))


def task_loss(out, cfg, batch: GNNBatch):
    """(loss, metrics) of an architecture's output for ``cfg.task``."""
    if cfg.task == "graph_reg":
        loss = energy_loss(out, batch)
    else:
        loss = node_class_loss(out, batch)
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# host-side batch builders
# ---------------------------------------------------------------------------

def flatten_molecules(feats, pos, src, dst, labels, edge_mask=None, device=None):
    """(B, n, F), (B, n, 3), (B, m), (B, m), (B,) → block-diagonal GNNBatch.

    Numpy arrays go to ``device`` (the card by default); tensors stay on
    theirs."""
    if torch.is_tensor(feats):
        device = feats.device
    device = _device(device)
    B, n, Fd = feats.shape
    m = src.shape[1]
    off = (torch.arange(B, dtype=torch.int32, device=device) * n)[:, None]
    def put(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=device)

    em = torch.ones((B, m), dtype=torch.bool, device=device) if edge_mask is None \
        else put(edge_mask, torch.bool)
    i32, f32 = torch.int32, torch.float32
    return GNNBatch(
        n_graphs=B,
        features=put(feats, f32).reshape(B * n, Fd),
        positions=put(pos, f32).reshape(B * n, 3),
        src=(put(src, i32) + off).reshape(-1),
        dst=(put(dst, i32) + off).reshape(-1),
        edge_mask=em.reshape(-1),
        graph_id=torch.arange(B, dtype=i32, device=device).repeat_interleave(n),
        node_mask=torch.ones((B * n,), dtype=torch.bool, device=device),
        labels=put(labels, f32),
    )


def blocks_to_batch(features_table, labels_table, blocks, fanouts):
    """Sampler output → layered GNNBatch (child→parent edges; the seeds
    carry the loss), on the tables' device."""
    device = features_table.device
    node_ids = [blocks.seeds] + list(blocks.layers)
    sizes = [x.shape[0] for x in node_ids]
    offsets = np.cumsum([0] + sizes[:-1])
    all_ids = torch.cat(node_ids).to(device=device, dtype=torch.long)
    srcs, dsts = [], []
    for k, f in enumerate(fanouts):
        parents = torch.arange(sizes[k], dtype=torch.int32, device=device) + int(offsets[k])
        children = torch.arange(sizes[k + 1], dtype=torch.int32, device=device) \
            + int(offsets[k + 1])
        srcs.append(children)
        dsts.append(parents.repeat_interleave(f))
    src = torch.cat(srcs)
    N = int(sum(sizes))
    nm = torch.zeros((N,), dtype=torch.bool, device=device)
    nm[: sizes[0]] = True
    return GNNBatch(
        n_graphs=1,
        features=features_table.index_select(0, all_ids),
        positions=torch.zeros((N, 3), dtype=torch.float32, device=device),
        src=src,
        dst=torch.cat(dsts),
        edge_mask=torch.ones_like(src, dtype=torch.bool),
        graph_id=torch.zeros((N,), dtype=torch.int32, device=device),
        node_mask=nm,
        labels=labels_table.index_select(0, all_ids),
    )
