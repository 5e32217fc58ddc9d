"""The device mesh of the sharded path: D positions on ONE torch device.

The counterpart of ``jax.sharding.Mesh(devs.reshape(...), axes)``.  The
reference maps a mesh axis to forced host devices or TPU chips and runs
``shard_map`` over them; here every position of the mesh sits on the same
device and a shard's arrays are row ``d`` of a (D, ...) tensor.  The
collectives of ``core/sharded.py`` and ``core/partition.py`` are explicit
tensor reductions over that leading axis, so labels and every ``RunStats``
counter (the analytic comm model included) are those of the reference's
D-device run.  Positions are flattened row-major over the axes, as
``devs.reshape(shape)`` orders devices: on a (rows, cols) grid position
``i * cols + j`` is row i, column j.

A mesh over distinct devices (NCCL collectives or peer copies between
cards) is not built: ``Mesh(..., devices=[...])`` with more than one
device raises ``NotImplementedError`` (ROADMAP queue 1, item 23).
"""

from __future__ import annotations

import math

import torch

from .graph import _device

MULTI_DEVICE_ITEM = "ROADMAP queue 1, item 23: a mesh over distinct CUDA devices"


class Mesh:
    """``shape``: ``{axis name: size}`` in axis order; every position lives
    on ``device`` (the card unless the caller passes one, ``"cpu"`` in the
    tests).  ``devices``: the devices of the positions, as a list; only a
    list naming one device is taken."""

    def __init__(self, shape: dict, device=None, devices=None):
        if not shape or any(int(s) < 1 for s in shape.values()):
            raise ValueError(f"a mesh needs at least one axis of size >= 1, not {shape}")
        if devices is not None:
            distinct = {torch.device(d) for d in devices}
            if len(distinct) > 1:
                raise NotImplementedError(
                    f"a mesh over {len(distinct)} distinct devices is not built; every "
                    f"position of the port's mesh sits on one device ({MULTI_DEVICE_ITEM})")
            if device is None and distinct:
                device = distinct.pop()
        self.shape = {str(a): int(s) for a, s in shape.items()}
        self.device = _device(device)

    @property
    def axes(self) -> tuple:
        return tuple(self.shape)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def num_positions(mesh: Mesh, axes) -> int:
    """Positions of ``mesh`` along ``axes`` (the reference's
    ``_num_devices``)."""
    return math.prod(mesh.shape[a] for a in axes)
