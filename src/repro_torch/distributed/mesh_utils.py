"""Mesh and sharding helpers, as ``repro.distributed.mesh_utils``, over
``core.mesh.Mesh``.

``P`` is the port's ``PartitionSpec``: one entry a dimension, each
``None`` (replicated), an axis name, or a tuple of names (the dimension
split over their product).  Entries are normalised as JAX's are (a list
becomes a tuple, a one-name tuple its name, an empty tuple ``None``), so
``tuple(P(...))`` equals ``tuple(jax.sharding.PartitionSpec(...))``
entry for entry.  A spec places nothing: on the port's one device it is
what the dry run (``launch/dryrun.py``) accounts shards and traffic by.
"""

from __future__ import annotations

import math

from ..core.mesh import Mesh


def _entry(e):
    if e is None or isinstance(e, str):
        return e
    names = tuple(e)
    if not names:
        return None
    return names[0] if len(names) == 1 else names


class P(tuple):
    """An immutable partition spec (a tuple of normalised entries)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def names_of(entry) -> tuple:
    """The axis names of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_size(mesh: Mesh, name: str) -> int:
    return int(mesh.shape.get(name, 1))


def flat_devices(mesh: Mesh) -> list:
    """The device of every mesh position, row-major (one device here)."""
    return [mesh.device] * math.prod(mesh.shape.values())


def _has(mesh: Mesh, n) -> bool:
    if isinstance(n, (tuple, list)):
        return all(_has(mesh, x) for x in n)
    return n in mesh.shape


def spec(mesh: Mesh, *names) -> P:
    """The spec of ``names`` with any entry naming an axis the mesh lacks
    dropped to ``None`` (the reference's ``NamedSharding`` of it)."""
    return P(*(n if (n is None or _has(mesh, n)) else None for n in names))


def filter_pspec(pspec, mesh: Mesh) -> P:
    """``pspec`` with the axes the mesh lacks dropped from each entry (e.g.
    'pod' on the single-pod mesh), the rest of a tuple entry kept: the
    reference's ``dryrun.filter_pspec`` and ``Trainer._filter``."""
    return P(*(tuple(a for a in names_of(e) if a in mesh.shape) for e in pspec))


def batch_axes(mesh: Mesh) -> tuple:
    """Axes over which the global batch is sharded: ('pod','data') if the pod
    axis exists, else ('data',)."""
    return ("pod", "data") if "pod" in mesh.shape else ("data",)


def shard_shape(global_shape, pspec, mesh: Mesh) -> tuple:
    """The per-device shape of an array of ``global_shape`` under ``pspec``:
    each sharded dimension ceil-divided by the product of its axes' sizes,
    as GSPMD pads it; axes the mesh lacks are dropped, dimensions past the
    spec's length are replicated."""
    out = []
    for i, d in enumerate(global_shape):
        entry = pspec[i] if i < len(pspec) else None
        k = math.prod(axis_size(mesh, a) for a in names_of(entry))
        out.append(-(-int(d) // k))
    return tuple(out)
