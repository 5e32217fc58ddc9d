"""Production meshes, as ``repro.launch.mesh``.

Single pod: 256 chips as (16, 16) → ("data", "model").
Multi-pod:  2 × 256   as (2, 16, 16) → ("pod", "data", "model"); the 'pod'
axis crosses the slower links, so shardings put only data-parallel
traffic (the gradient all-reduce) on it.

The port builds these as **virtual** meshes on the meta device: they
name the axes and sizes that ``launch/dryrun.py`` accounts shards and
traffic by, and place nothing (a mesh over distinct cards is ROADMAP
queue 1, item 23).
"""

from __future__ import annotations

from ..core.mesh import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(dict(zip(axes, shape)), device="meta")


def make_host_mesh(shape, axes) -> Mesh:
    """An arbitrary test mesh; every position on the CPU."""
    return Mesh(dict(zip(axes, shape)), device="cpu")
