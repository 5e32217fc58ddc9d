"""Checkpoints: the pytree half of ``repro.checkpoint.manager``.

``CheckpointManager`` saves and restores a trainer's state (parameters and
optimizer state: nested dicts and dataclasses of tensors), atomically and,
with ``blocking=False``, on a background thread after a synchronous copy
to the host; it keeps the last ``keep_last`` snapshots.  ``restore_resharded``
loads a snapshot onto a device (on one card: every leaf on ``device``;
placement over several cards waits for a mesh of distinct devices).

``RunCheckpointer`` snapshots an engine's whole iteration state (labels,
frontier mask, residuals: a tensor or a nested tuple/list/dict of them)
every ``every`` rounds and resumes an interrupted run from the latest
snapshot.

The format is the reference's, so a snapshot written by either package
opens in the other:

* one ``step_<step:010d>.npz`` per snapshot, keyed by each leaf's path
  (tuple and list indices, dict keys, named-tuple and dataclass fields,
  joined by ``/``: an ``AdamWState`` gives ``opt/step``, ``opt/mu/...``,
  ``opt/nu/...``), staged as ``*.npz.tmp`` and ``os.replace``d into place;
* ``manifest.json`` written last (step, time, keys, metadata), through a
  per-step tmp file;
* rotation keeps the last ``keep_last`` snapshots and sweeps the
  ``*.tmp`` files a crashed writer left behind.
* a bfloat16 leaf is stored as its 2-byte patterns, numpy's ``V2``, which
  is how ``np.savez`` writes the reference's ml_dtypes bfloat16 arrays;
  a ``V2`` leaf is read back as bfloat16.

A process killed mid-save leaves at most a ``*.tmp`` file, which is never
resumed from: only a replaced ``step_*.npz`` counts.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..core.graph import _device


def _items(tree):
    """``(key, child)`` pairs of one level of a state tree, in the order
    the reference's pytree flattening visits them (dict keys sorted,
    dataclass fields in their order)."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of a tensor (never a view of it, so a later in-place
    update cannot reach a snapshot); bfloat16 as its ``V2`` bit patterns."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view("V2")
    return t.to("cpu", copy=True).numpy()


def _paths(tree, prefix: str = "") -> dict:
    """``{path: leaf}`` of every leaf (the leaves themselves, not copies)."""
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    flat = {}
    for key, child in items:
        flat.update(_paths(child, f"{prefix}/{key}" if prefix else key))
    return flat


def _flatten(tree) -> dict[str, np.ndarray]:
    """``{path: host array}`` of every leaf: a tensor is copied to the
    host, anything else goes through ``np.asarray``."""
    return {k: _host(v) if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in _paths(tree).items()}


def _unflatten(tree_like, flat: dict, prefix: str = ""):
    """``tree_like``'s structure with each leaf taken from ``flat``."""
    items = _items(tree_like)
    if items is None:
        return flat[prefix]
    children = [_unflatten(child, flat, f"{prefix}/{key}" if prefix else key)
                for key, child in items]
    if isinstance(tree_like, dict):
        return dict(zip(sorted(tree_like), children))
    if dataclasses.is_dataclass(tree_like):
        return dataclasses.replace(tree_like, **dict(zip((k for k, _ in items), children)))
    if hasattr(tree_like, "_fields"):
        return type(tree_like)(*children)
    return type(tree_like)(children)


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """A loaded leaf as a tensor on ``device``: ``V2`` as bfloat16."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def save_pytree(tree, directory: str, step: int, metadata: Optional[dict] = None):
    """Write ``tree`` as ``step_<step>.npz`` (staged, then replaced) and
    commit ``manifest.json`` last.  Returns the snapshot's path."""
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    final = os.path.join(directory, f"step_{step:010d}.npz")
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, final)
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": sorted(flat.keys()),
        "metadata": metadata or {},
    }
    mtmp = os.path.join(directory, f"manifest.json.{step}.tmp")
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, os.path.join(directory, "manifest.json"))
    return final


def load_pytree(tree_like, directory: str, step: Optional[int] = None):
    """``(tree, step)``: the snapshot of ``step`` (the latest by default) in
    ``tree_like``'s structure, its leaves host numpy arrays.  A structure
    that differs from the archive's, or an archive the manifest of the same
    step disagrees with, raises ``ValueError``."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(
            f"no checkpoints under {directory}: expected step_*.npz files "
            "(directory missing, empty, or never saved to)")
    data = np.load(os.path.join(directory, f"step_{step:010d}.npz"))
    want = sorted(_paths(tree_like))
    stored = sorted(data.files)
    mpath = os.path.join(directory, "manifest.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            manifest = json.load(f)
        if manifest.get("step") == step and manifest.get("keys") != stored:
            raise ValueError(
                f"checkpoint {directory} step {step} is corrupt: archive "
                f"holds {stored}, manifest recorded {manifest.get('keys')}")
    if want != stored:
        raise ValueError(
            f"checkpoint structure mismatch in {directory} step {step}: "
            f"tree_like flattens to {want}, checkpoint stores {stored}")
    return _unflatten(tree_like, {k: data[k] for k in want}), step


def restore_resharded(tree_like, directory: str, device=None, step: Optional[int] = None):
    """``(tree, step)``: ``load_pytree`` with every leaf placed on ``device``
    (the card by default).  One device takes the reference's shardings'
    place; placement over several cards waits for a mesh of distinct
    devices."""
    device = _device(device)
    host, step = load_pytree(tree_like, directory, step)
    return _unflatten(host, {k: _to_tensor(a, device) for k, a in _paths(host).items()}), step


def _rotate_dir(directory: str, keep_last: int):
    """Keep the last ``keep_last`` snapshots and sweep stale ``*.tmp``
    staging files (a save that completed has none of its own left)."""
    files = sorted(f for f in os.listdir(directory)
                   if f.startswith("step_") and f.endswith(".npz"))
    for f in files[:-keep_last] if keep_last > 0 else files:
        try:
            os.remove(os.path.join(directory, f))
        except OSError:
            pass
    for f in os.listdir(directory):
        if f.endswith(".tmp"):
            try:
                os.remove(os.path.join(directory, f))
            except OSError:
                pass


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(f[len("step_"):-len(".npz")]) for f in os.listdir(directory)
             if f.startswith("step_") and f.endswith(".npz")]
    return max(steps) if steps else None


class CheckpointManager:
    """Atomic, optionally asynchronous saves of a state tree into
    ``directory``, keeping the last ``keep_last``; ``restore`` (host
    arrays) and ``restore_resharded`` (tensors on a device) of the latest
    or a given step."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, tree, step: int, metadata: Optional[dict] = None,
             blocking: bool = True):
        """Copy ``tree`` to the host now (waiting for the device work that
        made it), then write it: here, or on a background thread when
        ``blocking`` is False.  A save first waits for the one in flight."""
        host = _flatten(tree)
        self.wait()
        if blocking:
            self._write(host, step, metadata)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(host, step, metadata), daemon=True)
            self._thread.start()

    def _write(self, host, step, metadata):
        save_pytree(host, self.directory, step, metadata)
        _rotate_dir(self.directory, self.keep_last)

    def wait(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def restore(self, tree_like, step: Optional[int] = None):
        self.wait()
        return load_pytree(tree_like, self.directory, step)

    def restore_resharded(self, tree_like, device=None, step: Optional[int] = None):
        self.wait()
        return restore_resharded(tree_like, self.directory, device, step)

    def latest_step(self) -> Optional[int]:
        self.wait()
        return latest_step(self.directory)


class RunCheckpointer:
    """Mid-run snapshot and resume for the engines (``engine.run_host``,
    ``run_streamed``, ``SparseLadderEngine.run``).

    The snapshot's step is the round it was taken after; a ``RunStats``
    snapshot rides in the manifest's metadata, but resume needs only the
    step.  The engines fold in a fixed order, so a run killed at round r
    and resumed finishes bitwise equal to the uninterrupted run: BFS
    always, pagerank under ``operators.set_deterministic_add``.

    ``every`` is compared with the rounds since the last snapshot (or the
    resume point), not with ``round % every``: a fused stretch retires
    many rounds at once.  ``fault`` (a ``core.faultio.FaultInjector``)
    ticks its ``ckpt_write`` site before each write.
    """

    def __init__(self, directory: str, every: int = 8, keep_last: int = 2,
                 resume: bool = True, fault=None):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.directory = directory
        self.every = int(every)
        self.keep_last = int(keep_last)
        self.resume = resume
        self.fault = fault
        self.saves = 0
        self.save_s = 0.0     # host seconds spent in save (copy + write)
        self._last_saved = 0
        os.makedirs(directory, exist_ok=True)

    def maybe_save(self, state, round_no: int, stats=None) -> bool:
        """Snapshot iff ``every`` or more rounds passed since the last
        snapshot (or resume point).  Returns True when a save happened."""
        if round_no - self._last_saved < self.every:
            return False
        self.save(state, round_no, stats)
        return True

    def save(self, state, round_no: int, stats=None):
        """Copy ``state`` to the host and write it as the snapshot of
        ``round_no``.  The copy waits for the device work that produced
        the state, so a caller snapshots only state it has settled."""
        t0 = time.perf_counter()
        if self.fault is not None:
            self.fault.tick("ckpt_write", key=int(round_no))
        meta = {"kind": "run-checkpoint", "round": int(round_no)}
        if stats is not None:  # e.g. RunStats.as_dict(): ints and str tags
            meta["stats"] = {k: (v if isinstance(v, str) else int(v))
                             for k, v in dict(stats).items()}
        save_pytree(state, self.directory, step=int(round_no), metadata=meta)
        _rotate_dir(self.directory, self.keep_last)
        self._last_saved = int(round_no)
        self.saves += 1
        self.save_s += time.perf_counter() - t0

    def load(self, state_like):
        """``(state, start_round)`` from the latest snapshot when ``resume``
        is on and one exists, else ``(state_like, 0)``.  The leaves are
        host numpy arrays: the engine places them on the device."""
        if not self.resume or latest_step(self.directory) is None:
            return state_like, 0
        state, step = load_pytree(state_like, self.directory)
        self._last_saved = int(step)
        return state, int(step)
