"""The device do-while loop of the engine's stretches (``csrc/device_loop.cu``).

``do_while(round_fn, state, limit)`` runs ``state, go = round_fn(state)``
while the 0-d bool tensor ``go`` holds, at most ``limit`` rounds, and
returns ``(state, k)`` with ``k`` the rounds run.  It replaces the
``jax.lax.while_loop`` of the reference's stretches: on the card nothing is
read on the host until the caller fetches ``k``.

* On CPU tensors it is the plain Python loop, ``do_while_plain``, which
  reads ``go`` after every round (a CPU tensor: no device to wait for).
* On CUDA tensors the first round runs eagerly (it also loads every
  library and kernel the round launches outside any capture), and the rest
  run as one CUDA graph: the round captured once with
  ``torch.cuda.CUDAGraph``, replayed by a WHILE node whose condition the
  loop's one-thread kernels set from ``go`` and the round count.  A round
  that synchronizes with the host (``.item()``, ``bool()``, ``nonzero``)
  cannot be captured: the capture raises, and the error escapes.

``state`` is a tensor or a nested tuple/list of tensors whose shapes and
dtypes a round keeps.  ``enter`` (a 0-d bool tensor) makes the loop a
while loop: the first round counts only when ``enter`` holds, otherwise
the state comes back unchanged with ``k`` = 0.

The captured rounds live in a ``StretchGraphs``.  Rounds captured under a
``key`` are replayed by every later stretch with the same key (the engine's
rung), each launch refilling the loop's static state buffers; a round
captured without a key serves one launch and is freed at the next capture.
A ``StretchGraphs`` opened for one run is closed after its last fetch; one
with ``max_loops`` is kept across runs (the engine keeps one per graph)
and, past that many keyed loops, frees the one launched least recently.
All captures share one private memory pool per device, kept for the
process (``_capture_pool``), and every temporary of a round dies inside
its capture, so the pool holds the largest round's temporaries, not their
sum, and a run's captures reuse its blocks instead of allocating their
own.  That holds because loops run one at a time, on the caller's
stream.  A launch returns copies of the loop's state buffers, so what a
caller holds is never overwritten by a later launch.

Launch counts: a captured round's kernels are not launched by the capture,
so ``_capture`` takes each kernel's count (``kernels.KERNELS``) back to
what it was before it.  Once the caller has fetched a launch's round count
``k``, ``StretchGraphs.settle(k)`` adds the rounds the graph replayed (all
but the eager first one) times the captured round's launches, so every
count says how often its kernel ran.

``do_while.launches`` counts the loop's graph launches, ``do_while.captures``
its captures and ``do_while.capture_s`` their host time (trace, capture and
instantiation of the loop).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import time

import torch

from .. import KERNELS, build


def _flatten(x):
    """(leaves, spec) of a nested tuple/list of tensors."""
    if isinstance(x, (tuple, list)):
        leaves, specs = [], []
        for item in x:
            sub, spec = _flatten(item)
            leaves += sub
            specs.append(spec)
        return leaves, (type(x), tuple(specs))
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"a loop's state holds tensors, not {type(x).__name__}")
    return [x], None


def _unflatten(spec, leaves):
    it = iter(leaves)

    def build_(sp):
        if sp is None:
            return next(it)
        cls, specs = sp
        return cls(build_(s) for s in specs)

    return build_(spec)


def do_while_plain(round_fn, state, limit: int, enter=None):
    """The plain version: a Python do-while (a while loop with ``enter``)
    that reads ``go`` after each round.  Returns ``(state, k)``, ``k`` an
    int."""
    k = 0
    if limit <= 0 or (enter is not None and not bool(enter)):
        return state, k
    while True:
        state, go = round_fn(state)
        k += 1
        if k >= limit or not bool(go):
            return state, k


def do_while(round_fn, state, limit: int, *, enter=None, graphs=None, key=None):
    """``state, go = round_fn(state)`` while ``go``, at most ``limit``
    rounds; returns ``(state, k)``.  On the card ``k`` is a 0-d int32
    tensor and ``graphs`` (a ``StretchGraphs``) holds the captured round;
    ``key`` names it for reuse.  The caller passes the fetched ``k`` to
    ``graphs.settle``."""
    leaves, spec = _flatten(state)
    dev = leaves[0].device
    if dev.type == "cpu":
        return do_while_plain(round_fn, state, limit, enter)
    if dev.type != "cuda":
        raise ValueError(f"do_while runs on cuda or cpu tensors, not {dev}")
    if graphs is None:
        raise ValueError("a loop on the card needs a StretchGraphs to hold its graph")
    graphs.unsettled = None
    limit = min(int(limit), 2**31 - 1)
    if limit <= 0:
        return state, torch.zeros((), dtype=torch.int32, device=dev)
    new, go = round_fn(state)
    if enter is not None:
        new = _unflatten(spec, [torch.where(enter, a, b)
                                for a, b in zip(_flatten(new)[0], leaves)])
        go = go & enter
        k = enter.to(torch.int32)
    else:
        k = torch.ones((), dtype=torch.int32, device=dev)
    if limit == 1:
        return new, k
    return graphs.launch(key, round_fn, new, go, k, limit)


do_while.launches = 0
do_while.captures = 0
do_while.capture_s = 0.0


_CAPTURE: dict = {}   # device index -> (pool handle, capture stream, keeper)


def _capture_pool(dev):
    """The private memory pool and the side stream of every capture on
    ``dev``.  A one-node graph captured into the pool is kept with it: a
    private pool is released once the last graph using it is freed, and
    the keeper holds it (and its cached blocks) for the process."""
    idx = torch.device(dev).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _CAPTURE:
        pool, stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(device=idx)
        keeper = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream(idx))
        with torch.cuda.stream(stream):
            keeper.capture_begin(pool=pool)
            torch.zeros(1, device=dev)
            keeper.capture_end()
        torch.cuda.current_stream(idx).wait_stream(stream)
        _CAPTURE[idx] = (pool, stream, keeper)
    return _CAPTURE[idx][:2]


def _launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


@dataclasses.dataclass
class _Loop:
    body: torch.cuda.CUDAGraph   # captured into _capture_pool's pool
    exec: int                    # cudaGraphExec_t of the loop
    state: list                  # static state buffers the round reads and writes
    spec: object
    k: torch.Tensor
    limit: torch.Tensor
    go: torch.Tensor
    launches: dict               # kernel launches of one captured round


class StretchGraphs:
    """The captured rounds of one run, or of every run on one graph with
    ``max_loops`` (see the module docstring).  Use as a context manager, or
    call ``close()`` after the last fetch."""

    def __init__(self, max_loops: int | None = None):
        self.max_loops = max_loops
        self._loops: collections.OrderedDict = collections.OrderedDict()
        self._uncached: _Loop | None = None
        self.unsettled: _Loop | None = None   # the last launch, until settled

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def launch(self, key, round_fn, state, go, k, limit: int):
        leaves, spec = _flatten(state)
        if key is not None:
            # a loop is captured for one state structure: the same key with
            # another state (shapes, dtypes) is another loop
            key = (key, spec, tuple((t.shape, t.dtype) for t in leaves))
        loop = self._loops.get(key) if key is not None else None
        if loop is None:
            loop = self._capture(round_fn, spec, leaves)
            if key is None:
                self._destroy([self._uncached])
                self._uncached = loop
            else:
                self._loops[key] = loop
                if self.max_loops is not None and len(self._loops) > self.max_loops:
                    self._destroy([self._loops.popitem(last=False)[1]])
        elif key is not None:
            self._loops.move_to_end(key)
        for s, t in zip(loop.state, leaves):
            s.copy_(t)
        loop.k.copy_(k)
        loop.go.copy_(go)
        loop.limit.fill_(limit)
        lib = build.load("device_loop")
        rc = lib.device_loop_launch(loop.exec, torch.cuda.current_stream().cuda_stream)
        build.check(lib, rc, "device_loop")
        do_while.launches += 1
        self.unsettled = loop
        return _unflatten(spec, [s.clone() for s in loop.state]), loop.k.clone()

    def settle(self, k: int) -> None:
        """Count the kernel launches of the last launch, whose round count
        ``k`` the caller has fetched: its rounds after the eager first one
        ran in the graph, each launching what its captured round did.  A
        loop that ended without a launch (or on the CPU) adds nothing."""
        loop, self.unsettled = self.unsettled, None
        if loop is None or k <= 1:
            return
        for name, n in loop.launches.items():
            KERNELS[name].launches += n * (int(k) - 1)

    def _capture(self, round_fn, spec, like) -> _Loop:
        t0 = time.perf_counter()
        dev = like[0].device
        lib = build.load("device_loop")
        state = [t.clone() for t in like]
        i32 = dict(dtype=torch.int32, device=dev)
        k, limit = torch.zeros((), **i32), torch.zeros((), **i32)
        go = torch.zeros((), dtype=torch.bool, device=dev)
        pool, stream = _capture_pool(dev)
        body = torch.cuda.CUDAGraph(keep_graph=True)
        cur = torch.cuda.current_stream(dev)
        stream.wait_stream(cur)
        before = _launch_counts()
        with torch.cuda.stream(stream):
            body.capture_begin(pool=pool)
            try:
                new, flag = round_fn(_unflatten(spec, state))
                out, out_spec = _flatten(new)
                if out_spec != spec or any(s.shape != t.shape or s.dtype != t.dtype
                                           for s, t in zip(state, out)):
                    raise ValueError("a round must keep its state's structure, "
                                     "shapes and dtypes")
                # an output that is another slot's buffer is copied first
                out = [t.clone() if any(t is s for j, s in enumerate(state) if j != i)
                       else t for i, t in enumerate(out)]
                for s, t in zip(state, out):
                    s.copy_(t)
                go.copy_(flag)
                del new, flag, out
            except BaseException:
                try:
                    body.capture_end()
                except RuntimeError:
                    pass   # the capture was invalidated by the error raised
                raise
            finally:
                # a capture launches nothing: its wrappers' counts go back
                captured = {name: n - before[name]
                            for name, n in _launch_counts().items() if n != before[name]}
                for name, n in captured.items():
                    KERNELS[name].launches -= n
            body.capture_end()
        cur.wait_stream(stream)
        handle = ctypes.c_void_p()
        rc = lib.device_loop_build(body.raw_cuda_graph(), k.data_ptr(), limit.data_ptr(),
                                   go.data_ptr(), ctypes.byref(handle))
        build.check(lib, rc, "device_loop build")
        do_while.captures += 1
        do_while.capture_s += time.perf_counter() - t0
        return _Loop(body=body, exec=handle.value, state=state, spec=spec, k=k,
                     limit=limit, go=go, launches=captured)

    def _destroy(self, loops) -> None:
        loops = [lp for lp in loops if lp is not None]
        if not loops:
            return
        lib = build.load("device_loop")
        for lp in loops:
            build.check(lib, lib.device_loop_destroy(lp.exec), "device_loop destroy")

    def close(self) -> None:
        """Free every captured round; the caller has fetched the last
        launch's results, so none is still running."""
        loops = list(self._loops.values()) + [self._uncached]
        self._loops.clear()
        self._uncached = None
        self.unsettled = None
        self._destroy(loops)
