"""Round-execution engines.

The regimes of ``repro.core.engine``, with one blocking device-to-host read
per stretch, as the reference's ``jax.device_get`` makes it:

* ``fetch`` — the engine's only blocking read of the device: every tensor
  it is given comes back in one transfer.  ``fetch.calls`` counts them.

* ``run_dense`` — ``state = step(state)`` while ``cond(state)``: one device
  loop (``kernels.device_loop.do_while``: on the card a captured round
  replayed by a CUDA graph's WHILE node, on the CPU a Python loop), and one
  fetch of its round count at the end.  ``run_host`` is the eager loop with
  one fetch of ``cond`` per round, for steps that read the device
  themselves (and the per-round ``fault`` ticks of the out-of-core path).

* ``SparseLadderEngine`` — data-driven rounds over sparse worklists along a
  (capacity, budget) rung ladder.  ``fused=True`` runs *stretches* of
  consecutive same-rung rounds, each one device do-while loop that
  re-derives after every round, on the device, whether the host dispatcher
  would keep this rung (``frontier.sparse_band`` / ``dense_band``).  The
  host then makes one fetch per stretch: the stretch's round count (and
  dense mass) together with the next round's ladder scalars.
  ``fused=False`` dispatches one round at a time, one fetch a round.  Both
  produce the reference's labels and ``RunStats`` counters (``rounds``,
  ``sparse_rounds``, ``dense_rounds``, ``edges_touched``, ``compiles`` as
  distinct stretch keys, ``overflow_escalations``).  On the card every
  stretch of one rung replays one captured round, in this run and in later
  runs on the same graph: each graph keeps its last ``RUNG_LOOPS`` rung
  loops, freed with it.

* ``run_streamed`` — the out-of-core runner for a ``tiered.TieredGraph``:
  each trip fetches ``(cond, frontier_count, live_shard_mask)`` (plus an
  in-flight stretch's round count) in one transfer; a live shard set that
  fits the buffer pool is staged once and its rounds run as one device
  loop (``_staged_stretch``), which exits when the live set changes.
  ``SparseLadderEngine`` hands tiered graphs to it.

* ``resume_run`` — every runner takes a ``checkpointer``
  (``checkpoint.RunCheckpointer``): it resumes from the latest snapshot
  and snapshots the state at the host boundaries the runner already pays
  for (after an eager round, after a stretch's fetch), never adding a
  fetch.  ``max_rounds`` stays the run's total budget across restarts.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Callable

import numpy as np
import torch

from ..kernels.device_loop import StretchGraphs, do_while
from . import frontier as fr
from . import operators as ops
from .graph import Graph


@dataclasses.dataclass
class RunStats:
    rounds: int = 0
    edges_touched: int = 0
    dense_rounds: int = 0
    sparse_rounds: int = 0
    compiles: int = 0
    # sparse rung couldn't cover the frontier's edge mass → dense fallback
    overflow_escalations: int = 0
    # shards that escalated to a local dense relax (0 on a single partition)
    shard_escalations: int = 0
    # analytic cross-device communication (zero when unsharded)
    comm_elems: int = 0
    comm_bytes: int = 0
    reduce_axis_hops: int = 0
    # host→device streaming of the out-of-core path (zero when resident):
    # every miss copies one padded shard, so h2d_bytes == shards_streamed *
    # g.shard_bytes exactly
    h2d_bytes: int = 0
    shards_streamed: int = 0
    buffer_hits: int = 0
    # fault-tolerance ledger of the streamed path
    io_retries: int = 0
    checksum_failures: int = 0
    io_wait_us: int = 0
    # direction-optimizing traversal: rounds run in the pull direction
    pull_rounds: int = 0
    # concurrent source lanes the run's sweeps were amortized over
    sources: int = 1
    # execution geometry (1/"local" for an unsharded Graph, "tiered" out of core)
    ndev: int = 1
    placement: str = "local"
    # what the relaxations ran on: "cuda" only when the kernels launched
    substrate: str = dataclasses.field(default_factory=ops.get_substrate)

    @classmethod
    def from_graph(cls, g, **kw) -> "RunStats":
        """Stats for a run on ``g``: its execution geometry and the
        substrate a relaxation on it runs."""
        return cls(substrate=ops.run_substrate(g), ndev=getattr(g, "ndev", 1),
                   placement=getattr(g, "placement", "local"), **kw)

    def as_dict(self):
        return dataclasses.asdict(self)


def fetch(*xs):
    """The twin of ``jax.device_get``: every tensor of ``xs`` comes back to
    the host in ONE transfer (one blocking sync on the card) — a 0-d
    tensor as a Python bool, int or float, a 1-d one as a list; other
    values pass through.  Returns one value, or a tuple for several."""
    fetch.calls += 1
    tensors = [x for x in xs if isinstance(x, torch.Tensor)]
    flat = []
    if len(tensors) == 1:   # a per-round read: no cast, no concatenation
        flat = tensors[0].reshape(-1).tolist()
    elif tensors:
        wide = (torch.float64 if any(t.is_floating_point() for t in tensors)
                else torch.int64)
        flat = torch.cat([t.reshape(-1).to(wide) for t in tensors]).tolist()
    out, i = [], 0
    for x in xs:
        if not isinstance(x, torch.Tensor):
            out.append(x)
            continue
        kind = bool if x.dtype == torch.bool else (
            float if x.is_floating_point() else int)
        vals = [kind(v) for v in flat[i:i + x.numel()]]
        i += x.numel()
        out.append(vals[0] if x.dim() == 0 else vals)
    return out[0] if len(out) == 1 else tuple(out)


fetch.calls = 0


def _as_tensors(state, device):
    """``state`` with every Python bool, int or float leaf made a 0-d
    tensor on ``device`` (the device loop carries tensors only)."""
    if isinstance(state, (tuple, list)):
        return type(state)(_as_tensors(x, device) for x in state)
    if isinstance(state, torch.Tensor):
        return state
    return torch.full((), state, device=device)


def _state_device(state):
    if isinstance(state, (tuple, list)):
        for x in state:
            dev = _state_device(x)
            if dev is not None:
                return dev
        return None
    return state.device if isinstance(state, torch.Tensor) else None


def _place(loaded, like):
    """``loaded`` (a snapshot's host arrays, in ``like``'s structure) as
    fresh tensors on the devices and in the dtypes of ``like``'s leaves."""
    if isinstance(like, (tuple, list)):
        return type(like)(_place(a, b) for a, b in zip(loaded, like))
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(loaded)).to(device=like.device,
                                                      dtype=like.dtype)
    return np.asarray(loaded).item()


def resume_run(checkpointer, state_like):
    """``(state, start_round)`` for a run that may be resuming: the
    checkpointer's latest snapshot placed on the device in fresh tensors,
    or ``state_like`` and round 0.  The round is the one the snapshot was
    taken after; the runner goes on from it, and since every fold order is
    fixed it finishes bitwise equal to the uninterrupted run."""
    if checkpointer is None:
        return state_like, 0
    state, start = checkpointer.load(state_like)
    if start:
        state = _place(state, state_like)
    return state, start


def run_dense(step: Callable, state, cond: Callable, max_rounds: int):
    """``state = step(state)`` while ``cond(state)``, as one device loop;
    returns ``(rounds, state)`` after one fetch of the round count.  The
    step must not read the device (``run_host`` takes such steps); Python
    scalars in ``state`` become 0-d tensors."""
    state = _as_tensors(state, _state_device(state))

    def one_round(s):
        s = step(s)
        return s, cond(s)

    with StretchGraphs() as graphs:
        state, k = do_while(one_round, state, max_rounds, enter=cond(state),
                            graphs=graphs)
        k = fetch(k)
        graphs.settle(k)
        return k, state


def run_host(step: Callable, state, cond: Callable, max_rounds: int,
             checkpointer=None, fault=None):
    """Eager counterpart of ``run_dense``: one fetch of ``cond`` per round.
    It runs steps that read the device themselves (``sssp_delta``'s bucket
    drain, ``cc_pointer_jump``'s jumps, ``bfs_dirop``'s direction switch)
    and the tiered graphs' rounds that walk the host's buffer pool
    (``pr_pull`` over a streamed CSC mirror).  ``fault`` (a
    ``core.faultio.FaultInjector``) ticks its ``"round"`` site before each
    round, so a drill can delay or kill a run at an exact round;
    ``checkpointer`` resumes from its latest snapshot and offers the state
    to ``maybe_save`` after every round.  Same ``(rounds, state)``
    contract as ``run_dense``; ``max_rounds`` is the total budget, so a
    run resumed at round r runs at most ``max_rounds - r`` more."""
    state, rounds = resume_run(checkpointer, state)
    while rounds < max_rounds and fetch(cond(state)):
        if fault is not None:
            fault.tick("round", key=rounds)
        state = step(state)
        rounds += 1
        if checkpointer is not None:
            checkpointer.maybe_save(state, rounds)
    return rounds, state


# ---------------------------------------------------------------------------
# Streamed execution (out-of-core tiered graphs)
# ---------------------------------------------------------------------------


def _staged_stretch(sg, state, limit, *, step, cond, active, graphs):
    """Consecutive rounds over a pre-staged live shard set
    (``tiered.StagedShards``) as one device do-while loop — the streamed
    twin of ``_sparse_stretch`` / ``_dense_stretch``.  The band is live-set
    stability (``frontier.live_stable``): a round follows while the
    frontier is alive and its live-shard set still equals the staged set,
    so the loop exits the moment the host scheduler would stream another
    schedule.  Returns ``(state, rounds)``; the caller fetches the count
    with the next trip's scalars."""

    def one_round(st):
        st = step(sg, st)
        return st, cond(st) & fr.live_stable(sg, active(sg, st))

    return do_while(one_round, state, limit, graphs=graphs)


@functools.lru_cache(maxsize=None)
def _streamed_step_for(dense_fn):
    """Adapt an engine ``(g, labels, mask) -> (labels, mask)`` dense step
    to ``run_streamed``'s ``(g, state) -> state`` shape, one adapter per
    step."""
    def step(gr, state):
        labels, mask = state
        return dense_fn(gr, labels, mask)
    return step


def _mask_cond(state):
    """Termination for (labels, mask) streamed states: frontier alive."""
    return torch.any(state[1])


def _mask_active(gr, state):
    """Schedule mask for (labels, mask) streamed states."""
    return state[1]


def run_streamed(
    g,
    step: Callable,    # (graph_or_staged, state) -> state
    state,
    cond: Callable,    # (state,) -> device bool
    active: Callable,  # (graph_or_staged, state) -> (n_pad,) bool mask
    max_rounds: int,
    *,
    checkpointer=None,
    fused: bool = True,
    on_rounds: Callable = None,  # (k, live) host callback per retired batch
    ckpt_stats: Callable = None,  # () -> stats dict for a snapshot's manifest
):
    """Runner for a ``tiered.TieredGraph``: frontier-driven shard
    streaming, with device loops over stable live shard sets.

    Each trip fetches ``(cond, frontier_count, live_shard_mask)`` in ONE
    transfer.  When ``fused`` and the live set fits the buffer pool, the
    set is staged (``g.stage``) and the next rounds run as one
    ``_staged_stretch``, whose round count rides back with the next trip's
    scalars: a stretch costs the single fetch an eager round does.  Rounds
    whose live set outgrows the pool run eager, one round a trip, as does
    the whole run when a fault injector is attached (its ``"round"`` ticks)
    or ``fused=False``.  Labels are bitwise identical across the regimes:
    a staged stretch folds the same shards in the same ascending order as
    the eager rounds it replaces.

    ``on_rounds(k, live)`` reports every retired batch of ``k`` rounds
    that all ran over schedule ``live``.  ``checkpointer`` resumes from
    its latest snapshot and is offered the state after every eager round
    and every stretch, once its round count has been fetched (the
    snapshot's host copy is the only added sync, and only when it saves).
    Returns ``(rounds, state)``."""
    state = _as_tensors(state, g.device)
    state, rnd = resume_run(checkpointer, state)
    fault = g.fault
    use_fused = fused and fault is None

    def snapshot():
        if checkpointer is not None:
            checkpointer.maybe_save(
                state, rnd, None if ckpt_stats is None else ckpt_stats())

    def settle(k, live):
        nonlocal rnd
        graphs.settle(k)
        g.charge_staged_rounds(k, live)
        if on_rounds is not None:
            on_rounds(k, live)
        rnd += k
        snapshot()

    pending = None  # (rounds run, live) of the stretch in flight
    with StretchGraphs() as graphs:
        while rnd < max_rounds:
            count, live = g.round_live(active(g, state))
            if pending is None:
                go, count, live = fetch(cond(state), count, live)
            else:
                # ONE blocking fetch settles the in-flight stretch AND
                # picks the next schedule
                go, count, live, k = fetch(cond(state), count, live, pending[0])
                settle(k, pending[1])
                pending = None
                if rnd >= max_rounds:
                    break
            if not go or count == 0:
                break
            live = np.asarray(live, dtype=bool)
            sg = g.stage(live) if use_fused else None
            if sg is None:
                if fault is not None:
                    fault.tick("round", key=rnd)
                g.set_live_hint(live)
                state = step(g, state)
                rnd += 1
                if on_rounds is not None:
                    on_rounds(1, live)
                snapshot()
            else:
                state, k_dev = _staged_stretch(
                    sg, state, max_rounds - rnd, step=step, cond=cond,
                    active=active, graphs=graphs)
                pending = (k_dev, live)
        if pending is not None:
            settle(fetch(pending[0]), pending[1])
    return rnd, state


# ---------------------------------------------------------------------------
# Rung stretches
# ---------------------------------------------------------------------------


def _sparse_round(g, *, step, capacity, budget, lo_cap, lo_budget, cutoff):
    """One (capacity, budget)-rung sparse round over ``(labels, mask,
    scalars)``, and the band predicate of the round after it: the body of
    ``_sparse_stretch``'s loop.  (A single partition never escalates a
    shard, so the step's escalation count is always 0.)"""

    def one_round(st):
        labels, mask, _ = st
        labels, mask, _ = step(g, labels, mask, capacity=capacity, budget=budget)
        sc = fr.round_scalars(g, mask)
        return (labels, mask, sc), fr.sparse_band(sc, capacity, lo_cap, budget,
                                                  lo_budget, cutoff)

    return one_round


def _sparse_stretch(g, labels, mask, scalars, limit, *, graphs, key, **rung):
    """Consecutive same-rung sparse rounds as one device do-while loop: the
    first round always runs, later ones while the band predicate holds.
    Returns ``(labels, mask, scalars, rounds)``; ``scalars`` describe the
    next round."""
    (labels, mask, scalars), k = do_while(_sparse_round(g, **rung),
                                          (labels, mask, scalars), limit,
                                          graphs=graphs, key=key)
    return labels, mask, scalars, k


def _dense_stretch(g, labels, mask, scalars, limit, *, step, cutoff, count_mass,
                   graphs, key):
    """Consecutive dense-fallback rounds as one device do-while loop, from
    the entry ``scalars`` of the first round.  Returns ``(labels, mask,
    scalars, rounds, mass)``: with ``count_mass``, ``mass`` is the int64
    sum of every round's entry frontier edge mass (``scalars[3]``,
    ``dense_cost="mass"``), else 0 and nothing more is computed."""

    def one_round(st):
        labels, mask, sc, mass = st
        if count_mass:
            mass = mass + sc[3]
        labels, mask = step(g, labels, mask)
        sc = fr.round_scalars(g, mask)
        return (labels, mask, sc, mass), fr.dense_band(sc, cutoff)

    mass = torch.zeros((), dtype=torch.int64, device=mask.device)
    (labels, mask, scalars, mass), k = do_while(
        one_round, (labels, mask, scalars, mass), limit, graphs=graphs, key=key)
    return labels, mask, scalars, k, (mass if count_mass else 0)


# rung loops kept per graph (a run on the web graph asks for about 8 per
# substrate); the least recently launched one past this count is freed
RUNG_LOOPS = 32
_RUNG_GRAPHS: dict = {}   # id(graph) -> its StretchGraphs


def _drop_rung_graphs(key) -> None:
    _RUNG_GRAPHS.pop(key).close()


def _rung_graphs(g) -> StretchGraphs:
    """The rung loops of ``g``'s fused ladder runs: kept across runs and
    freed with ``g`` (not at interpreter exit, which frees everything)."""
    graphs = _RUNG_GRAPHS.get(id(g))
    if graphs is None:
        graphs = _RUNG_GRAPHS[id(g)] = StretchGraphs(max_loops=RUNG_LOOPS)
        weakref.finalize(g, _drop_rung_graphs, id(g)).atexit = False
    return graphs


class SparseLadderEngine:
    """Dispatches rung stretches along a (capacity, budget) ladder
    (``fused=False`` dispatches one round at a time; a tiered graph goes
    to ``run_streamed``).  A sparse round charges its budget to
    ``edges_touched``; a dense round charges m (``dense_cost="m"``) or its
    entry frontier's edge mass (``dense_cost="mass"``, the peel-style work
    convention).  ``labels`` may be any tensor tree the steps thread
    through (kcore passes an ``(alive, degree)`` pair); ``mask`` is the
    (n_pad,) bool frontier.  Both ladders are geometric with base 4, the
    reference's default."""

    def __init__(
        self,
        g: Graph,
        sparse_step: Callable,  # (g, labels, mask, capacity, budget) -> (labels, mask, esc)
        dense_step: Callable,   # (g, labels, frontier_mask) -> (labels, mask)
        dense_cost: str = "m",
        fused: bool = True,
    ):
        if dense_cost not in ("m", "mass"):
            raise ValueError(f"dense_cost must be 'm' or 'mass', not {dense_cost!r}")
        self.dense_cost = dense_cost
        self.fused = fused
        self._stretch_keys = set()
        self._round_keys = set()
        self.g = g
        self.cap_ladder = fr.ladder_capacities(g.n_pad, g.block_size)
        self.budget_ladder = fr.ladder_capacities(g.m_pad, g.block_size)
        # sparse rounds stop paying once they would cost about a dense one
        self.sparse_cutoff = self.budget_ladder[-1] // 2
        self._sparse_fn = sparse_step
        self._dense_fn = dense_step
        self.stats = RunStats.from_graph(g)

    def run(self, labels, mask, max_rounds: int = 10_000, checkpointer=None):
        """Run to the fixed point or ``max_rounds`` (the total budget).
        ``checkpointer`` (``checkpoint.RunCheckpointer``) resumes from its
        latest snapshot of ``(labels, mask)`` and snapshots at the host
        boundaries of each regime: after a stretch's fetch (fused and
        streamed) or after a round (per-round)."""
        self.stats.substrate = ops.run_substrate(self.g)
        if getattr(self.g, "is_tiered", False):
            return self._run_streamed(labels, mask, max_rounds, checkpointer)
        if self.fused:
            return self._run_fused(labels, mask, max_rounds, _rung_graphs(self.g),
                                   checkpointer)
        return self._run_per_round(labels, mask, max_rounds, checkpointer)

    def _run_streamed(self, labels, mask, max_rounds: int, checkpointer=None):
        """Streamed dispatch for a ``tiered.TieredGraph`` through
        ``run_streamed``.  Rounds that leave shards idle count as sparse,
        rounds touching every shard as dense (a stretch's rounds share one
        schedule, so the classification is per-round exact); the stream
        counters' deltas fold into ``h2d_bytes`` / ``shards_streamed`` /
        ``buffer_hits`` / ``edges_touched`` at the end."""
        g = self.g
        io0 = g.io.snapshot()

        def on_rounds(k, live):
            self.stats.rounds += k
            if int(live.sum()) < g.nshards:
                self.stats.sparse_rounds += k
            else:
                self.stats.dense_rounds += k

        _, (labels, mask) = run_streamed(
            g, _streamed_step_for(self._dense_fn), (labels, mask),
            _mask_cond, _mask_active, max_rounds, checkpointer=checkpointer,
            fused=self.fused, on_rounds=on_rounds, ckpt_stats=self.stats.as_dict)
        g.io.fold_delta(self.stats, io0)
        return labels, mask

    def _note(self, keys: set, key):
        """``compiles`` counts the distinct rung executables a run asks for
        (stretch keys when fused, rung steps per round) — the reference's
        count of jit traces, kept so the counters compare."""
        if key not in keys:
            keys.add(key)
            self.stats.compiles += 1

    def _settle(self, budget, k, mass=0):
        """Fold k rounds into RunStats: dense when ``budget`` is None, then
        charged ``mass`` (their entry frontier mass) under
        ``dense_cost="mass"``, else k·m."""
        self.stats.rounds += k
        if budget is None:
            self.stats.dense_rounds += k
            self.stats.edges_touched += (
                mass if self.dense_cost == "mass" else k * self.g.m)
        else:
            self.stats.sparse_rounds += k
            self.stats.edges_touched += k * budget

    def _pick(self, cap_need, mass_med):
        """Host rung decision ``(cap, budget, dense?)``; counts an overflow
        escalation like the reference (unreachable while pick_capacity
        honours the ladder, kept as the backstop)."""
        cap = fr.pick_capacity(max(cap_need, 1), self.cap_ladder)
        budget = fr.pick_capacity(max(mass_med, 1), self.budget_ladder)
        overflow = budget < mass_med or cap < cap_need
        if overflow and mass_med <= self.sparse_cutoff:
            self.stats.overflow_escalations += 1
        return cap, budget, mass_med > self.sparse_cutoff or overflow

    def _run_fused(self, labels, mask, max_rounds: int, graphs, checkpointer=None):
        g = self.g
        # a rung loop outlives the run: its key names the steps it captured
        key_mode = (self._sparse_fn, self._dense_fn, self.dense_cost,
                    ops.get_substrate(), ops.get_deterministic_add())
        # a resumed state is placed in fresh tensors: a kept rung loop's
        # buffers are only ever filled by copies at its launch
        (labels, mask), round_no = resume_run(checkpointer, (labels, mask))
        scalars = fr.round_scalars(g, mask)
        rounds_left = max_rounds - round_no
        pending = None  # (budget or None, rounds, mass) of the stretch in flight
        while True:
            # ONE blocking fetch per stretch: the stretch's counters and the
            # next round's ladder scalars in a single transfer
            if pending is None:
                sc = fetch(scalars)
            else:
                sc, k, mass = fetch(scalars, pending[1], pending[2])
                graphs.settle(k)
                self._settle(pending[0], k, mass)
                rounds_left -= k
                round_no += k
                pending = None
                # the stretch's state is settled: a snapshot copies it to
                # the host before the next stretch launches (a stretch may
                # retire many rounds: maybe_save counts rounds since the
                # last snapshot)
                if checkpointer is not None:
                    checkpointer.maybe_save((labels, mask), round_no,
                                            self.stats.as_dict())
            count, cap_need, mass_med, _ = sc
            if count == 0 or rounds_left <= 0:
                break
            cap, budget, dense = self._pick(cap_need, mass_med)
            if dense:
                key = ("dense", *key_mode)
                self._note(self._stretch_keys, key)
                labels, mask, scalars, k, mass = _dense_stretch(
                    g, labels, mask, scalars, rounds_left,
                    step=self._dense_fn, cutoff=self.sparse_cutoff,
                    count_mass=self.dense_cost == "mass", graphs=graphs, key=key)
                pending = (None, k, mass)
            else:
                key = ("sparse", cap, budget, *key_mode)
                self._note(self._stretch_keys, key)
                labels, mask, scalars, k = _sparse_stretch(
                    g, labels, mask, scalars, rounds_left, step=self._sparse_fn,
                    capacity=cap, budget=budget,
                    lo_cap=fr.ladder_below(cap, self.cap_ladder),
                    lo_budget=fr.ladder_below(budget, self.budget_ladder),
                    cutoff=self.sparse_cutoff, graphs=graphs, key=key)
                pending = (budget, k, 0)
        return labels, mask

    def _run_per_round(self, labels, mask, max_rounds: int, checkpointer=None):
        g = self.g
        (labels, mask), rnd = resume_run(checkpointer, (labels, mask))
        while rnd < max_rounds:
            count, cap_need, mass_med, mass_tot = fetch(fr.round_scalars(g, mask))
            if count == 0:
                break
            cap, budget, dense = self._pick(cap_need, mass_med)
            if dense:
                self._note(self._round_keys, "dense")
                labels, mask = self._dense_fn(g, labels, mask)
                self._settle(None, 1, mass_tot)
            else:
                self._note(self._round_keys, (cap, budget))
                labels, mask, _ = self._sparse_fn(
                    g, labels, mask, capacity=cap, budget=budget)
                self._settle(budget, 1)
            rnd += 1
            if checkpointer is not None:
                checkpointer.maybe_save((labels, mask), rnd, self.stats.as_dict())
        return labels, mask
