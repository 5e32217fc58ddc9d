"""Wrappers of the graph_ops CUDA kernels (``csrc/graph_ops.cu``).

On CUDA tensors a wrapper checks device, dtype, shape and contiguity,
allocates its outputs with ``torch.empty``, launches on the current
stream, raises when the launch function reports an error, and adds one to
its ``launches`` count.  On CPU tensors it calls the plain version in
``ref.py`` and launches nothing.  There is no other path: a CUDA tensor
the kernel does not take raises.
"""

from __future__ import annotations

import weakref

import torch

from .. import build
from . import ref

_KIND = {"min": 0, "max": 1, "add": 2, "or": 3}
_DTYPE = {torch.float32: 0, torch.int32: 1, torch.uint8: 2}
# edge_relax's cases: (id, takes a vertex mask)
_CASE = {"push": (0, True), "pull": (1, True), "batch": (2, False),
         "edges": (3, False)}
# (dtype, kind) pairs the edge_relax kernel takes, and whether weighted
_RELAX_TYPES = {
    (torch.float32, "min"): True, (torch.float32, "max"): True,
    (torch.float32, "add"): True,
    (torch.int32, "min"): False, (torch.int32, "max"): False,
    (torch.int32, "add"): False,
    (torch.uint8, "or"): False,
}


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _expect(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def edge_relax(src, dst, w, mask, src_val, out_init, *, kind: str = "min",
               use_weight: bool = True, vertex_mask: bool = True,
               case: str | None = None, gate=None):
    """Push/pull/batch relax over an edge list.

    ``mask``: (n_pad,) active-vertex bitmap when ``vertex_mask`` (push and
    pull), else a per-edge validity mask aligned with ``src`` (batch
    relax).  Returns a new (n_pad,) accumulator seeded from ``out_init``.
    ``case`` names the caller's sweep — ``"push"`` or ``"pull"`` (vertex
    mask), ``"batch"`` or ``"edges"`` (per-slot mask); it picks the
    layout of a warp's slots (rows of 32 consecutive slots for push, batch
    and edges; four consecutive slots a lane for pull), the grid (one
    resident wave, or a block per eight tiles) and the kernel's name in a
    profile (default: push or edges).

    ``gate``: None, or a 0-d int32 tensor on the device.  Where it holds 0
    the result is ``out_init``: the launch seeds ``out`` and every block of
    the relax reads the gate first and returns (the sharded sparse round
    picks a shard's sparse or dense relax this way, inside a captured
    round).  The plain version is ``ref.gated``.
    """
    if src.device.type == "cpu":
        if vertex_mask:
            out = ref.push_ref(src, dst, w, src_val, mask, out_init, kind, use_weight)
        else:
            out = ref.relax_ref(src, dst, w, mask, src_val, out_init, kind, use_weight)
        return out if gate is None else ref.gated(gate, out, out_init)
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"edge_relax runs on cuda or cpu tensors, not {dev}")
    if case is None:
        case = "push" if vertex_mask else "edges"
    if _CASE.get(case, (None, None))[1] != vertex_mask:
        raise ValueError(f"edge_relax case {case!r} does not take "
                         f"vertex_mask={vertex_mask}")
    m = src.shape[0]
    n_pad = out_init.shape[0]
    widen = kind == "or" and out_init.dtype == torch.bool
    if widen:
        # bool has no atomics: reduce as uint8 max (ref.scatter_reduce's 'or')
        src_val = src_val.to(torch.uint8)
        out_init = out_init.to(torch.uint8)
    weighted = _RELAX_TYPES.get((out_init.dtype, kind))
    if weighted is None or (use_weight and not weighted):
        raise TypeError(f"edge_relax kernel does not take kind={kind!r} over "
                        f"{out_init.dtype} with use_weight={use_weight}")
    _expect(src, "src", torch.int32, (m,), dev)
    _expect(dst, "dst", torch.int32, (m,), dev)
    _expect(w, "w", torch.float32, (m,), dev)
    _expect(mask, "mask", torch.bool, (n_pad if vertex_mask else m,), dev)
    _expect(src_val, "src_val", out_init.dtype, (n_pad,), dev)
    _expect(out_init, "out_init", out_init.dtype, (n_pad,), dev)
    if gate is not None:
        _expect(gate, "gate", torch.int32, (), dev)
    out = torch.empty_like(out_init)   # the launch seeds it from out_init
    if kind == "or" and (n_pad % 4 or out.data_ptr() % 4):
        raise ValueError("the 'or' kernel updates aligned 32-bit words: "
                         "n_pad must be a multiple of 4")
    flag = torch.empty((1,), dtype=torch.int32, device=dev)
    lib = build.load("graph_ops")
    rc = lib.graph_ops_edge_relax(
        src.data_ptr(), dst.data_ptr(), w.data_ptr(), mask.data_ptr(),
        src_val.data_ptr(), out_init.data_ptr(), out.data_ptr(), m, n_pad,
        _DTYPE[out.dtype], _KIND[kind], int(use_weight), _CASE[case][0],
        flag.data_ptr(), 0 if gate is None else gate.data_ptr(), _stream())
    build.check(lib, rc, "edge_relax")
    edge_relax.launches += 1
    return out.to(torch.bool) if widen else out


edge_relax.launches = 0


# lanes one edge_relax_lanes launch takes: the bits of its lane word
LANES = 32


def edge_relax_lanes(src, dst, w, active, src_val, out_init, *, valid=None,
                     kind: str = "min", use_weight: bool = True):
    """The multi-source relax: B label lanes over one shared edge list, each
    slot read once for all of them.

    ``src_val``, ``out_init`` and ``active`` (the bool frontier) are
    (B, n_pad) lane matrices; ``valid`` is None for a push over an edge
    list (a slot fires in lane b when ``active[b, src]``) or the (m,) slot
    mask of a batch (when also ``valid``).  Returns a new (B, n_pad)
    accumulator seeded from ``out_init``: per row ``edge_relax``'s result.
    Out of place: a copy of ``out_init`` (the kernel's seed pass), then
    ``edge_relax_lanes_``'s relax into it."""
    if src.device.type == "cpu":
        return ref.batched_relax_into_ref(src, dst, w, valid, src_val, active,
                                          out_init.clone(), kind, use_weight)
    return _relax_lanes(src, dst, w, active, src_val, torch.empty_like(out_init),
                        out_init, valid=valid, kind=kind, use_weight=use_weight,
                        at=None, changed=None, beyond=None)


def edge_relax_lanes_(src, dst, w, active, src_val, out, *, valid=None,
                      kind: str = "min", use_weight: bool = True, at=None,
                      reseed: bool = False, changed=None, beyond=None):
    """``edge_relax_lanes`` in place: relax into ``out``, which holds the
    seeds; ``src_val`` must be another buffer (an in-place chaotic relax
    would read this round's labels).  Returns ``out``.

    ``at``: for a batch, the int32 vertices every valid slot's src is among
    (the union the batch was advanced from): the lane words are packed
    there only.  ``reseed``: ``out`` equals ``src_val`` except, with
    ``at``, at those columns and the sentinel column (without, anywhere):
    copy ``src_val`` there first.  ``changed`` (min, max, or): an
    all-False (B, n_pad) bool matrix, set where the relax moved ``out`` to
    a value unequal to its seed (the caller's ``new != old``; never the
    sentinel column; a NaN seed, unequal to itself, is set only where
    moved).  ``beyond``: None when no seed lies beyond the neutral (f32
    min/max: above FLT_MAX, below -FLT_MAX), else a (B,) bool mask of the
    lanes whose seeds may (``ref.lanes_beyond``); a reseed without ``at``
    finds them itself.  One launch takes up to ``LANES`` lanes; B > 32
    runs as groups of 32, one launch (and one count) each."""
    if at is not None and valid is None:
        raise ValueError("at lists the sources of a batch's valid slots: a push reads "
                         "every vertex's lane word")
    if changed is not None and kind == "add":
        raise ValueError("a sum has no changed lanes: changed is for min, max and or")
    if ref._overlap(src_val, out):
        raise ValueError("src_val must not alias out: an in-place relax reads "
                         "last round's labels")
    if src.device.type == "cpu":
        return ref.batched_relax_into_ref(src, dst, w, valid, src_val, active, out,
                                          kind, use_weight, at=at, reseed=reseed,
                                          changed=changed)
    return _relax_lanes(src, dst, w, active, src_val, out, src_val if reseed else None,
                        valid=valid, kind=kind, use_weight=use_weight, at=at,
                        changed=changed, beyond=beyond)


def _relax_lanes(src, dst, w, active, src_val, out, seed, *, valid, kind, use_weight,
                 at, changed, beyond):
    """The launches of both lanes wrappers, one per group of 32 lanes."""
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"edge_relax_lanes runs on cuda or cpu tensors, not {dev}")
    if out.dim() != 2:
        raise ValueError(f"out must be (B, n_pad), not {tuple(out.shape)}")
    m = src.shape[0]
    lanes, n_pad = out.shape
    dtype = out.dtype
    if kind == "or" and dtype == torch.bool:
        # bool has no atomics: reduce its bytes as uint8 max (ref's 'or')
        src_val, out = src_val.view(torch.uint8), out.view(torch.uint8)
        seed = None if seed is None else seed.view(torch.uint8)
    weighted = _RELAX_TYPES.get((out.dtype, kind))
    if weighted is None or (use_weight and not weighted):
        raise TypeError(f"edge_relax_lanes kernel does not take kind={kind!r} over "
                        f"{dtype} with use_weight={use_weight}")
    _expect(src, "src", torch.int32, (m,), dev)
    _expect(dst, "dst", torch.int32, (m,), dev)
    _expect(w, "w", torch.float32, (m,), dev)
    if valid is not None:
        _expect(valid, "valid", torch.bool, (m,), dev)
    _expect(active, "active", torch.bool, (lanes, n_pad), dev)
    _expect(src_val, "src_val", out.dtype, (lanes, n_pad), dev)
    _expect(out, "out", out.dtype, (lanes, n_pad), dev)
    if seed is not None:
        _expect(seed, "seed", out.dtype, (lanes, n_pad), dev)
    if at is not None:
        _expect(at, "at", torch.int32, (at.shape[0],), dev)
    if changed is not None:
        _expect(changed, "changed", torch.bool, (lanes, n_pad), dev)
    if beyond is not None:
        _expect(beyond, "beyond", torch.bool, (lanes,), dev)
    if kind == "or" and (n_pad % 4 or out.data_ptr() % 4):
        raise ValueError("the 'or' kernel updates aligned 32-bit words: "
                         "n_pad must be a multiple of 4")
    i32 = dict(dtype=torch.int32, device=dev)
    words = torch.empty((n_pad,), **i32)   # scratch, reused by each group in stream order
    flag = torch.empty((1,), **i32)
    lib = build.load("graph_ops")
    row = n_pad * out.element_size()

    def at_row(t, lo, size):
        return None if t is None else t.data_ptr() + lo * size

    for lo in range(0, lanes, LANES):
        k = min(LANES, lanes - lo)
        rc = lib.graph_ops_edge_relax_lanes(
            src.data_ptr(), dst.data_ptr(), w.data_ptr(), at_row(valid, 0, 0),
            active.data_ptr() + lo * n_pad, src_val.data_ptr() + lo * row,
            at_row(seed, lo, row), out.data_ptr() + lo * row, m, n_pad, k,
            _DTYPE[out.dtype], _KIND[kind], int(use_weight),
            at_row(at, 0, 0), 0 if at is None else at.shape[0],
            at_row(changed, lo, n_pad), at_row(beyond, lo, 1), words.data_ptr(),
            flag.data_ptr(), _stream())
        build.check(lib, rc, "edge_relax_lanes")
        edge_relax_lanes.launches += 1
    return out.view(dtype)


edge_relax_lanes.launches = 0


def advance_frontier(f_idx, f_count, out_deg, row_ptr, col_idx, edge_w, *,
                     budget: int, sentinel: int, m_pad: int):
    """Merge-path frontier expansion into ``budget`` edge slots; returns
    ``(src, dst, w, valid, total)`` with ``total`` a 0-d int32 tensor."""
    if f_idx.device.type == "cpu":
        return ref.advance_ref(f_idx, f_count, out_deg, row_ptr, col_idx,
                               edge_w, budget, sentinel, m_pad)
    dev = f_idx.device
    if dev.type != "cuda":
        raise ValueError(f"advance_frontier runs on cuda or cpu tensors, not {dev}")
    cap = f_idx.shape[0]
    n_pad = out_deg.shape[0]
    if not (0 < cap <= n_pad and 0 < budget < 2**31 and m_pad == col_idx.shape[0]):
        raise ValueError(f"bad advance shapes: cap={cap} n_pad={n_pad} "
                         f"budget={budget} m_pad={m_pad}/{col_idx.shape[0]}")
    _expect(f_idx, "f_idx", torch.int32, (cap,), dev)
    _expect(f_count, "f_count", torch.int32, (), dev)
    _expect(out_deg, "out_deg", torch.int32, (n_pad,), dev)
    _expect(row_ptr, "row_ptr", torch.int32, (n_pad + 1,), dev)
    _expect(col_idx, "col_idx", torch.int32, (m_pad,), dev)
    _expect(edge_w, "edge_w", torch.float32, (m_pad,), dev)
    i32 = dict(dtype=torch.int32, device=dev)
    cum = torch.empty((cap,), **i32)
    # the scan's tile status words (8 B per 2,048 entries) and its ticket
    tiles = torch.empty((2 * ((cap + 2047) // 2048) + 2,), **i32)
    total = torch.empty((1,), **i32)
    out_src = torch.empty((budget,), **i32)
    out_dst = torch.empty((budget,), **i32)
    out_w = torch.empty((budget,), dtype=torch.float32, device=dev)
    valid = torch.empty((budget,), dtype=torch.bool, device=dev)
    lib = build.load("graph_ops")
    rc = lib.graph_ops_advance(
        f_idx.data_ptr(), f_count.data_ptr(), out_deg.data_ptr(),
        row_ptr.data_ptr(), col_idx.data_ptr(), edge_w.data_ptr(), cap, budget,
        sentinel, m_pad, cum.data_ptr(), tiles.data_ptr(), total.data_ptr(),
        out_src.data_ptr(), out_dst.data_ptr(), out_w.data_ptr(),
        valid.data_ptr(), _stream())
    build.check(lib, rc, "advance_frontier")
    advance_frontier.launches += 1
    return out_src, out_dst, out_w, valid, total[0]


advance_frontier.launches = 0


# one launch keeps every candidate index in int32: its edges x dmax stay
# below this
INTERSECT_MASS = 2**31 - 2**16
# the last adjacency's row lengths: [weakref to adj, adj's version,
# sentinel, lengths]
_ROW_LEN = [None, -1, -1, None]


def row_lengths(adj, sentinel: int):
    """The real lengths of adj's rows (entries other than the sentinel) as
    int32, computed by one pass over adj and kept for the next call with
    the same ``adj`` object while it lives unmodified (its version counter
    unchanged), so a caller that intersects one adjacency chunk by chunk
    pays the pass once."""
    ref_, version, sent, lengths = _ROW_LEN
    if ref_ is not None and ref_() is adj and (version, sent) == (adj._version, sentinel):
        return lengths
    lengths = (adj != sentinel).sum(1, dtype=torch.int32)
    _ROW_LEN[:] = [weakref.ref(adj), adj._version, sentinel, lengths]
    return lengths


def intersect_count(adj, src, dst, *, sentinel: int, chunk=None):
    """Oriented sorted-intersection count over an edge batch: the int32
    total of |N+(src_i) ∩ N+(dst_i)| as a 0-d tensor on ``adj``'s device.
    ``adj`` is the (n_pad, dmax) sorted, sentinel-padded oriented
    adjacency with ``sentinel = n_pad - 1``.  The kernel's candidate
    counts, the real lengths of adj's rows, come from ``row_lengths``:
    one pass over each adjacency.

    ``chunk``: return the (ceil(e / chunk),) int32 counts of each slice of
    ``chunk`` edges instead of the total.  One launch takes as many whole
    chunks as keep its edges x dmax below ``INTERSECT_MASS``; the plain
    version goes chunk by chunk."""
    e = src.shape[0]
    if adj.device.type == "cpu":
        if chunk is None:
            return ref.intersect_ref(adj, src, dst, sentinel)
        return ref.intersect_chunks_ref(adj, src, dst, sentinel, chunk)
    dev = adj.device
    if dev.type != "cuda":
        raise ValueError(f"intersect_count runs on cuda or cpu tensors, not {dev}")
    if adj.dim() != 2 or adj.shape[1] < 1 or src.dim() != 1:
        raise ValueError(f"bad intersect shapes: adj {tuple(adj.shape)}, "
                         f"src {tuple(src.shape)}")
    n_rows, dmax = adj.shape
    if sentinel != n_rows - 1:
        raise ValueError(f"sentinel {sentinel} is not the last row {n_rows - 1}")
    most = INTERSECT_MASS // dmax        # edges one launch may take
    step = chunk or max(e, 1)            # edges per partial count
    if chunk is not None and not 0 < chunk <= most:
        raise ValueError(f"chunk {chunk} x dmax {dmax} must lie in (0, {INTERSECT_MASS}]")
    step = min(step, most)
    _expect(adj, "adj", torch.int32, (n_rows, dmax), dev)
    _expect(src, "src", torch.int32, (e,), dev)
    _expect(dst, "dst", torch.int32, (e,), dev)
    row_len = row_lengths(adj, sentinel)
    nch = -(-e // step)
    if e == 0:
        partial = torch.zeros((0,), dtype=torch.int32, device=dev)
    else:
        group = min(e, most // step * step)    # whole chunks per launch
        lib = build.load("graph_ops")
        # the partials (zeroed by the launches that write them), then the
        # launches' scratch, 16-B aligned
        head = -(-nch // 4) * 4
        buf = torch.empty((head + lib.graph_ops_intersect_scratch(group, dmax),),
                          dtype=torch.int32, device=dev)
        partial = buf[:nch]
        for g0 in range(0, e, group):
            eg = min(group, e - g0)
            rc = lib.graph_ops_intersect(
                adj.data_ptr(), n_rows, dmax, src.data_ptr() + 4 * g0,
                dst.data_ptr() + 4 * g0, row_len.data_ptr(), eg, step,
                buf.data_ptr() + 4 * head,
                buf.data_ptr() + 4 * (g0 // step), -(-eg // step), _stream())
            build.check(lib, rc, "intersect_count")
            intersect_count.launches += 1
    if chunk is not None:
        return partial
    if partial.shape[0] == 1:
        return partial[0]
    return partial.sum(dtype=torch.int32)


intersect_count.launches = 0

_KERNELS = {"edge_relax": edge_relax, "advance": advance_frontier,
            "intersect": intersect_count, "edge_relax_lanes": edge_relax_lanes}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in _KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _KERNELS.items()}
