"""The device-time accounting of a traced window, from ``torch.profiler``
(CPU and CUDA activity): the union of device activity (kernels, copies,
memsets on any stream), the idle gaps between, each gap named by the
innermost host operation running at its middle, and device time by
operation.  Each traced trial runs inside a ``record_function`` range
named ``TRIAL``, which places it on the profiler's clock."""

from __future__ import annotations

import bisect

TRIAL = "graphbench.trial"
TOP = 10


def profiler(device):
    """A profiler over the host and, on a CUDA device, the card."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def merge(intervals):
    """Sorted, disjoint union of ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def covered(union, lo, hi) -> float:
    """Length of ``union`` inside [lo, hi]."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in union)


def gaps(union, lo, hi):
    """The idle intervals of [lo, hi] outside ``union``."""
    out, at = [], lo
    for s, e in union:
        if e <= lo or s >= hi:
            continue
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def idle_percent(ctx):
    """The device's idle share of a traced window, or ``None`` where the
    profiler saw nothing or the trials replayed the device loop's CUDA
    graphs, whose kernels it does not see."""
    t = ctx["trace"]
    if not t["busy_s"] or ctx["loop_launches"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def summarise(events):
    """From a profiler's ``events()``: the traced trials' ranges, the
    device's busy seconds in each, the window they span with its busy and
    idle seconds, the top device operations and the idle time by host
    operation.  Times in seconds; ``None`` fields where the profiler saw
    no device activity."""
    from torch.autograd import DeviceType
    dev, host, trials = [], [], []
    for ev in events:
        tr = ev.time_range
        if ev.name == TRIAL:
            # the range shows on the device's timeline too, as an annotation
            if ev.device_type != DeviceType.CUDA:
                trials.append((tr.start * 1e-6, tr.end * 1e-6))
        elif ev.device_type == DeviceType.CUDA:
            dev.append((ev.name, tr.start * 1e-6, tr.end * 1e-6))
        else:
            host.append((tr.start * 1e-6, tr.end * 1e-6, ev.name))
    trials.sort()
    if not trials:
        raise RuntimeError("the trace holds no traced trial")
    lo, hi = trials[0][0], trials[-1][1]
    union = merge([(s, e) for _, s, e in dev])
    by_op: dict = {}
    for name, s, e in dev:
        by_op[name] = by_op.get(name, 0.0) + (e - s)
    host.sort()
    starts = [h[0] for h in host]
    idle: dict = {}
    for s, e in gaps(union, lo, hi):
        mid = 0.5 * (s + e)
        name = "host outside any operation"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - 4096), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        idle[name] = idle.get(name, 0.0) + (e - s)
    busy = covered(union, lo, hi)
    return dict(
        window_s=hi - lo,
        busy_s=busy if union else None,
        trial_busy_s=[covered(union, s, e) for s, e in trials] if union else None,
        trial_ranges=trials,
        device_ops=sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP],
        idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1])[:TOP],
    )
