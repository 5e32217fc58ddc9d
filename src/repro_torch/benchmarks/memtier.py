"""Paper Tables 1/2 — the memory tiers, measured on the card.

The port's counterpart of the JAX package's ``benchmarks/memtier.py``.
The paper measures Optane PMM against DRAM to ground its principles; the
JAX suite reports published TPU tier constants.  Here the tiers of the
out-of-core path are measured on the card itself: HBM (the fast tier)
against the host's pinned and pageable memory (the far tier), the
denominators of ``outofcore``'s and ``chip_smoke.py``'s H2D rates.

Rows (names follow the JAX suite; ``us`` is a 4-byte copy's latency,
host clock around the copy and a synchronize, median of 200):

* ``table1/hbm``           — device-to-device copy of 256 MiB: ``copy_gbps``
  is the bytes copied per second (each is read once and written once);
* ``table1/host_pinned``   — pinned host to device, 256 MiB;
* ``table1/host_pageable`` — pageable host to device, 256 MiB;
* ``table1/d2h_pinned``    — device to pinned host, 256 MiB;
* ``table2/near_over_far_bw`` — HBM copy rate over pinned H2D;
  ``table2/pinned_over_pageable_bw`` — pinned over pageable H2D;
* ``fig3/host_write_{cold,warm}_{64,256}MB`` — the JAX suite's host write
  rows (first touch of a fresh buffer, then a rewrite), on the host;
* ``outofcore/shard_stream_64MB`` — one 64 MiB pinned H2D copy, measured
  (the JAX suite models it from a published rate).

Copy rates are CUDA-event times, median of 5 after a warm-up.

    python -m repro_torch.benchmarks.memtier [--emit-json PATH] [--device cpu]

Runs on the card; without one it raises unless given ``--device cpu``,
which prints the host rows only (no device tier is measured there).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core.graph import _device
from .common import print_rows, row, rows_as_json

MIB = 2**20


def _event_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of ``fn`` in ms, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _latency_us(dst, src, reps: int = 200) -> float:
    """Median host-clock time of one blocking 4-byte copy, in µs."""
    dst.copy_(src)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(times))


def device_rows(dev, mib: int = 256):
    nbytes = mib * MIB
    d_a = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    d_b = torch.empty_like(d_a)
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    pageable = torch.empty(nbytes, dtype=torch.uint8)
    pageable.numpy()[:] = 1
    pinned.numpy()[:] = 1
    d4 = torch.empty(4, dtype=torch.uint8, device=dev)
    h4 = torch.empty(4, dtype=torch.uint8, pin_memory=True)
    d4b = torch.empty_like(d4)

    def gbps(ms):
        return nbytes / (ms * 1e-3) / 1e9

    hbm = gbps(_event_ms(lambda: d_b.copy_(d_a)))
    h2d = gbps(_event_ms(lambda: d_a.copy_(pinned, non_blocking=True)))
    h2d_pageable = gbps(_event_ms(lambda: d_a.copy_(pageable)))
    d2h = gbps(_event_ms(lambda: pinned.copy_(d_a, non_blocking=True)))
    shard = d_a[:64 * MIB]
    shard_ms = _event_ms(lambda: shard.copy_(pinned[:64 * MIB], non_blocking=True))
    rows = [
        row("table1/hbm", _latency_us(d4b, d4),
            f"copy_gbps={hbm:.1f};mib={mib};latency=d2d_4B"),
        row("table1/host_pinned", _latency_us(d4, h4),
            f"h2d_gbps={h2d:.2f};mib={mib};latency=h2d_4B"),
        row("table1/host_pageable", _latency_us(d4, torch.empty(4, dtype=torch.uint8)),
            f"h2d_gbps={h2d_pageable:.2f};mib={mib};latency=h2d_4B_pageable"),
        row("table1/d2h_pinned", _latency_us(h4, d4),
            f"d2h_gbps={d2h:.2f};mib={mib};latency=d2h_4B"),
        row("table2/near_over_far_bw", 0.0, f"ratio={hbm / h2d:.1f}"),
        row("table2/pinned_over_pageable_bw", 0.0, f"ratio={h2d / h2d_pageable:.2f}"),
        row("outofcore/shard_stream_64MB", shard_ms * 1e3,
            f"h2d_gbps={64 * MIB / (shard_ms * 1e-3) / 1e9:.2f}"),
    ]
    return rows


def host_rows():
    """The JAX suite's host write rows: the first touch of a fresh buffer
    (page faults) and a rewrite, in GB/s."""
    rows = []
    for mb in (64, 256):
        buf = np.empty(mb * MIB, dtype=np.uint8)
        t0 = time.perf_counter()
        buf[:] = 1
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        buf[:] = 2
        warm = time.perf_counter() - t0
        for phase, dt in (("cold", cold), ("warm", warm)):
            rows.append(row(f"fig3/host_write_{phase}_{mb}MB", dt * 1e6,
                            f"gbytes_per_s={mb * MIB / dt / 1e9:.2f}"))
    return rows


def run(device=None):
    dev = _device(device)
    rows = device_rows(dev) if dev.type == "cuda" else []
    return rows + host_rows()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--emit-json", metavar="PATH",
                    help="also write the rows as JSON to PATH")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' prints the host rows only)")
    args = ap.parse_args(argv)
    rows = run(args.device)
    if _device(args.device).type != "cuda":
        print("memtier: no device tier measured on the CPU")
    print_rows(rows)
    if args.emit_json:
        with open(args.emit_json, "w") as fh:
            json.dump(rows_as_json("memtier", rows), fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
