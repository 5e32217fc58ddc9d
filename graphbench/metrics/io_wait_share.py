"""The host's time in the tier's miss path (``RunStats.io_wait_us``: the
read, the copy and its CRC check it waits for) as a share of the traced
solves' wall."""


def read(ctx):
    trials = ctx["trials"]
    wall = sum(t.wall for t in trials)
    waited = sum(t.stats.get("io_wait_us", 0) for t in trials) * 1e-6
    return 100.0 * waited / wall if waited and wall > 0 else None
