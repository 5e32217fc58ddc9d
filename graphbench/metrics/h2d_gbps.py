"""Host-to-device bytes the tier streamed (``RunStats.h2d_bytes``) over
the traced solves' wall, in GB/s."""


def read(ctx):
    trials = ctx["trials"]
    wall = sum(t.wall for t in trials)
    moved = sum(t.stats.get("h2d_bytes", 0) for t in trials)
    return moved / wall / 1e9 if moved and wall > 0 else None
