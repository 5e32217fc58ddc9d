"""The traced trials' least bytes (each answer kind's ``least_bytes``, from
the plain reference's answer: ``gbharness.roofline``) over HBM's peak
rate, as a share of the device's busy time in those trials.  Nothing
where an answer kind has no bound, or where the trials replayed the
device loop's CUDA graphs, whose kernels the profiler does not see."""


def read(ctx):
    busy = ctx["trace"]["trial_busy_s"]
    least = ctx["least_bytes"]
    if not busy or ctx["loop_launches"] or len(least) != len(busy) or None in least:
        return None
    return 100.0 * sum(least) / ctx["hbm_bytes_per_s"] / sum(busy)
