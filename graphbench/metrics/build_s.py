"""Seconds of the program's graph build: the sum of ``from_coo``'s
``timings`` stages (copy, dedup, csr, csc), each ended by a synchronize."""


def read(ctx):
    stages = ctx["build"]
    return sum(stages.values()) if stages else None
