"""Blocking device reads of the engine (``engine.fetch.calls``) over the
traced trials, per trial."""


def read(ctx):
    trials = ctx["trials"]
    return ctx["fetches"] / len(trials) if trials else None
