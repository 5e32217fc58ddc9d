"""The device memory the program held at its peak inside the window,
apart from set-up's build (``torch.cuda.max_memory_allocated`` after a
reset at the window's start).  Nothing off a CUDA device."""


def read(ctx):
    peak = ctx["peak_window_bytes"]
    return peak / 2**30 if peak else None
