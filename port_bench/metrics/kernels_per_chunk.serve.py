"""Kernel wrappers (``ops/cuda/kernels.py``): device kernel records a chunk
(a forward of the model) in the traced volumes, the program's and torch's."""

UNIT = "count"


def read(ctx):
    if ctx.mode != "serve_volumes" or not ctx.trace.device or not ctx.trace.units:
        return None
    return ctx.trace.kernels / len(ctx.trace.units)
