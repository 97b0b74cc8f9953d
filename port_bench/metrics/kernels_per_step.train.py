"""Kernel wrappers (``ops/cuda/kernels.py``): device kernel records a step
in the traced steps, the program's and torch's."""

UNIT = "count"


def read(ctx):
    if ctx.mode != "train" or not ctx.trace.device:
        return None
    return ctx.trace.kernels / len(ctx.trace.units)
