"""Kernels (``ops/cuda/csrc``): the gemm family's bound over its device
time in the traced steps (``trace.FAMILY_KERNELS["gemm"]``). The bound sums each
launch's work (``work.train_calls``), on the route the launch counters
show; unread where no route matches them or the trace lost records."""

from port_bench import rooflines

UNIT = "%"


def read(ctx):
    return rooflines.share(ctx, "train", "gemm")
