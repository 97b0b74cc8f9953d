"""Kernels (``ops/cuda/csrc``): the gemm family's bound over its device time in
the traced steps, the kernels of the instance that the configuration's
``compute_dtype`` runs (``trace.FAMILIES``). The bound sums each launch's
work (``work.train_calls``), on the route the launch counters show; unread
where no route matches them or the trace lost records."""

from port_bench import rooflines

UNIT = "%"


def read(ctx):
    return rooflines.share(ctx, "train", "gemm")
