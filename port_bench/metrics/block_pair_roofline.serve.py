"""Kernels (``ops/cuda/csrc``): the block_pair family's bound over its device
time in the traced volumes, the kernels of the instance that the
configuration's ``compute_dtype`` runs (``trace.FAMILIES``). The bound sums
each launch's work (``work.serve_calls``, every chunk at its batch), on the
route the launch counters show; unread where no route matches them, the
family did not run or the trace lost records."""

from port_bench import rooflines

UNIT = "%"


def read(ctx):
    return rooflines.share(ctx, "serve_volumes", "block_pair")
