"""Serve layer (``eval/inference.py``): the share of the device's idle time
in the traced stretch that the host spent copying a chunk in
(``infer.copy_in``) or draining one back (``infer.drain``: each copy back
waits for the stream, then the labels are copied into the volume), each gap
split among the spans the host was in while it lasted (``spans.py``). Base:
every gap between device records in the traced stretch, which the profiler
lengthens, so the share compares one commit with another and is not seconds
of the untraced window. Unread where the program opens no spans or the
profiler lost records of its kernels."""

from port_bench.spans import idle_share

UNIT = "%"


def read(ctx):
    return idle_share(ctx, "serve_volumes", ("infer.copy_in", "infer.drain"))
