"""Train loop (``train/trainer.py``): the share of the device's idle time in
the traced steps that the host spent in the step's backward
(``train.backward``), each gap split among the spans the host was in while
it lasted (``spans.py``). Base: every gap between device records in the
traced stretch. In training that idle is mostly the profiler's own: its
host cost a launch (5,206 a step) leaves the device idle for a quarter to
two fifths of the traced steps where the untraced window is 3-4% idle
(``idle_share.train``), and it varies from one traced stretch to the next.
So the share says in which phase the launches fell behind the device under
the profiler, and compares one commit with another; it cannot say where
the untraced window's few milliseconds of idle a step lie. Unread where the
program opens no spans or the profiler lost records of its kernels."""

from port_bench.spans import idle_share

UNIT = "%"


def read(ctx):
    return idle_share(ctx, "train", ("train.backward",))
