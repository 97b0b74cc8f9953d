"""Serve layer (``serve.py``, ``eval/inference.py``): the share of the
device's idle time in the traced stretch that the host spent preparing a
volume (``serve.prepare``: the zoom in or the float32 cast), finishing one
(``serve.finish``: the zoom out and the int32 cast), or in ``serve.segment``
or ``infer.volume`` outside every span they hold, each gap split among the
spans the host was in while it lasted (``spans.py``). Base: every gap
between device records in the traced stretch, which the profiler lengthens,
so the share compares one commit with another and is not seconds of the
untraced window. Unread where the program opens no spans or the profiler
lost records of its kernels."""

from port_bench.spans import idle_share

UNIT = "%"


def read(ctx):
    return idle_share(ctx, "serve_volumes",
                      ("serve.prepare", "serve.finish", "serve.segment", "infer.volume"))
