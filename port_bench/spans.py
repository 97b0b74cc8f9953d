"""The device's idle gaps, each split among the program spans the host was
in while the gap lasted.

The program marks its layers with ranges on ``torch.profiler``
(``cswin_unet_tpu_torch.utils.profiling.span``), named ``<layer>.<part>``
with the layer ``serve``, ``infer``, ``train`` or ``model``; they sit among
the host's CPU ranges of a ``trace.Trace``. The gaps are those between
consecutive intervals of ``Trace.merged()``, the gaps ``Trace.breakdown``
ranks. Each instant of a gap goes to the innermost program span (the
shortest, as ``Trace.host_range_at`` finds it) open on the host at that
instant, or to ``OUTSIDE`` where none is: a gap that opens in the drain and
closes once the next chunk is padded and copied in is split among the drain,
the pad and the copy by the host's time in each. A program without spans
(one older than them) gives no reading, never a zero.
"""

from __future__ import annotations

import re
from bisect import bisect_right
from collections import defaultdict

from port_bench.trace import Trace

PROGRAM_SPAN = re.compile(r"(?:serve|infer|train|model)\.[a-z0-9_]+")
OUTSIDE = "outside"


def program_spans(trace) -> list[tuple[str, float, float]]:
    """The program's spans among the trace's CPU ranges."""
    return [r for r in trace.cpu if PROGRAM_SPAN.fullmatch(r[0])]


def innermost(spans) -> list[tuple[float, float, str]]:
    """The host's timeline as ``(start, end, name)`` pieces, in order,
    between consecutive span boundaries: each piece named by the innermost
    span open over it, ``OUTSIDE`` where none is."""
    host = Trace([], spans)
    cuts = sorted({t for _, s, e in spans for t in (s, e)})
    pieces = []
    for a, b in zip(cuts, cuts[1:]):
        name = host.host_range_at((a + b) / 2)
        pieces.append((a, b, OUTSIDE if name == "none" else name))
    return pieces


def idle_by_span(trace) -> dict[str, float] | None:
    """Idle microseconds of the traced stretch by the span the host was in
    (``OUTSIDE`` for none), or None where the profiler lost records of the
    program's kernels, no gap was recorded or the program opened no span."""
    if not trace.tallied:
        return None
    merged = trace.merged()
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    spans = program_spans(trace)
    if not gaps or not spans:
        return None
    pieces = innermost(spans)
    starts = [a for a, _, _ in pieces]
    out: dict[str, float] = defaultdict(float)
    for a, b in gaps:
        left = b - a
        i = max(bisect_right(starts, a) - 1, 0)
        while i < len(pieces) and pieces[i][0] < b:
            s, e, name = pieces[i]
            part = min(b, e) - max(a, s)
            if part > 0:
                out[name] += part
                left -= part
            i += 1
        if left > 0:
            out[OUTSIDE] += left
    return dict(out)


def idle_share(ctx, mode: str, names) -> float | None:
    """Percent of the traced stretch's idle time that the host spent in
    ``names``, in a cell of ``mode``; None where ``idle_by_span`` reads
    nothing."""
    if ctx.mode != mode:
        return None
    idle = idle_by_span(ctx.trace)
    if idle is None:
        return None
    return 100.0 * sum(idle.get(n, 0.0) for n in names) / sum(idle.values())
