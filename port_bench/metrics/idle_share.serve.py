"""Device (H100): the share of the measured window in which the device was
idle: one minus the device's busy time a real slice (the union of the device
records over the traced stretch) over the window's time a real slice. The
profiler slows the host, so the traced stretch's own idle share reads the
profiler too; the busy time it records does not. Unread where the profiler
lost records of the program's kernels."""

UNIT = "%"


def read(ctx):
    busy = ctx.trace.busy_s
    if ctx.mode != "serve_volumes" or busy is None or not ctx.trace.done:
        return None
    per_unit = ctx.window["seconds"] / ctx.window["done"]
    return 100.0 * (1.0 - busy / ctx.trace.done / per_unit)
