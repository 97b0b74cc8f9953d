"""Serve layer (``eval/inference.py``): the share of the slices computed in
the window that were bucket padding, from the benchmark's forward pre-hook
on the model (every chunk's slices) and the real slices returned."""

UNIT = "%"


def read(ctx):
    if ctx.mode != "serve_volumes" or not ctx.window["chunks"]:
        return None
    computed = sum(ctx.window["chunks"])
    return 100.0 * (computed - ctx.window["slices"]) / computed
