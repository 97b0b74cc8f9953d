"""Model (``models/cswin_unet.py``): the forward's model FLOPs of every real
slice returned in the measured window, over its time, against the card's
bf16 peak."""

from port_bench import work

UNIT = "%"


def read(ctx):
    if ctx.mode != "serve_volumes":
        return None
    w = ctx.window
    return 100.0 * w["slices"] * work.model_flops(ctx.cfg) / w["seconds"] / work.TC_FLOPS
