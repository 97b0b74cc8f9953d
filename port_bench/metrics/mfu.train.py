"""Model (``models/cswin_unet.py``): the training steps' model FLOPs
(``work.train_step_flops``: forward and backward, recomputation not counted)
over the measured window's time, against the card's bf16 peak."""

from port_bench import work

UNIT = "%"


def read(ctx):
    if ctx.mode != "train":
        return None
    w = ctx.window
    flops = w["steps"] * work.train_step_flops(ctx.cfg, w["batch"])
    return 100.0 * flops / w["seconds"] / work.TC_FLOPS
