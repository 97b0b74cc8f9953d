"""Model (``models/cswin_unet.py``): the training steps' model FLOPs
(``work.train_step_flops``: forward and backward, recomputation not counted)
over the measured window's time, against the card's peak for the
configuration's ``compute_dtype`` (``work.PEAK_FLOPS``): 989 TFLOP/s of the
bf16 tensor cores at ``bfloat16``, 67 TFLOP/s of float32 FFMA at
``float32``."""

from port_bench import work

UNIT = "%"


def read(ctx):
    if ctx.mode != "train":
        return None
    w, peak = ctx.window, work.PEAK_FLOPS[ctx.cfg["compute_dtype"]]
    flops = w["steps"] * work.train_step_flops(ctx.cfg, w["batch"])
    return 100.0 * flops / w["seconds"] / peak
