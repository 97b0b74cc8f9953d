"""Model (``models/cswin_unet.py``): the forward's model FLOPs of every real
slice returned in the measured window, over its time, against the card's
peak for the configuration's ``compute_dtype`` (``work.PEAK_FLOPS``): 989
TFLOP/s of the bf16 tensor cores at ``bfloat16``, 67 TFLOP/s of float32
FFMA at ``float32``."""

from port_bench import work

UNIT = "%"


def read(ctx):
    if ctx.mode != "serve_volumes":
        return None
    w, peak = ctx.window, work.PEAK_FLOPS[ctx.cfg["compute_dtype"]]
    return 100.0 * w["slices"] * work.model_flops(ctx.cfg) / w["seconds"] / peak
