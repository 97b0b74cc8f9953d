"""Train loop (``train/trainer.py``): device milliseconds a step of the
kernels launched under torch's ``Optimizer.step#SGD.step`` range, over the
traced steps."""

UNIT = "ms"


def read(ctx):
    if ctx.mode != "train" or ctx.trace.optimizer_s is None:
        return None
    return 1e3 * ctx.trace.optimizer_s / len(ctx.trace.units)
