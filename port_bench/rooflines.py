"""A kernel family's share of its roofline in a traced stretch: the sum of
its launches' bounds (``work``) over its device time by kernel name
(``trace.FAMILIES``, the instance of the configuration's ``compute_dtype``)."""

from __future__ import annotations

from . import work


def _train(cfg: dict, batch: int, paired: tuple, fused_ups: int) -> list:
    return [] if paired else work.train_calls(cfg, batch, cfg["drop_path_rate"], fused_ups)


MAKERS = {"train": _train, "serve_volumes": work.serve_calls}


def share(ctx, mode: str, family: str) -> float | None:
    """Percent of the roofline, or None: another kind of cell, a trace that
    lost records, a family that did not run, or launches that match no
    route."""
    if ctx.mode != mode or not ctx.trace.tallied:
        return None
    device_s = ctx.trace.family_s(family, ctx.cfg["compute_dtype"])
    if device_s <= 0:
        return None
    calls = work.route_from_counts(ctx.cfg, ctx.trace.units, ctx.trace.counts, MAKERS[mode])
    if calls is None:
        return None
    return 100.0 * work.family_bound_s(calls, family) / device_s
