"""rtr.pct: the share (%) of the window's wall time inside the drivers'
``timers["rtr"]`` (the RTR + tCG inner solves, core/trustregions.py;
with the batch's line search), each call's timers counted once."""


def read(ctx):
    timers = ctx.timers()
    if not timers:
        return None
    return 100.0 * sum(t.get("rtr", 0.0) for t in timers) / ctx.window_s
