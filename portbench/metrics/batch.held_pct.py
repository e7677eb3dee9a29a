"""batch.held_pct: the share (%) of the window's wall time that certified
instances wait in their batch, weighted by instance: the batch driver's
``batch.held`` (for each outer iteration, its wall times the share of
the call's instances certified before it).  A batch held by one
instance that does not certify reads near the share of its stall."""

from portbench import spans


def read(ctx):
    timers = spans.recorded(ctx)
    if timers is None or not any("batch.held" in t for t in timers):
        return None
    return spans.share(ctx, lambda t: t.get("batch.held", 0.0))
