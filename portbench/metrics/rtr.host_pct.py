"""rtr.host_pct: the share (%) of the window's wall time inside the
drivers' ``rtr`` span (core/trustregions.py and the line search) less
its nested ``rtr.wait``: the RTR's host time not spent blocked on reads
of device values (the tCG stop flags every eighth step, the gradient
norm, the accept test)."""

from portbench import spans


def read(ctx):
    return spans.share(ctx, lambda t: t.get("rtr", 0.0) -
                       t.get("rtr.wait", 0.0))
