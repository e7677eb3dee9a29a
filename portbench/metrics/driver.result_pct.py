"""driver.result_pct: the share (%) of the window's wall time in the
drivers' ``result`` span: from the outer loop's end to the returned
results (the copies to the host, the host X = Y'Y, the dual's y-step)."""

from portbench import spans


def read(ctx):
    return spans.share(ctx, lambda t: t.get("result", 0.0))
