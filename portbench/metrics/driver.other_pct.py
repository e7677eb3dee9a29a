"""driver.other_pct: the share (%) of the window's wall time outside the
drivers' ``rtr`` and ``cert`` timers: input densification, operator
build, host-device copies, the rank step and the dual's stats (the
drivers solvers/batch.py, solvers/dual_unitdiag.py, solvers/dual_al.py).
Each call's timers counted once (one per bucket in a batch)."""


def read(ctx):
    timers = ctx.timers()
    if not timers:
        return None
    inside = sum(t.get("rtr", 0.0) + t.get("cert", 0.0) for t in timers)
    return 100.0 * (ctx.window_s - inside) / ctx.window_s
