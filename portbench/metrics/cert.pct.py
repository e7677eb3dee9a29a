"""cert.pct: the share (%) of the window's wall time inside the drivers'
``timers["cert"]`` (the dual certificate: the batch's torch.linalg.eigh,
ops/eigs_rr.py, ops/dense_cert.py), each call's timers counted once."""


def read(ctx):
    timers = ctx.timers()
    if not timers:
        return None
    return 100.0 * sum(t.get("cert", 0.0) for t in timers) / ctx.window_s
