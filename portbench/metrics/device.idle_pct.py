"""device.idle_pct: 100 x (1 - device busy s / the call's own wall s)
for one whole call after the window.  Busy time is the union of the
device events of that call traced by torch.profiler with device activity
only (portbench/profile.py); the wall is the same call on the same
instances run without the profiler just before (the profiler's own
overhead stretches the traced wall: the run's ``trace_info`` gives
both)."""


def read(ctx):
    prof = ctx.profile
    if not prof or not prof.get("device_events"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["plain_wall_s"])
