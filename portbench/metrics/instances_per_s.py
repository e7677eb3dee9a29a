"""instances_per_s: certified instances a second over the window.

The instances the window's calls returned with status 0 and eta <= the
configuration's tol, divided by the summed wall time of the calls (each
timed from entry to torch.cuda.synchronize() after it returns).  A batch
of B counts B; an instance not certified adds nothing."""


def read(ctx):
    return len(ctx.certified()) / ctx.window_s
