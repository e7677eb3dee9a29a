"""setup_s: seconds from the run's start (run.py's first line) to the
window's: imports and the CUDA context, the kernels built or loaded from
the checkout's cache, the warm-up instances and one warm call of the
cell's own shapes."""


def read(ctx):
    return ctx.setup_s
