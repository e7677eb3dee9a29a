"""tcg.hess_per_instance: Hessian products (tCG inner iterations,
SDPResult.hess_calls) per certified instance over the window: the work
the RTR + tCG layer asked for, a count that repeats on a fixed input."""


def read(ctx):
    done = ctx.certified()
    if not done:
        return None
    return sum(r.hess_calls for r in done) / len(done)
