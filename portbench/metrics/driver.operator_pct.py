"""driver.operator_pct: the share (%) of the window's wall time in the
drivers' ``operator`` span: input assembly and operator build, copies to
the card included (the batch's nnz scan, starts, dense C and its copy,
BatchedSymCOO; the dual's SymDualOp build, scaling, f32 copy, certificate
set-up and start)."""

from portbench import spans


def read(ctx):
    return spans.share(ctx, lambda t: t.get("operator", 0.0))
