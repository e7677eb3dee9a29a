"""driver.rank_pct: the share (%) of the window's wall time in the
drivers' ``rank`` span: the whole host rank step after the certificate
(bookkeeping, truncation, escape rows, the rebuilt factor copied back to
the card; in the dual also the sigma schedule)."""

from portbench import spans


def read(ctx):
    return spans.share(ctx, lambda t: t.get("rank", 0.0))
