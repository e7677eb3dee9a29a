"""peak_mem_gb: torch.cuda.max_memory_allocated() over the window (GB),
after reset_peak_memory_stats() at its start: the card memory an
instance of this size needs."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes else None
