"""Shapes of the batched MaxCut driver's last window call, for the kernel
roofline metrics: (B, p_pad, n_pad), as solve_maxcut_batch pads them."""

P_BUCKET = 8      # SolverOptions.p_bucket, the rank bucket of the batch
N_BUCKET = 256    # solve_maxcut_batch's n_bucket


def up(x: int, bucket: int) -> int:
    return -(-x // bucket) * bucket


def batch_shape(record):
    """(B, p_pad, n_pad) of the bucket of one window call (``record``: its
    instances and slimmed results): p_pad from the largest rank any
    instance reached (the batch's p_pad never shrinks)."""
    B = len(record.instances)
    n = max(C.shape[0] for C in record.instances)
    p = max(max(r.fac_size) for r in record.results if r.fac_size)
    return B, up(p, P_BUCKET), up(n, N_BUCKET)
