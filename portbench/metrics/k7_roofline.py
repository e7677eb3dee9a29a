"""k7_roofline: K7 (manisdp_tpu_torch.kernels.symdual_apply,
csrc/symdual_apply.cu), the SOS-dual class sums of an (n~, n~) matrix,
as a share (%) of its least time at 3.35 TB/s.

Timed after the window by CUDA events (portbench/timing.py) at the
window's q in float32, the dtype the tcg32 inner loop launches, on a
seeded symmetric matrix.  Bytes: the (n~, n~) input read once, n~ =
2 + q + q^2, and the flat (1 + q + q^2 + q^3 + q^4,) output written
once."""

from portbench import timing


def bytes_at(q: int, es: int = 4) -> int:
    n = 2 + q + q * q
    return (n * n + 1 + q + q ** 2 + q ** 3 + q ** 4) * es


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    try:
        import torch
        from manisdp_tpu_torch.kernels import symdual_apply
    except ImportError:
        return None
    q = int(ctx.last().instances[0][2])
    n = 2 + q + q * q
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(int(ctx.seed) % 2 ** 63)
    M = torch.randn((n, n), generator=gen, dtype=torch.float32,
                    device=ctx.device)
    M = (M + M.T).contiguous()
    try:
        return timing.roofline_pct(lambda: symdual_apply(M, q),
                                   bytes_at(q), float(n * n), "float32")
    except TypeError:
        return None
