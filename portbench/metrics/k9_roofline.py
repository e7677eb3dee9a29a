"""k9_roofline: K9 (manisdp_tpu_torch.kernels.symmom_apply,
csrc/symmom_apply.cu), the moment rows A(M) of an (n~, n~) matrix in the
flat per-family layout, as a share (%) of its least time at 3.35 TB/s.

Timed after the window by CUDA events (portbench/timing.py) at the
window's q in float32, the dtype the tcg32 inner loop launches, on a
seeded symmetric matrix.  Bytes and operations as chip_smoke.py's
``bound`` counts them for row B16 (chip_smoke.py:1937): the (n~, n~)
input read once, n~ = 2 + q + q^2, the flat
(1 + q + 3 q^2 + 2 q^3 + q^4,) output written once, 12 q^4 operations."""

from portbench import timing


def flat_length(q: int) -> int:
    return 1 + q + 3 * q ** 2 + 2 * q ** 3 + q ** 4


def bytes_at(q: int, es: int = 4) -> int:
    n = 2 + q + q * q
    return (n * n + flat_length(q)) * es


def flops_at(q: int) -> float:
    return 12.0 * float(q) ** 4


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    try:
        import torch
        from manisdp_tpu_torch.kernels import symmom_apply
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
        return timing.roofline_pct(lambda: symmom_apply(M, q), bytes_at(q),
                                   flops_at(q), "float32")
    except TypeError:
        return None
