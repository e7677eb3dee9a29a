"""k10_roofline: K10 (manisdp_tpu_torch.kernels.symmom_adjoint,
csrc/symmom_adjoint.cu) in its plain mode (the tCG Hessian's adjoint),
the (n~, n~) matrix A'(y) of flat moment multipliers, as a share (%) of
its least time at 3.35 TB/s.

Timed after the window by CUDA events (portbench/timing.py) at the
window's q in float32, the dtype the tcg32 inner loop launches, on
seeded multipliers.  Bytes and operations as chip_smoke.py's ``bound``
counts them for row B16 (chip_smoke.py:1938): the valid slots of the
flat multipliers read once (one a row of bqpmom.m: 1 + q + 2 q (q - 1)
+ q C(q-1, 2) + C(q, 2) + 2 C(q, 3) + 2 C(q, 4); K10 reads no other
slot), the (n~, n~) output written once, 40 q^4 operations."""

from math import comb

from portbench import timing


def valid_slots(q: int) -> int:
    return (1 + q + 2 * q * (q - 1) + q * comb(q - 1, 2) + comb(q, 2)
            + 2 * comb(q, 3) + 2 * comb(q, 4))


def bytes_at(q: int, es: int = 4) -> int:
    n = 2 + q + q * q
    return (valid_slots(q) + n * n) * es


def flops_at(q: int) -> float:
    return 40.0 * float(q) ** 4


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    try:
        import torch
        from manisdp_tpu_torch.kernels import symmom_adjoint
    except ImportError:
        return None
    q = int(ctx.last().instances[0][2])
    m = 1 + q + 3 * q ** 2 + 2 * q ** 3 + q ** 4
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(int(ctx.seed) % 2 ** 63)
    y = torch.randn((m,), generator=gen, dtype=torch.float32,
                    device=ctx.device)
    try:
        return timing.roofline_pct(lambda: symmom_adjoint(y, q),
                                   bytes_at(q), flops_at(q), "float32")
    except TypeError:
        return None
