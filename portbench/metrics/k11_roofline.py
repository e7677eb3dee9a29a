"""k11_roofline: K11 (manisdp_tpu_torch.kernels.tcg_step,
csrc/tcg_step.cu), one batched tCG vector step with the oblique tangent
projection, as a share (%) of its least time at 3.35 TB/s.

Timed after the window by CUDA events (portbench/timing.py) at the last
window call's (B, p_pad, n_pad) in float64, the batch's dtype, on seeded
vectors of a CG start (every instance active, so every step does the
whole work).  Bytes: each input read once (d, Hd, eta, Heta, r, Y; the
(B, 8) scalars and (B, 2) int32 state) and each output written once
(eta, Heta, r, d in place; the next scalars and state)."""

import math

from portbench import shapes, timing


def bytes_at(B: int, p: int, n: int, es: int = 8) -> int:
    L = B * p * n
    return (6 + 4) * L * es + 2 * (8 * B * es + 2 * B * 4)


def flops_at(B: int, p: int, n: int) -> float:
    return 18.0 * B * p * n


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    try:
        import torch
        from manisdp_tpu_torch.kernels import oblique_cols_plain, tcg_step
    except ImportError:
        return None
    B, p, n = shapes.batch_shape(ctx.last())
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(int(ctx.seed) % 2 ** 63)
    rnd = lambda: torch.randn((B, p, n), generator=gen,  # noqa: E731
                              dtype=torch.float64, device=ctx.device)
    d, eta, Heta = rnd(), rnd(), rnd()
    r = d.clone()
    Hd = d * (1.0 + rnd().abs())
    Y = oblique_cols_plain(rnd(), None, "renormalize")
    r_r = torch.sum(r * r, dim=(1, 2))
    z = torch.zeros_like(r_r)
    sc = torch.stack([z, z, r_r, r_r, z, z + math.pi ** 2 * n / 64, z,
                      z + 1], 1).contiguous()
    st = torch.zeros((B, 2), dtype=torch.int32, device=ctx.device)
    try:
        return timing.roofline_pct(
            lambda: tcg_step(d, Hd, eta, Heta, r, sc, st, 1, Y),
            bytes_at(B, p, n), flops_at(B, p, n), "float64")
    except TypeError:
        return None
