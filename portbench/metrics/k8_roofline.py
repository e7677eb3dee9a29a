"""k8_roofline: K8 (manisdp_tpu_torch.kernels.symdual_adjoint,
csrc/symdual_adjoint.cu) in its scaled mode (the f32 Hessian's
adjoint_scaled), the (n~, n~) matrix of class values, as a share (%) of
its least time at 3.35 TB/s.

Timed after the window by CUDA events (portbench/timing.py) at the
window's q in float32, the dtype the tcg32 inner loop launches, on
seeded per-degree multipliers.  Bytes: the flat multipliers
(1 + q + q^2 + q^3 + q^4) and the (5,) scale read once, the (n~, n~)
output written once."""

from portbench import timing


def bytes_at(q: int, es: int = 4) -> int:
    n = 2 + q + q * q
    return (1 + q + q ** 2 + q ** 3 + q ** 4 + 5 + n * n) * es


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    try:
        import torch
        from manisdp_tpu_torch.kernels import symdual_adjoint
    except ImportError:
        return None
    q = int(ctx.last().instances[0][2])
    n = 2 + q + q * q
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(int(ctx.seed) % 2 ** 63)
    sizes = [1, q, q * q, q ** 3, q ** 4]
    flat = torch.randn((sum(sizes),), generator=gen, dtype=torch.float32,
                       device=ctx.device)
    parts = torch.split(flat, sizes)
    y = (parts[0].reshape(()), parts[1], parts[2].view(q, q),
         parts[3].view(q, q, q), parts[4].view(q, q, q, q))
    scale = torch.rand((5,), generator=gen, dtype=torch.float32,
                       device=ctx.device) + 0.5
    try:
        return timing.roofline_pct(
            lambda: symdual_adjoint(y, q, scale=scale), bytes_at(q),
            float(n * n), "float32")
    except TypeError:
        return None
