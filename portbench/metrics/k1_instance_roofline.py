"""k1_instance_roofline: K1 (manisdp_tpu_torch.kernels.symcoo_spmm,
csrc/symcoo_spmm.cu) in instance mode, the batched MaxCut Hessian
product ``hess``, as a share (%) of its least time at 3.35 TB/s.

Timed after the window by CUDA events (portbench/timing.py) on the last
window call's costs (a BatchedSymCOO, the program's own operand type) at
its (B, p_pad, n_pad) in float64, with seeded factors.  Bytes: each
input read once (A and B (B, p, n), eG (B, n), the pattern's int32 rows
and values, the (B, n + 1) int32 column pointers and (B,) int64 entry
offsets) and the (B, p, n) output written once."""

from portbench import shapes, timing


def bytes_at(B: int, p: int, n: int, nnz: int, es: int = 8) -> int:
    return (3 * B * p * n + B * n + nnz) * es + nnz * 4 + \
        B * (n + 1) * 4 + B * 8


def flops_at(B: int, p: int, n: int, nnz: int) -> float:
    return 2.0 * p * nnz + 4.0 * B * p * n


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    try:
        import torch
        from manisdp_tpu_torch.kernels import symcoo_spmm
        from manisdp_tpu_torch.ops.sparse import BatchedSymCOO
    except ImportError:
        return None
    last = ctx.last()
    B, p, n = shapes.batch_shape(last)
    C = BatchedSymCOO.from_scipy(last.instances, n, ctx.device)
    nnz = int(C.i.numel())
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(int(ctx.seed) % 2 ** 63)
    rnd = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                 dtype=torch.float64, device=ctx.device)
    A, Bm, eG = rnd(B, p, n), rnd(B, p, n), rnd(B, n)
    try:
        return timing.roofline_pct(
            lambda: symcoo_spmm(A, C, "hess", B=Bm, eG=eG),
            bytes_at(B, p, n, nnz), flops_at(B, p, n, nnz), "float64")
    except TypeError:
        return None
