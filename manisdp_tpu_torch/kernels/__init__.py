"""Hand-written Hopper kernels of the port, their plain twins and launch
counters.

K1 ``symcoo_spmm`` (csrc/symcoo_spmm.cu): A·M for a symmetric COO matrix
   sorted by column, with the epilogues ``plain``, ``shift``, ``cost`` and
   ``hess`` of the MaxCut problem and the certificate, and ``al_hess``, the
   primal augmented-Lagrangian Hessian.
K2 ``oblique_cols`` (csrc/oblique_cols.cu): the oblique manifold's column
   ops ``proj``, ``retr`` and ``renormalize``.
K3 ``pattern_dots`` (csrc/pattern_dots.cu): the pair dots
   <Y[:, i_e], U[:, j_e]> over a column-sorted pattern (an SDDMM).
K4 ``csr_gather`` (csrc/csr_gather.cu): y_r = base_r + alpha ·
   sum_e val_e · x[col_e] over CSR segments: the constraint operator
   A(·) and its adjoint on the pattern.

A wrapper given CPU tensors runs the plain PyTorch twin beside it; given
CUDA tensors it launches the kernel (building it on first use) or
raises.  It never falls back.  ``LAUNCHES`` counts kernel launches only.
"""

from __future__ import annotations

import torch

from .build import build

LAUNCHES = {"symcoo_spmm": 0, "oblique_cols": 0, "pattern_dots": 0,
            "csr_gather": 0}

# "al_hess" is kernel mode 4, or 5 when eG selects the diag epilogue
SPMM_MODES = {"plain": 0, "shift": 1, "cost": 2, "hess": 3, "al_hess": 4}
# K1's launches by mode (their sum is LAUNCHES["symcoo_spmm"])
SPMM_LAUNCHES = {mode: 0 for mode in SPMM_MODES}
OBLIQUE_MODES = {"proj": 0, "retr": 1, "renormalize": 2}
_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


def reset_launches():
    for counts in (LAUNCHES, SPMM_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _on_cuda(*tensors) -> bool:
    """True if every given tensor is on a CUDA device, False if all are on
    the CPU; raises on a mix or on any other device."""
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cpu"}:
        return False
    if devs == {"cuda"}:
        return True
    raise ValueError(f"tensors on devices {sorted(devs)}; expected all on "
                     "the CPU or all on CUDA")


def _check_dtype(dtype, *tensors):
    if dtype not in _SUFFIX:
        raise TypeError(f"kernel takes float64 or float32, got {dtype}")
    for t in tensors:
        if t is not None and t.dtype != dtype:
            raise TypeError(f"dtype mismatch: {t.dtype} vs {dtype}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


# -------------------------------------------------------------------- K1 --

def symcoo_spmm_plain(A, C, mode="plain", vals=None, z=None, B=None,
                      eG=None, vals2=None, coefs=(1.0, 1.0)):
    """Plain twin of K1: the JAX package's gather / segment-sum formulas
    (ops/sparse.py scatter_cols; solvers/maxcut.py cost and hess;
    solvers/primal_al.py hess)."""
    from ..ops.sparse import scatter_cols
    v = C.v if vals is None else vals
    AM = scatter_cols(v, C.i, C.j, A, C.n)
    if mode == "al_hess":
        H = coefs[0] * AM + coefs[1] * scatter_cols(vals2, C.i, C.j, B, C.n)
        if eG is None:
            return H
        return H - B * torch.sum(B * H, dim=0, keepdim=True) \
            - A * eG[None, :]
    if mode == "plain":
        return AM
    if mode == "shift":
        return AM - z[None, :] * A
    if mode == "cost":
        return AM, torch.sum(AM * A, dim=0)
    if mode == "hess":
        return AM - B * torch.sum(B * AM, dim=0, keepdim=True) \
            - A * eG[None, :]
    raise ValueError(f"unknown symcoo_spmm mode {mode!r}")


def symcoo_spmm(A, C, mode="plain", vals=None, z=None, B=None, eG=None,
                vals2=None, coefs=(1.0, 1.0)):
    """K1.  ``A`` (p, n) with any strides; ``C`` a SymCOO (fields i, j, v,
    colptr, n).  Returns the (p, n) product with the ``mode`` epilogue;
    ``cost`` returns (A·C, colsum(A·C ∘ A)).

    ``shift`` needs ``z`` (n,); ``hess`` needs ``B`` (p, n) and ``eG``
    (n,).  ``vals`` replaces C's values (same pattern).  ``al_hess``
    returns H = coefs[0]·A·M + coefs[1]·B·M2, M2 with C's pattern and the
    values ``vals2``; given ``eG`` it returns the unit-diagonal epilogue
    H − B ∘ colsum(B ∘ H) − A ∘ eG."""
    if mode not in SPMM_MODES:
        raise ValueError(f"unknown symcoo_spmm mode {mode!r}")
    v = C.v if vals is None else vals
    need = {"shift": (z,), "hess": (B, eG),
            "al_hess": (B, vals2)}.get(mode, ())
    if any(t is None for t in need):
        raise ValueError(f"mode {mode!r} is missing an operand")
    if not _on_cuda(A, v, C.i, C.colptr, z, B, eG, vals2):
        return symcoo_spmm_plain(A, C, mode, vals, z, B, eG, vals2, coefs)

    if A.dim() != 2:
        raise ValueError(f"A must be (p, n), got {tuple(A.shape)}")
    p, n = A.shape
    if n != C.n or v.shape != C.i.shape or C.colptr.shape != (n + 1,):
        raise ValueError(f"A is {tuple(A.shape)}, C is n={C.n}, "
                         f"vals {tuple(v.shape)} vs nnz {C.i.shape[0]}")
    _check_dtype(A.dtype, A, v, z, B, eG, vals2)
    if C.colptr.dtype != torch.int32 or C.i.dtype != torch.int32:
        raise TypeError("C.colptr and C.i must be int32")
    if not (C.colptr.is_contiguous() and C.i.is_contiguous()
            and v.is_contiguous()):
        raise ValueError("C's index and value arrays must be contiguous")
    if vals2 is not None and (vals2.shape != v.shape or
                              not vals2.is_contiguous()):
        raise ValueError(f"vals2 must be contiguous of shape "
                         f"{tuple(v.shape)}")
    for name, t, shape in (("z", z, (n,)), ("eG", eG, (n,)),
                           ("B", B, (p, n))):
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if z is not None and not z.is_contiguous():
        raise ValueError("z must be contiguous")
    if eG is not None and not eG.is_contiguous():
        raise ValueError("eG must be contiguous")
    out = torch.empty((p, n), dtype=A.dtype, device=A.device)
    w = torch.empty((n,), dtype=A.dtype, device=A.device) \
        if mode == "cost" else None
    sbr, sbc = B.stride() if B is not None else (0, 0)
    fn = getattr(build(), f"symcoo_spmm_{_SUFFIX[A.dtype]}")
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    code = SPMM_MODES[mode] + (mode == "al_hess" and eG is not None)
    err = fn(A.data_ptr(), A.stride(0), A.stride(1), C.colptr.data_ptr(),
             C.i.data_ptr(), v.data_ptr(), p, n, code, ptr(z), ptr(B), sbr,
             sbc, ptr(eG), ptr(vals2), float(coefs[0]), float(coefs[1]),
             out.data_ptr(), ptr(w), _stream(A))
    if err != 0:
        raise RuntimeError(f"symcoo_spmm launch failed: CUDA error {err}")
    LAUNCHES["symcoo_spmm"] += 1
    SPMM_LAUNCHES[mode] += 1
    return (out, w) if mode == "cost" else out


# -------------------------------------------------------------------- K2 --

def oblique_cols_plain(x, u=None, mode="proj"):
    """Plain twin of K2: manifolds/oblique.py of the JAX package."""
    if mode == "proj":
        return u - x * torch.sum(x * u, dim=0, keepdim=True)
    if mode == "retr":
        xtd = x + u
        return xtd / torch.sqrt(torch.sum(xtd * xtd, dim=0, keepdim=True))
    if mode == "renormalize":
        return x / torch.sqrt(torch.sum(x * x, dim=0, keepdim=True))
    raise ValueError(f"unknown oblique_cols mode {mode!r}")


def oblique_cols(x, u=None, mode="proj"):
    """K2 on contiguous (p, n) ``x`` (and ``u`` for proj / retr)."""
    if mode not in OBLIQUE_MODES:
        raise ValueError(f"unknown oblique_cols mode {mode!r}")
    if (u is None) != (mode == "renormalize"):
        raise ValueError(f"mode {mode!r} takes "
                         f"{'no' if mode == 'renormalize' else 'a'} u")
    if not _on_cuda(x, u):
        return oblique_cols_plain(x, u, mode)
    _check_dtype(x.dtype, x, u)
    if x.dim() != 2 or (u is not None and u.shape != x.shape):
        raise ValueError("x and u must be the same (p, n) shape")
    if not x.is_contiguous() or (u is not None and not u.is_contiguous()):
        raise ValueError("oblique_cols takes contiguous row-major tensors")
    p, n = x.shape
    out = torch.empty_like(x)
    fn = getattr(build(), f"oblique_cols_{_SUFFIX[x.dtype]}")
    err = fn(x.data_ptr(), u.data_ptr() if u is not None else None, p, n,
             OBLIQUE_MODES[mode], out.data_ptr(), _stream(x))
    if err != 0:
        raise RuntimeError(f"oblique_cols launch failed: CUDA error {err}")
    LAUNCHES["oblique_cols"] += 1
    return out


# -------------------------------------------------------------------- K3 --

def pattern_dots_plain(Y, U, P):
    """Plain twin of K3: the JAX package's pair_dots over the pattern
    (ops/sparse.py pair_dots / ConstraintOp.pattern_pair_dots)."""
    from ..ops.sparse import pair_dots
    return pair_dots(Y, U, P.i, P.j)


def pattern_dots(Y, U, P):
    """K3.  ``Y``, ``U`` (p, n) with any strides; ``P`` a column-sorted
    SymCOO pattern (fields i, j, colptr, n).  Returns e (nnz,) with
    e_k = <Y[:, i_k], U[:, j_k]>."""
    if not _on_cuda(Y, U, P.i, P.colptr):
        return pattern_dots_plain(Y, U, P)
    _check_dtype(Y.dtype, Y, U)
    if Y.dim() != 2 or U.shape != Y.shape or Y.shape[1] != P.n:
        raise ValueError(f"Y {tuple(Y.shape)} and U {tuple(U.shape)} must "
                         f"be the same (p, {P.n})")
    if P.colptr.dtype != torch.int32 or P.i.dtype != torch.int32:
        raise TypeError("P.colptr and P.i must be int32")
    if not (P.colptr.is_contiguous() and P.i.is_contiguous()) or \
            P.colptr.shape != (P.n + 1,):
        raise ValueError("P's colptr (n+1,) and rows must be contiguous")
    p, n = Y.shape
    out = torch.empty((P.i.shape[0],), dtype=Y.dtype, device=Y.device)
    fn = getattr(build(), f"pattern_dots_{_SUFFIX[Y.dtype]}")
    err = fn(Y.data_ptr(), Y.stride(0), Y.stride(1), U.data_ptr(),
             U.stride(0), U.stride(1), P.colptr.data_ptr(), P.i.data_ptr(),
             p, n, out.data_ptr(), _stream(Y))
    if err != 0:
        raise RuntimeError(f"pattern_dots launch failed: CUDA error {err}")
    LAUNCHES["pattern_dots"] += 1
    return out


# -------------------------------------------------------------------- K4 --

def csr_gather_plain(x, ptr, col, val, base=None, alpha=1.0):
    """Plain twin of K4: the JAX package's scalar gather + segment-sum
    (ops/sparse.py apply_from_e, adjoint_on_pattern, es_vals, s_vals)."""
    nrows = ptr.shape[0] - 1
    seg = torch.repeat_interleave(
        torch.arange(nrows, device=ptr.device),
        (ptr[1:] - ptr[:-1]).long(), output_size=col.shape[0])
    acc = torch.zeros((nrows,), dtype=x.dtype, device=x.device)
    acc.index_add_(0, seg, val * x[col.long()])
    return alpha * acc if base is None else base + alpha * acc


def csr_gather(x, ptr, col, val, base=None, alpha=1.0):
    """K4.  ``ptr`` (R+1,) int32 delimits R segments of the entries
    (``col`` int32, ``val``); returns y (R,) with
    y_r = base_r + alpha · sum_e val_e · x[col_e] (no ``base``: 0).
    ``alpha`` is a Python number."""
    if not _on_cuda(x, ptr, col, val, base):
        return csr_gather_plain(x, ptr, col, val, base, alpha)
    _check_dtype(x.dtype, x, val, base)
    nrows = ptr.shape[0] - 1
    if ptr.dtype != torch.int32 or col.dtype != torch.int32:
        raise TypeError("ptr and col must be int32")
    if col.shape != val.shape or x.dim() != 1 or \
            (base is not None and base.shape != (nrows,)):
        raise ValueError(f"col {tuple(col.shape)}, val {tuple(val.shape)}, "
                         f"x {tuple(x.shape)}, {nrows} rows")
    if not all(t.is_contiguous() for t in (x, ptr, col, val, base)
               if t is not None):
        raise ValueError("csr_gather takes contiguous tensors")
    out = torch.empty((nrows,), dtype=x.dtype, device=x.device)
    fn = getattr(build(), f"csr_gather_{_SUFFIX[x.dtype]}")
    err = fn(x.data_ptr(), ptr.data_ptr(), col.data_ptr(), val.data_ptr(),
             base.data_ptr() if base is not None else None, float(alpha),
             nrows, out.data_ptr(), _stream(x))
    if err != 0:
        raise RuntimeError(f"csr_gather launch failed: CUDA error {err}")
    LAUNCHES["csr_gather"] += 1
    return out


__all__ = ["LAUNCHES", "SPMM_LAUNCHES", "reset_launches", "symcoo_spmm",
           "symcoo_spmm_plain", "oblique_cols", "oblique_cols_plain",
           "pattern_dots", "pattern_dots_plain", "csr_gather",
           "csr_gather_plain", "build"]
